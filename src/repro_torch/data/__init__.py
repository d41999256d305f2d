"""Host-side data generators (port of ``src/repro/data``: the edge stream,
the citation and molecule graphs with their triplets, the LM token pipeline
and the recsys interaction sequences)."""
