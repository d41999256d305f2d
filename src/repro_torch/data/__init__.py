"""Host-side data generators (port of ``src/repro/data``; so far the edge
stream and the LM token pipeline)."""
