"""Stacked ingest: one hashed batch into N stacked sketch planes, counters
and both flow registers, the plane per edge (a port-only kernel: the
reference's XLA scatter ``scatter_stacked`` in ``src/repro/core/sketch.py``)."""
