"""Order-dependent sketch updates, edge by edge (a port-only kernel: the
reference's ``lax.scan`` in ``src/repro/core/sketch.py``)."""
