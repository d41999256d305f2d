"""Models (port of ``src/repro/models``; so far the dense transformer)."""
