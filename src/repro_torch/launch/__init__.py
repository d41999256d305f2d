"""Entry points (port of ``src/repro/launch``; so far ``serve``)."""
