"""gLava core in PyTorch (port of ``src/repro/core``)."""
