"""`repro_torch` — the gLava graph-stream summary in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The package mirrors the JAX reference package ``src/repro/`` module for
module: ``repro_torch/<x>/<y>.py`` ports ``repro/<x>/<y>.py``.  It imports
``torch``, numpy and the standard library only.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
