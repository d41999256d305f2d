"""Hand-written CUDA kernels of the port, one package each.

``<name>/ops.py`` holds the wrapper and its launch counter, ``<name>/ref.py``
the plain PyTorch version, and ``repro_torch/csrc/<name>.cu`` the CUDA
source.  A wrapper given CPU tensors computes the plain version; given CUDA
tensors it launches the kernel or raises."""
