"""Hand-written CUDA kernels of the port, one wrapper module each.

Every wrapper takes the kernel for CUDA tensors and the plain PyTorch
version beside it for CPU tensors; there is no fallback from one to the
other.  ``_lib`` builds and loads the library and counts launches.
"""

from ._lib import KERNELS, launches, reset_launches  # noqa: F401
