"""topiaxl_torch: the PyTorch/CUDA port of topiaxl for one NVIDIA H100.

Mirrors ``topiaxl/``'s module paths. Plain tensor code is PyTorch; the
JAX package's Pallas kernels on the serving path are hand-written CUDA
kernels for Hopper under ``csrc/``, each beside a plain PyTorch version
with the same numerics contract. Imports no JAX.
"""

__version__ = "0.1.0"
