"""PyTorch/CUDA port of the NGDB-Zoo reproduction.

The JAX package ``repro`` is the reference; this package runs the same
serving path on an NVIDIA H100 with hand-written CUDA kernels, and imports
nothing of JAX or of ``repro``.
"""
