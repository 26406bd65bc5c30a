"""Jacobi 5-point stencil: plain version, CUDA kernel, dispatch."""
from .ops import jacobi_step  # noqa: F401
