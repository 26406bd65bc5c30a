"""Blocked GEMM: plain version, CUDA kernel, dispatch."""
from .ops import gemm  # noqa: F401
