"""HDArray on PyTorch and CUDA: a port of the ``repro`` package.

The planner and its metadata layer (``core``) are host numpy, as in the
reference.  The ``torch`` executor keeps every array resident on one
CUDA card and carries the planner's messages as device-to-device
section copies; the Jacobi and GEMM tile kernels (``kernels``) are
CUDA C++ written for Hopper (``csrc``), built with ``nvcc`` at first
use.  The package imports torch and numpy, never jax or ``repro``.
"""
