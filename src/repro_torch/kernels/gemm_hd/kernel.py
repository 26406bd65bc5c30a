"""Launch wrapper of the hand-written GEMM (``repro_torch/csrc/gemm_hd.cu``),
the port of the reference's ``gemm_pallas``.  The library builds on the
first launch."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_TYPES = (torch.float32, torch.bfloat16)


def _entry():
    fn = build.load("gemm_hd").gemm_hd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _pitch(t: torch.Tensor, name: str) -> int:
    """Row pitch of a 2-d tensor whose rows are contiguous."""
    rows, cols = t.shape
    if t.stride(1) != 1 or (rows > 1 and t.stride(0) < cols):
        raise ValueError(f"gemm_cuda needs contiguous rows of {name}, got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")
    return t.stride(0) if rows > 1 else cols


def product_out(a: torch.Tensor, b: torch.Tensor,
                out_dtype: Optional[torch.dtype],
                out: Optional[torch.Tensor]) -> torch.Tensor:
    """Check ``a @ b``'s shapes and its ``out_dtype`` and ``out`` (see
    :func:`~repro_torch.kernels.gemm_hd.ops.gemm`); returns ``out``,
    allocated when None."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    shape = (a.shape[0], b.shape[1])
    if out is None:
        return torch.empty(shape, dtype=out_dtype or a.dtype,
                           device=a.device)
    if tuple(out.shape) != shape or out.device != a.device:
        raise ValueError(f"out {tuple(out.shape)} on {out.device} does not "
                         f"hold the product {shape} on {a.device}")
    if out_dtype is not None and out_dtype != out.dtype:
        raise TypeError(f"out_dtype {out_dtype} but out is {out.dtype}")
    for t in (a, b):
        if out.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr():
            raise ValueError("out must not share memory with a or b")
    return out


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
              out_dtype: Optional[torch.dtype] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * a (M, K) @ b (K, N)`` on the card with float32
    accumulation.  ``a`` and ``b`` are both float32 or both bfloat16
    with contiguous rows (a row band of a larger buffer is fine).  The
    result goes into ``out`` (contiguous rows, any row pitch; default a
    new tensor of ``out_dtype``, itself defaulting to ``a.dtype``),
    which is returned; float32 and bfloat16 outputs are built."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("gemm_cuda needs both operands on one CUDA device")
    out = product_out(a, b, out_dtype, out)
    if a.dtype not in _TYPES or b.dtype != a.dtype or out.dtype not in _TYPES:
        raise TypeError(f"gemm_cuda takes float32 or bfloat16, got "
                        f"{a.dtype} @ {b.dtype} -> {out.dtype}")
    (M, K), N = a.shape, b.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("gemm_cuda dimensions must fit in 32 bits")
    lda, ldb, ldc = _pitch(a, "a"), _pitch(b, "b"), _pitch(out, "out")
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(a.device):
        err = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                       lda, ldb, ldc, float(alpha),
                       int(a.dtype == torch.bfloat16),
                       int(out.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gemm_hd launch failed with CUDA error {err}")
    gemm_cuda.launches += 1
    return out


gemm_cuda.launches = 0
