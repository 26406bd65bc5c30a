"""Launch wrapper of the hand-written Jacobi sweep
(``repro_torch/csrc/jacobi_hd.cu``), the port of the reference's
``jacobi_pallas``.  The library builds on the first launch."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

Window = Tuple[Tuple[int, int], Tuple[int, int]]


def _entry():
    fn = build.load("jacobi_hd").jacobi_hd_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _pitch(t: torch.Tensor, name: str) -> int:
    """Row pitch of a 2-d tensor whose rows are contiguous."""
    rows, cols = t.shape
    if t.stride(1) != 1 or (rows > 1 and t.stride(0) < cols):
        raise ValueError(f"jacobi_cuda needs contiguous rows of {name}, got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")
    return t.stride(0) if rows > 1 else cols


def sweep_out(x: torch.Tensor, window: Optional[Window],
              out: Optional[torch.Tensor]) -> Tuple[Window, torch.Tensor]:
    """Check a sweep's ``window`` and ``out`` (see
    :func:`~repro_torch.kernels.stencil_hd.ops.jacobi_step`); returns
    the window as Python ints and ``out``, allocated when None."""
    if x.dim() != 2:
        raise ValueError(f"a Jacobi sweep takes a 2-d tensor, not "
                         f"{x.dim()}-d")
    M, N = x.shape
    (i0, i1), (j0, j1) = ((int(lo), int(hi)) for lo, hi in
                          (window or ((0, M), (0, N))))
    if not (0 <= i0 <= i1 <= M and 0 <= j0 <= j1 <= N):
        raise ValueError(f"window {window} is not inside {tuple(x.shape)}")
    shape = (i1 - i0, j1 - j0)
    if out is None:
        return ((i0, i1), (j0, j1)), torch.empty(shape, dtype=x.dtype,
                                                 device=x.device)
    if tuple(out.shape) != shape or out.dtype != x.dtype \
            or out.device != x.device:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} does not hold the window {shape} "
                         f"{x.dtype} on {x.device}")
    if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with x")
    return ((i0, i1), (j0, j1)), out


def jacobi_cuda(x: torch.Tensor, *, window: Optional[Window] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Jacobi sweep over ``x (M, N)`` on the card; edges pass
    through.  ``x`` is float32 with unit column stride (a row band of a
    larger buffer is fine).  Writes rows ``[i0, i1)`` and columns
    ``[j0, j1)`` of the result, ``window=((i0, i1), (j0, j1))`` (default
    all of it), into ``out`` (contiguous rows, any row pitch; default a
    new tensor) and returns ``out``."""
    if not x.is_cuda:
        raise ValueError("jacobi_cuda needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"jacobi_cuda takes float32, not {x.dtype}")
    ((i0, i1), (j0, j1)), out = sweep_out(x, window, out)
    M, N = x.shape
    ldx, ldy = _pitch(x, "x"), _pitch(out, "out")
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), out.data_ptr(), M, N, ldx, ldy,
                       i0, i1, j0, j1,
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"jacobi_hd launch failed with CUDA error {err}")
    jacobi_cuda.launches += 1
    return out


jacobi_cuda.launches = 0
