"""Launch wrapper of the hand-written sLSTM recurrence
(``repro_torch/csrc/slstm_scan.cu``), the port of the ``lax.scan`` in the
reference's ``slstm_block`` (``repro/models/xlstm.py:187``, the scan at
``:217``).  The library builds on its first launch.

One variant, ``cluster``: a cluster of ``CLUSTER`` blocks per group of
``ROWS`` batch rows walks all T steps, each block holding its units'
slice of the recurrent weights in shared memory and exchanging h through
distributed shared memory every step.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import count_launch

from .ref import State

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("cluster",)
CLUSTER, ROWS = 16, 4                 # the source's kCluster and kRows
MAX_THREADS = 512                     # its kMaxThreads: 4U threads a block
MAX_SMEM = 232448                     # bytes of shared memory a block
# slstm_scan_hd's C parameters, in order
ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
    ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def smem_bytes(D: int, H: int) -> int:
    """The shared memory one block takes (the source's smem_bytes)."""
    U = -(-D // CLUSTER)
    return 16 * (2 * D + U) + 4 * 4 * U * (ROWS + D // H)


def _entry():
    fn = build.load("slstm_scan").slstm_scan_hd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_state(name, st, B, D, dev):
    if st is None:
        return
    if len(st) != 4:
        raise ValueError(f"{name} must be the four tensors (c, n, h, m)")
    for t in st:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"slstm_scan_cuda needs {name} on the device "
                             f"of pre_x")
        if t.dtype != torch.float32 or tuple(t.shape) != (B, D) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must hold contiguous ({B}, {D}) "
                             f"float32 tensors, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _check(pre_x, r, state, out):
    """Validates the operands; returns (B, T, D, H)."""
    if not pre_x.is_cuda:
        raise ValueError("slstm_scan_cuda needs pre_x on a CUDA device")
    if pre_x.dtype not in _DTYPES:
        raise TypeError(f"slstm_scan_cuda takes pre_x in float32 or "
                        f"bfloat16, got {pre_x.dtype}")
    if pre_x.dim() != 3 or pre_x.shape[2] % 4:
        raise ValueError(f"pre_x must be (B, T, 4D), got "
                         f"{tuple(pre_x.shape)}")
    B, T, D4 = pre_x.shape
    D = D4 // 4
    if pre_x.stride(2) != 1 and D4 > 1:
        raise ValueError(f"slstm_scan_cuda needs a unit-stride last dim of "
                         f"pre_x, got strides {pre_x.stride()}")
    if r.dim() != 3 or not (r.is_cuda and r.device == pre_x.device):
        raise ValueError("r must be (H, Dh, 4Dh) on the device of pre_x")
    H, Dh, E = r.shape
    if r.dtype != torch.float32 or H * Dh != D or E != 4 * Dh \
            or not r.is_contiguous():
        raise ValueError(f"r must be a contiguous (H, {D} / H, 4 {D} / H) "
                         f"float32 tensor, got {tuple(r.shape)} {r.dtype}")
    if 4 * -(-D // CLUSTER) > MAX_THREADS or smem_bytes(D, H) > MAX_SMEM:
        raise ValueError(f"slstm_scan_cuda takes D up to "
                         f"{CLUSTER * MAX_THREADS // 4} and a slice of r "
                         f"that fits a block's shared memory, got D {D}, "
                         f"H {H} ({smem_bytes(D, H)} bytes)")
    if -(-B // ROWS) > 65535:
        raise ValueError(f"slstm_scan_cuda's grid takes B up to "
                         f"{ROWS * 65535}, got {B}")
    _check_state("state", state, B, D, pre_x.device)
    _check_state("out", out, B, D, pre_x.device)
    return B, T, D, H


def slstm_scan_cuda(pre_x: torch.Tensor, r: torch.Tensor,
                    state: Optional[State] = None,
                    out: Optional[State] = None
                    ) -> Tuple[torch.Tensor, State]:
    """hs (B, T, D) float32 and the final (c, n, h, m) of the sLSTM
    recurrence (the function of
    :func:`~repro_torch.kernels.slstm_scan.ref.slstm_scan_ref`) in one
    launch.  pre_x (B, T, 4D) float32 or bfloat16 with any batch and
    time strides and a unit-stride last dim; r (H, Dh, 4Dh) float32;
    state four contiguous (B, D) float32 tensors or None (zeros); out
    four such tensors for the final state (new ones when None), which
    may be ``state``'s own.  Launches are counted in
    ``slstm_scan_cuda.launches`` and ``slstm_scan_cuda.by_variant``
    (:mod:`repro_torch.kernels.counts`).  The kernel has no backward:
    with grad enabled and an input that requires it, this raises."""
    B, T, D, H = _check(pre_x, r, state, out)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre_x, r, *(state or ()))):
        raise NotImplementedError(
            "slstm_scan_cuda has no backward yet (ROADMAP: Queue 1 item 4, "
            "training xlstm)")
    dev = pre_x.device
    hs = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    if out is None:
        out = tuple(torch.empty((B, D), dtype=torch.float32, device=dev)
                    for _ in range(4))
    if B * D == 0:
        return hs, tuple(out)
    if T == 0:                     # no step: the final state is the first
        for k, dst in enumerate(out):
            if state is None:
                dst.zero_()
            else:
                dst.copy_(state[k])
        return hs, tuple(out)
    st = [None] * 4 if state is None else [t.data_ptr() for t in state]
    with torch.cuda.device(dev):
        err = _entry()(
            pre_x.data_ptr(), r.data_ptr(), *st, hs.data_ptr(),
            *(t.data_ptr() for t in out), _DTYPES[pre_x.dtype], B, T, D, H,
            pre_x.stride(0), pre_x.stride(1),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"slstm_scan_hd launch failed with CUDA error "
                           f"{err}")
    count_launch(slstm_scan_cuda, "cluster")
    return hs, tuple(out)


slstm_scan_cuda.launches = 0
slstm_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
