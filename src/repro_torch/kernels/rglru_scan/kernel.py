"""Launch wrapper of the hand-written RG-LRU scan
(``repro_torch/csrc/rglru_scan.cu``), the port of the reference's
``_rglru_scan`` (``repro/models/rglru.py:73``).  The library builds on
its first launch.

The source holds two variants; :func:`scan_variant` picks one from the
shape, and the wrapper launches it or raises:

* ``"sequential"``: one thread per (batch, channel) walks T; a decode
  step (T = 1) and other short T;
* ``"chunked"``: T cut into windows of ``CHUNK_WINDOW`` steps and
  sub-chunks of ``CHUNK_STEPS``, the gates computed in parallel and the
  sub-chunks' aggregates composed, clusters of ``CHUNK_CLUSTER``
  blocks passing the carry from window to window; every prefill.

With grad enabled and an input that requires it, :func:`rglru_scan_cuda`
runs as :class:`RglruScanFunction`: its forward launches the variant
and saves h, and its backward is :func:`rglru_scan_bwd_cuda`, the
``chunked`` windows run in reverse time (``rglru_scan_bwd_hd``, the
gradient JAX takes through ``_rglru_scan``), one channel a lane,
``BWD_STRIP`` channels a block, clusters of ``BWD_CLUSTER`` blocks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import count_launch
from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_costs import report_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("sequential", "chunked")         # the source's variant codes
# the chunked kernel's kSteps, kWindow and kCluster
CHUNK_STEPS, CHUNK_WINDOW, CHUNK_CLUSTER = 8, 32, 4
# the backward kernel's kBwdWc (channels a block) and kBwdCluster: 640
# blocks at a training microbatch of (1, 4096, 2560)
BWD_STRIP, BWD_CLUSTER = 32, 8
# the shortest T that takes the chunked variant: at B 4, W 2560 (bf16,
# from a state) the chunked kernel takes 0.0076 ms of device time from
# T = 1 to 16 and the sequential one 0.0032 ms at T = 1, 0.0074 at 12,
# 0.0090 at 16 (NVIDIA H100 80GB HBM3, 700 W; torch.profiler, by
# tools/rglru_scan_layouts.py)
CHUNKED_MIN_T = 16
# rglru_scan_hd's C parameters, in order
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_void_p]
# rglru_scan_bwd_hd's C parameters, in order
BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p, ctypes.c_void_p]


def scan_variant(B: int, T: int, W: int) -> str:
    """The kernel variant that scans (B, T, W) inputs: ``chunked`` from
    ``CHUNKED_MIN_T`` steps on, ``sequential`` below (a decode step)."""
    return "chunked" if T >= CHUNKED_MIN_T else "sequential"


def _entry(name: str = "rglru_scan_hd", argtypes=ARGTYPES):
    fn = getattr(build.load("rglru_scan"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(x_in, gate_a, gate_i, lam, h0):
    """Validates the operands; returns (B, T, W)."""
    tensors = [x_in, gate_a, gate_i, lam] + ([h0] if h0 is not None else [])
    if not all(t.is_cuda and t.device == x_in.device for t in tensors):
        raise ValueError("rglru_scan_cuda needs every operand on one CUDA "
                         "device")
    if x_in.dtype not in _DTYPES or gate_a.dtype != x_in.dtype \
            or gate_i.dtype != x_in.dtype:
        raise TypeError(f"rglru_scan_cuda takes x_in, gate_a and gate_i "
                        f"of one type, float32 or bfloat16, got "
                        f"{x_in.dtype}, {gate_a.dtype}, {gate_i.dtype}")
    if x_in.dim() != 3:
        raise ValueError(f"x_in must be (B, T, W), got {tuple(x_in.shape)}")
    B, T, W = x_in.shape
    for name, t in (("gate_a", gate_a), ("gate_i", gate_i)):
        if t.shape != x_in.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not x_in's "
                             f"{tuple(x_in.shape)}")
    for name, t in (("x_in", x_in), ("gate_a", gate_a), ("gate_i", gate_i)):
        if t.stride(2) != 1 and W > 1:
            raise ValueError(f"rglru_scan_cuda needs a unit-stride last dim "
                             f"of {name}, got strides {t.stride()}")
    if lam.dtype != torch.float32 or tuple(lam.shape) != (W,) \
            or not lam.is_contiguous():
        raise ValueError(f"lam must be a contiguous ({W},) float32 tensor, "
                         f"got {tuple(lam.shape)} {lam.dtype}")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (B, W)
                           or (h0.stride(1) != 1 and W > 1)):
        raise ValueError(f"h0 must be a ({B}, {W}) float32 tensor with a "
                         f"unit-stride last dim, got {tuple(h0.shape)} "
                         f"{h0.dtype} strides {h0.stride()}")
    if B > 65535:
        raise ValueError(f"rglru_scan_cuda's grid takes B up to 65535, "
                         f"got {B}")
    return B, T, W


def _strides(x_in, gate_a, gate_i, h0):
    """The C entries' strides: batch and time of x_in, gate_a and
    gate_i, then h0's batch stride."""
    return (ctypes.c_longlong * 7)(
        x_in.stride(0), x_in.stride(1), gate_a.stride(0), gate_a.stride(1),
        gate_i.stride(0), gate_i.stride(1),
        0 if h0 is None else h0.stride(0))


def _forward(x_in, gate_a, gate_i, lam, h0, variant) -> torch.Tensor:
    """One launch of ``variant``; returns h (B, T, W) float32."""
    B, T, W = x_in.shape
    out = torch.empty((B, T, W), dtype=torch.float32, device=x_in.device)
    if out.numel() == 0:
        return out
    strides = _strides(x_in, gate_a, gate_i, h0)
    with torch.cuda.device(x_in.device):
        err = _entry()(
            x_in.data_ptr(), gate_a.data_ptr(), gate_i.data_ptr(),
            lam.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), _DTYPES[x_in.dtype], VARIANTS.index(variant),
            B, T, W,
            ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_hd launch failed with CUDA error "
                           f"{err}")
    count_launch(rglru_scan_cuda, variant)
    report_kernel("rglru_scan", lambda: kernel_work.rglru_fwd(
        B, T, W, x_in.element_size(), h0 is not None))
    return out


class RglruScanFunction(torch.autograd.Function):
    """The scan kernel as one differentiable op: the forward launches
    ``variant`` and saves h, the backward launches
    :func:`rglru_scan_bwd_cuda` from it."""

    @staticmethod
    def forward(ctx, x_in, gate_a, gate_i, lam, h0, variant):
        h = _forward(x_in, gate_a, gate_i, lam, h0, variant)
        ctx.save_for_backward(x_in, gate_a, gate_i, lam, h0, h)
        return h

    @staticmethod
    def backward(ctx, g):
        x_in, gate_a, gate_i, lam, h0, h = ctx.saved_tensors
        dx, dga, dgi, dlam, dh0 = rglru_scan_bwd_cuda(
            g, x_in, gate_a, gate_i, lam, h0, h)
        return dx, dga, dgi, dlam, dh0, None


def rglru_scan_cuda(x_in: torch.Tensor, gate_a: torch.Tensor,
                    gate_i: torch.Tensor, lam: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    variant: Optional[str] = None) -> torch.Tensor:
    """h (B, T, W) float32 of the RG-LRU recurrence over axis 1 (the
    function of :func:`~repro_torch.kernels.rglru_scan.ref.rglru_scan_ref`)
    in one launch.  x_in, gate_a and gate_i are (B, T, W), float32 or
    bfloat16, with any batch and time strides and a unit-stride last
    dim; lam (W,) float32; h0 (B, W) float32 or None.  ``variant``
    names one of ``VARIANTS``; by default :func:`scan_variant` picks
    it.  Launches are counted in ``rglru_scan_cuda.launches`` and
    ``rglru_scan_cuda.by_variant`` as executions
    (:mod:`repro_torch.kernels.counts`).  With grad enabled and an
    input that requires it, the result has a ``grad_fn``
    (:class:`RglruScanFunction`, whose backward launches
    :func:`rglru_scan_bwd_cuda`)."""
    B, T, W = _check(x_in, gate_a, gate_i, lam, h0)
    if variant is None:
        variant = scan_variant(B, T, W)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x_in, gate_a, gate_i, lam, h0)):
        return RglruScanFunction.apply(x_in, gate_a, gate_i, lam, h0,
                                       variant)
    return _forward(x_in, gate_a, gate_i, lam, h0, variant)


def rglru_scan_bwd_cuda(g: torch.Tensor, x_in: torch.Tensor,
                        gate_a: torch.Tensor, gate_i: torch.Tensor,
                        lam: torch.Tensor, h0: Optional[torch.Tensor],
                        h: torch.Tensor):
    """The gradients (dx, dgate_a, dgate_i, dlam, dh0) of the scan from
    g = dL/dh (B, T, W), where h is :func:`rglru_scan_cuda`'s output on
    these inputs: dx, dgate_a and dgate_i (B, T, W) in the inputs'
    dtype, dlam (W,) float32, dh0 (B, W) float32 or None without h0;
    the function of
    :func:`~repro_torch.kernels.rglru_scan.ref.rglru_scan_bwd_ref`.
    One call is two launches of ``csrc/rglru_scan.cu``'s backward (the
    reverse scan, then the sum of dlam's per-block partials, no
    atomics), counted once in ``rglru_scan_bwd_cuda.launches``.  A
    launch that fails raises; nothing falls back to the plain
    version."""
    B, T, W = _check(x_in, gate_a, gate_i, lam, h0)
    for name, t in (("g", g), ("h", h)):
        if tuple(t.shape) != (B, T, W) or t.dtype != torch.float32 or \
                t.device != x_in.device:
            raise ValueError(f"{name} must be a ({B}, {T}, {W}) float32 "
                             f"tensor on {x_in.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    g, h = g.contiguous(), h.contiguous()
    kw = dict(dtype=x_in.dtype, device=x_in.device)
    dx, dga, dgi = (torch.empty((B, T, W), **kw) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=x_in.device)
    if B * T * W == 0:                 # no step: dlam and dh0 are 0
        return (dx, dga, dgi, torch.zeros((W,), **f32),
                None if h0 is None else torch.zeros((B, W), **f32))
    dlam = torch.empty((W,), **f32)
    dh0 = None if h0 is None else torch.empty((B, W), **f32)
    part = torch.empty((B, BWD_CLUSTER, W), **f32)
    strides = _strides(x_in, gate_a, gate_i, h0)
    with torch.cuda.device(x_in.device):
        err = _entry("rglru_scan_bwd_hd", BWD_ARGTYPES)(
            g.data_ptr(), x_in.data_ptr(), gate_a.data_ptr(),
            gate_i.data_ptr(), lam.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            dx.data_ptr(), dga.data_ptr(), dgi.data_ptr(), part.data_ptr(),
            dlam.data_ptr(), None if dh0 is None else dh0.data_ptr(),
            _DTYPES[x_in.dtype], B, T, W, ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd_hd launch failed with CUDA "
                           f"error {err}")
    count_launch(rglru_scan_bwd_cuda)
    report_kernel("rglru_scan_bwd", lambda: kernel_work.rglru_bwd(
        B, T, W, x_in.element_size(), h0 is not None))
    return dx, dga, dgi, dlam, dh0


rglru_scan_cuda.launches = 0
rglru_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
rglru_scan_bwd_cuda.launches = 0
