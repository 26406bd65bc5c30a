"""Launch wrapper of the hand-written sLSTM recurrence
(``repro_torch/csrc/slstm_scan.cu``), the port of the ``lax.scan`` in the
reference's ``slstm_block`` (``repro/models/xlstm.py:187``, the scan at
``:217``).  The library builds on its first launch.

The source holds two variants; :func:`slstm_variant` picks one from the
shape and the wrapper launches that one by its code (the C entry
``slstm_scan_hd`` applies the same rule for a caller that names none),
or raises:

* ``"step"``: no cluster; blocks of ``STEP_UNITS`` units x ``STEP_ROWS``
  rows read r from L2 and meet at a grid barrier; T below
  ``STEP_MAX_T`` (a decode step);
* ``"cluster"``: the whole chain in one launch, a cluster of ``CLUSTER``
  blocks a batch row, each block's slice of r in registers, h exchanged
  through mbarriers; every prefill.

With grad enabled and an input that requires it, :func:`slstm_scan_cuda`
runs as :class:`SlstmScanFunction`: its forward launches the variant
and also writes what the backward reads (pre, c, n, m a step), its
backward launches :func:`slstm_scan_bwd_cuda` (the ``cluster`` layout in
reverse time, dpre exchanged through mbarriers) and takes dr and a
state's dh as plain products.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import count_launch
from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_costs import report_kernel

from .ref import State

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("step", "cluster")        # the source's kernel codes 0 and 1
PROBE = 2                             # its exchange probe's code
# the `cluster` kernel's kCluster, kUnits, kMaxDh, kDGroups, kBufs and
# kCols (units a warp, columns a lane)
CLUSTER, UNITS, MAX_DH, DGROUPS, BUFS, COLS = 16, 48, 192, 8, 3, 4
# the `step` kernel's kStepUnits, kStepRows, kStepThreads and
# kStepMaxBlocks (a grid resident at once on any H100, at 2 blocks an SM)
STEP_UNITS, STEP_ROWS, STEP_THREADS, STEP_MAX_BLOCKS = 8, 4, 256, 192
# the source's kStepMaxT: shorter T takes `step`.  At B 4, D 768 (bf16,
# from a state) `step` takes 0.0057 ms of device time at T 1 and 0.0098
# at T 2, `cluster` 0.0103 and 0.0116, then 0.0129 at T 3 against
# `step`'s 0.0139 (NVIDIA H100 80GB HBM3, 700 W; torch.profiler, by
# tools/slstm_scan_variants.py)
STEP_MAX_T = 3
# slstm_scan_hd's C parameters, in order
ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
    ctypes.c_longlong] * 2 + [ctypes.c_void_p]
# slstm_scan_kernel_hd's: the four saved tensors after the final state,
# then the kernel code after the dtype
KERNEL_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong] * 2 + [ctypes.c_void_p]
# slstm_scan_bwd_hd's
BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
# slstm_scan_bwd_probe_hd's: the same, then the probe's code
BWD_PROBE_ARGTYPES = BWD_ARGTYPES + [ctypes.c_int]
# the backward's probes (the source's kBwdExchange and kBwdCompute): the
# step loop with the exchange alone, and the product and gate math alone
BWD_PROBES = {"exchange": 1, "compute": 2}
# the backward's largest head count: with H <= 4 every block of a
# cluster sends its dpre to every other
BWD_MAX_HEADS = 4


def cluster_fits(D: int, H: int) -> bool:
    """Whether the `cluster` kernel takes width D in H heads: at most
    UNITS units a block and heads of at most MAX_DH."""
    return -(-D // CLUSTER) <= UNITS and D // H <= MAX_DH


def bwd_fits(D: int, H: int) -> bool:
    """Whether the backward kernel takes width D in H heads: the
    shapes of ``cluster`` with at most BWD_MAX_HEADS heads."""
    return cluster_fits(D, H) and H <= BWD_MAX_HEADS


def step_fits(B: int, D: int) -> bool:
    """Whether the `step` kernel takes B rows of width D: a grid of at
    most STEP_MAX_BLOCKS blocks (D up to 1536 at B 4)."""
    return -(-D // STEP_UNITS) * -(-B // STEP_ROWS) <= STEP_MAX_BLOCKS


def slstm_variant(B: int, T: int, D: int, H: int) -> Optional[str]:
    """The variant the wrapper launches for pre_x (B, T, 4D) in H heads
    (the rule of the source's variant_for): ``step`` below STEP_MAX_T
    steps and where ``cluster`` does not fit, ``cluster`` from there on;
    None where neither takes the shape."""
    cl = cluster_fits(D, H)
    if step_fits(B, D) and (T < STEP_MAX_T or not cl):
        return "step"
    return "cluster" if cl else None


def smem_bytes(D: int, H: int, variant: str) -> int:
    """The dynamic shared memory one block of ``variant`` takes (the
    source's cluster_smem or step_smem)."""
    if variant == "cluster":
        return 4 * BUFS * H * -(-(D // H) // 4) * 4
    return 16 * D


_entries = {}


def _stream(dev: int) -> int:
    """The current stream of device ``dev`` as a cudaStream_t: PyTorch's
    raw accessor, which builds no Stream object, else
    ``current_stream().cuda_stream``."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev)
    return torch.cuda.current_stream(dev).cuda_stream


def _entry(name: str):
    """The C function ``name`` of the library, its argument types set
    once."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.load("slstm_scan"), name)
        fn.argtypes = {"slstm_scan_hd": ARGTYPES,
                       "slstm_scan_kernel_hd": KERNEL_ARGTYPES,
                       "slstm_scan_bwd_hd": BWD_ARGTYPES,
                       "slstm_scan_bwd_probe_hd": BWD_PROBE_ARGTYPES}[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_state(name, st, B, D, dev):
    if st is None:
        return
    if len(st) != 4:
        raise ValueError(f"{name} must be the four tensors (c, n, h, m)")
    for t in st:
        if t.get_device() != dev:
            raise ValueError(f"slstm_scan_cuda needs {name} on the device "
                             f"of pre_x")
        if t.dtype != torch.float32 or t.shape != (B, D) \
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
    if B * T * D and slstm_variant(B, T, D, H) is None:
        raise ValueError(f"slstm_scan_cuda takes D up to {CLUSTER * UNITS} "
                         f"in heads of up to {MAX_DH}, or B and D that "
                         f"make at most {STEP_MAX_BLOCKS} blocks of "
                         f"{STEP_UNITS} units x {STEP_ROWS} rows; got B "
                         f"{B}, T {T}, D {D}, H {H}")
    if B > 65535:
        raise ValueError(f"slstm_scan_cuda's grid takes B up to 65535, "
                         f"got {B}")
    dev = pre_x.get_device()
    _check_state("state", state, B, D, dev)
    if out is not state:
        _check_state("out", out, B, D, dev)
    return B, T, D, H


def _call(name: str, args, dev: int) -> None:
    """Calls the C function ``name`` on device ``dev``; raises on a
    CUDA error."""
    fn = _entry(name)
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _launch(pre_x, r, state, out, B, T, D, H, kernel, saved=None):
    """Allocates hs (and ``out`` when None) and launches
    slstm_scan_kernel_hd on the kernel code ``kernel``, on checked
    operands with B, T, D > 0, writing ``saved`` (pre (B, T, 4D), c, n,
    m (B, T, D) float32) too where given; returns (hs, out)."""
    hs = pre_x.new_empty((B, T, D), dtype=torch.float32)
    if out is None:
        out = tuple(pre_x.new_empty((B, D), dtype=torch.float32)
                    for _ in range(4))
    st = (None,) * 4 if state is None else [t.data_ptr() for t in state]
    sv = (None,) * 4 if saved is None else [t.data_ptr() for t in saved]
    dev = pre_x.get_device()
    _call("slstm_scan_kernel_hd",
          [pre_x.data_ptr(), r.data_ptr(), *st, hs.data_ptr(),
           *(t.data_ptr() for t in out), *sv, _DTYPES[pre_x.dtype], kernel,
           B, T, D, H, pre_x.stride(0), pre_x.stride(1), _stream(dev)], dev)
    return hs, tuple(out)


class SlstmScanFunction(torch.autograd.Function):
    """The kernel pair as one differentiable op: the forward launches
    the variant and saves hs, pre, c, n and m; the backward launches
    :func:`slstm_scan_bwd_cuda` on them, then takes dr = sum h_{t-1} (x)
    dpre_t per head and a state's dh_{-1} = r . dpre_0 as plain
    products (the reference leaves both to XLA).  Inputs: pre_x, r and
    the state's c, n, h, m (all None for a zero state); outputs hs and
    the final c, n, h, m."""

    @staticmethod
    def forward(ctx, pre_x, r, c0, n0, h0, m0):
        B, T, D4 = pre_x.shape
        D, H = D4 // 4, r.shape[0]
        state = None if c0 is None else (c0, n0, h0, m0)
        f32 = dict(dtype=torch.float32, device=pre_x.device)
        saved = (torch.empty((B, T, D4), **f32),
                 *(torch.empty((B, T, D), **f32) for _ in range(3)))
        variant = slstm_variant(B, T, D, H)
        hs, out = _launch(pre_x, r, state, None, B, T, D, H,
                          VARIANTS.index(variant), saved)
        count_launch(slstm_scan_cuda, variant)
        report_kernel("slstm_scan", lambda: kernel_work.slstm_fwd(
            B, T, D, H, pre_x.element_size(), saving=True))
        ctx.save_for_backward(r, hs, *saved,
                              *(state if state is not None else ()))
        ctx.pre_dtype = pre_x.dtype
        return (hs, *out)

    @staticmethod
    def backward(ctx, dhs, dc1, dn1, dh1, dm1):
        r, hs, pre, c, n, m, *state = ctx.saved_tensors
        state = tuple(state) or None
        B, T, D = hs.shape
        H, Dh, E = r.shape
        dhs = torch.zeros_like(hs) if dhs is None else \
            dhs.float().contiguous()
        if dh1 is not None:                 # the final h is hs's last step
            dhs = dhs.clone()
            dhs[:, -1] += dh1
        final = None if dc1 is None and dn1 is None and dm1 is None else \
            tuple(torch.zeros((B, D), dtype=torch.float32, device=hs.device)
                  if g is None else g.float().contiguous()
                  for g in (dc1, dn1, dm1))
        dpre, dst = slstm_scan_bwd_cuda(dhs, r, (pre, c, n, m), state,
                                        final)
        dr = None
        if ctx.needs_input_grad[1]:
            first = (torch.zeros_like(hs[:, :1]) if state is None
                     else state[2][:, None].float())
            h_prev = torch.cat([first, hs[:, :-1]], 1).reshape(B * T, H, Dh)
            dr = torch.einsum("nhd,nhe->hde", h_prev,
                              dpre.reshape(B * T, H, E))
        grads = (None,) * 4
        if state is not None:
            dh0 = torch.einsum("bhe,hde->bhd", dpre[:, 0].reshape(B, H, E),
                               r).reshape(B, D)
            grads = (dst[0], dst[1], dh0, dst[2])
        return (dpre.to(ctx.pre_dtype), dr, *grads)


def slstm_scan_cuda(pre_x: torch.Tensor, r: torch.Tensor,
                    state: Optional[State] = None,
                    out: Optional[State] = None
                    ) -> Tuple[torch.Tensor, State]:
    """hs (B, T, D) float32 and the final (c, n, h, m) of the sLSTM
    recurrence (the function of
    :func:`~repro_torch.kernels.slstm_scan.ref.slstm_scan_ref`) in one
    launch of the variant :func:`slstm_variant` names.  pre_x (B, T, 4D)
    float32 or bfloat16 with any batch and time strides and a
    unit-stride last dim; r (H, Dh, 4Dh) float32; state four contiguous
    (B, D) float32 tensors or None (zeros); out four such tensors for
    the final state (new ones when None), which may be ``state``'s own.
    Launches are counted in ``slstm_scan_cuda.launches`` and
    ``slstm_scan_cuda.by_variant`` (:mod:`repro_torch.kernels.counts`).
    With grad enabled and an input that requires it, the results have a
    ``grad_fn`` (:class:`SlstmScanFunction`, whose backward launches
    :func:`slstm_scan_bwd_cuda`); ``out`` must then be None, and the
    shape one the backward takes (:func:`bwd_fits`)."""
    B, T, D, H = _check(pre_x, r, state, out)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre_x, r, *(state or ()))):
        if out is not None:
            raise ValueError("slstm_scan_cuda takes no out= with grad")
        if not bwd_fits(D, H):
            raise ValueError(f"slstm_scan_cuda's backward takes D up to "
                             f"{CLUSTER * UNITS} in at most {BWD_MAX_HEADS} "
                             f"heads of up to {MAX_DH}; got D {D}, H {H}")
        if B * T * D:
            hs, *fin = SlstmScanFunction.apply(pre_x, r,
                                               *(state or (None,) * 4))
            return hs, tuple(fin)
    if B * D == 0 or T == 0:
        dev = pre_x.device
        hs = torch.empty((B, T, D), dtype=torch.float32, device=dev)
        if out is None:
            out = tuple(torch.empty((B, D), dtype=torch.float32, device=dev)
                        for _ in range(4))
        for k, dst in enumerate(out):  # no step: the final state is the first
            if state is None:
                dst.zero_()
            else:
                dst.copy_(state[k])
        return hs, tuple(out)
    variant = slstm_variant(B, T, D, H)
    hs, out = _launch(pre_x, r, state, out, B, T, D, H,
                      VARIANTS.index(variant))
    count_launch(slstm_scan_cuda, variant)
    report_kernel("slstm_scan", lambda: kernel_work.slstm_fwd(
        B, T, D, H, pre_x.element_size()))
    return hs, out


def slstm_scan_kernel(pre_x: torch.Tensor, r: torch.Tensor,
                      state: Optional[State], kernel: int,
                      saved: Optional[Tuple[torch.Tensor, ...]] = None
                      ) -> Tuple[torch.Tensor, State]:
    """One uncounted launch of the source's kernel ``kernel`` (0 `step`,
    1 `cluster`, :data:`PROBE` the exchange probe) on the operands of
    :func:`slstm_scan_cuda`, for measurements: the probe's outputs are
    not the recurrence's.  ``saved``: pre (B, T, 4D), c, n, m (B, T, D)
    float32 to write what :func:`slstm_scan_bwd_cuda` reads, as a
    forward with grad does."""
    B, T, D, H = _check(pre_x, r, state, None)
    return _launch(pre_x, r, state, None, B, T, D, H, kernel, saved)


def slstm_scan_bwd_cuda(dhs: torch.Tensor, r: torch.Tensor,
                        saved: Tuple[torch.Tensor, ...],
                        state: Optional[State] = None,
                        dfinal: Optional[Tuple[torch.Tensor, ...]] = None
                        ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """dpre (B, T, 4D) float32, the gradient of the recurrence's
    pre-activations (pre_x's gradient, before its cast), and with a
    ``state`` the gradients (dc0, dn0, dm0) of its c, n and m (else
    None), from dhs = dL/dhs (B, T, D) float32.  ``saved`` is what
    :class:`SlstmScanFunction`'s forward wrote on these inputs: pre (B,
    T, 4D), c, n, m (B, T, D) float32; ``dfinal`` the gradients of the
    final (c, n, m), or None for zeros.  The function of
    :func:`~repro_torch.kernels.slstm_scan.ref.slstm_scan_bwd_ref`
    without dr and dh0.  One launch of ``csrc/slstm_scan.cu``'s
    backward, counted in ``slstm_scan_bwd_cuda.launches``; a launch that
    fails raises, nothing falls back to the plain version."""
    out = _bwd(dhs, r, saved, state, dfinal)
    count_launch(slstm_scan_bwd_cuda)
    B, T, D = dhs.shape
    report_kernel("slstm_scan_bwd", lambda: kernel_work.slstm_bwd(
        B, T, D, r.shape[0]))
    return out


def slstm_scan_bwd_probe(dhs: torch.Tensor, r: torch.Tensor,
                         saved: Tuple[torch.Tensor, ...], probe: str
                         ) -> None:
    """One uncounted launch of a probe of the backward (``probe``, a key
    of :data:`BWD_PROBES`) on the operands of
    :func:`slstm_scan_bwd_cuda`, for measurements: not the function, its
    dpre is not the gradient."""
    _bwd(dhs, r, saved, None, None, BWD_PROBES[probe])


def _bwd(dhs, r, saved, state, dfinal, probe=0):
    """slstm_scan_bwd_cuda's launch, or with ``probe`` the C entry
    slstm_scan_bwd_probe_hd's; returns (dpre, the state's gradients)."""
    B, T, D = dhs.shape
    H = r.shape[0]
    if not (dhs.is_cuda and r.is_cuda):
        raise ValueError("slstm_scan_bwd_cuda needs CUDA tensors")
    if B * T * D == 0:
        raise ValueError(f"slstm_scan_bwd_cuda needs at least one step and "
                         f"unit, got B {B}, T {T}, D {D}")
    if not bwd_fits(D, H):
        raise ValueError(f"slstm_scan_bwd_cuda takes D up to "
                         f"{CLUSTER * UNITS} in at most {BWD_MAX_HEADS} heads "
                         f"of up to {MAX_DH}; got D {D}, H {H}")
    want = ((B, T, 4 * D),) + ((B, T, D),) * 3
    dev = dhs.get_device()
    for t, shape in zip((dhs,) + tuple(saved), ((B, T, D),) + want):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.get_device() != dev:
            raise ValueError(f"slstm_scan_bwd_cuda needs contiguous float32 "
                             f"{shape} tensors on the device, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_state("state", state, B, D, dev)
    if r.dtype != torch.float32 or not r.is_contiguous() or \
            tuple(r.shape) != (H, D // H, 4 * D // H):
        raise ValueError(f"r must be a contiguous (H, {D} / H, 4 {D} / H) "
                         f"float32 tensor, got {tuple(r.shape)} {r.dtype}")
    for t in dfinal or ():
        if t.dtype != torch.float32 or tuple(t.shape) != (B, D) or \
                not t.is_contiguous() or t.get_device() != dev:
            raise ValueError(f"dfinal must hold three contiguous ({B}, {D}) "
                             f"float32 tensors on the device")
    f32 = dict(dtype=torch.float32, device=dhs.device)
    dpre = torch.empty((B, T, 4 * D), **f32)
    dst = None if state is None else tuple(torch.empty((B, D), **f32)
                                           for _ in range(3))
    st = (None,) * 3 if state is None else [
        state[k].data_ptr() for k in (0, 1, 3)]
    fin = (None,) * 3 if dfinal is None else [t.data_ptr() for t in dfinal]
    _call("slstm_scan_bwd_probe_hd" if probe else "slstm_scan_bwd_hd",
          [dhs.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in saved),
           *st, *fin, dpre.data_ptr(),
           *((None,) * 3 if dst is None else (t.data_ptr() for t in dst)),
           B, T, D, H, _stream(dev)] + ([probe] if probe else []), dev)
    return dpre, dst


slstm_scan_cuda.launches = 0
slstm_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
slstm_scan_bwd_cuda.launches = 0
