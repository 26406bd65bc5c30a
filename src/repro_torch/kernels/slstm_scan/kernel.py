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
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import count_launch

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
# slstm_scan_kernel_hd's: the same with the kernel code after the dtype
KERNEL_ARGTYPES = ARGTYPES[:12] + [ctypes.c_int] + ARGTYPES[12:]


def cluster_fits(D: int, H: int) -> bool:
    """Whether the `cluster` kernel takes width D in H heads: at most
    UNITS units a block and heads of at most MAX_DH."""
    return -(-D // CLUSTER) <= UNITS and D // H <= MAX_DH


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
        fn.argtypes = ARGTYPES if name == "slstm_scan_hd" \
            else KERNEL_ARGTYPES
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


def _launch(pre_x, r, state, out, B, T, D, H, kernel):
    """Allocates hs (and ``out`` when None) and launches
    slstm_scan_kernel_hd on the kernel code ``kernel``, on checked
    operands with B, T, D > 0; returns (hs, out)."""
    hs = pre_x.new_empty((B, T, D), dtype=torch.float32)
    if out is None:
        out = tuple(pre_x.new_empty((B, D), dtype=torch.float32)
                    for _ in range(4))
    st = (None,) * 4 if state is None else [t.data_ptr() for t in state]
    dev = pre_x.get_device()
    args = [pre_x.data_ptr(), r.data_ptr(), *st, hs.data_ptr(),
            *(t.data_ptr() for t in out), _DTYPES[pre_x.dtype], kernel, B,
            T, D, H, pre_x.stride(0), pre_x.stride(1), _stream(dev)]
    fn = _entry("slstm_scan_kernel_hd")
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        raise RuntimeError(f"slstm_scan_kernel_hd launch failed with CUDA "
                           f"error {err}")
    return hs, tuple(out)


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
    The kernel has no backward: with grad enabled and an input that
    requires it, this raises."""
    B, T, D, H = _check(pre_x, r, state, out)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre_x, r, *(state or ()))):
        raise NotImplementedError(
            "slstm_scan_cuda has no backward yet (ROADMAP: Queue 2 item 3, "
            "training xlstm)")
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
    return hs, out


def slstm_scan_kernel(pre_x: torch.Tensor, r: torch.Tensor,
                      state: Optional[State], kernel: int
                      ) -> Tuple[torch.Tensor, State]:
    """One uncounted launch of the source's kernel ``kernel`` (0 `step`,
    1 `cluster`, :data:`PROBE` the exchange probe) on the operands of
    :func:`slstm_scan_cuda`, for measurements: the probe's outputs are
    not the recurrence's."""
    B, T, D, H = _check(pre_x, r, state, None)
    return _launch(pre_x, r, state, None, B, T, D, H, kernel)


slstm_scan_cuda.launches = 0
slstm_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
