"""Launch wrappers of the hand-written flash-attention kernels, the
port of the reference's ``flash_attention_pallas`` (the forward,
``repro_torch/csrc/flash_attn_hd.cu``) and of its ``custom_vjp``
backward (``jnp_impl.py:_bw_blocks``; ``csrc/flash_attn_bwd_hd.cu``).
The libraries build on their first launch.

:func:`flash_attention_cuda` is differentiable: when grad is enabled
and q, k or v requires it, it runs as :class:`FlashAttentionFunction`,
whose forward also writes the rows' log-sum-exp and whose backward is
:func:`flash_attention_bwd_cuda`.  Without grad the forward writes no
log-sum-exp (the serving path).

The source holds three variants; :func:`flash_variant` picks one from
the dtype and head dims alone, and the wrapper launches it or raises:

* ``"wgmma"``: bf16 and fp16 with ``Dh == Dv`` in {64, 128, 256}, or
  ``Dh`` 192 / ``Dv`` 128 (MLA's naive form), every serving prefill
  (warp-specialised, TMA-fed wgmma);
* ``"mma_sync"``: the other bf16 and fp16 head dims (the other
  ``Dh != Dv`` pairs, or neither 64, 128 nor 256);
* ``"ffma"``: float32 (IEEE FFMA, no TF32).

MLA's RoPE columns may come as operands of their own, ``q_rope`` (B, T,
Hq, Dr) and ``k_rope`` (B, S, 1, Dr), one RoPE key a position shared by
every head: the logits are ``(q.k + q_rope.k_rope) * scale``, what the
concatenated operands give.  The ``wgmma`` kernel at 192 / 128 reads
them in place (``q`` and ``k`` 128 wide, ``Dr`` 64); for any other
split the wrapper concatenates them and launches the variant the
joined head dims take.

The backward has two, between them every type and head dims the
forward takes: :func:`bwd_variant` picks ``"wgmma"`` (warp-specialised,
TMA-fed wgmma) for bf16 and fp16 at ``Dh == Dv`` in {64, 128, 256} and
at MLA's ``Dh`` 192 / ``Dv`` 128 (every full-size training launch), and
``"ffma"`` (plain FFMA loops on operands widened to float32: delta, dK
and dV, dQ, and with a GQA group the sum of its heads' partials) for
float32 and for every other pair of 16-bit head dims, such as the
reduced configs' Dh 16.  At Dh 64 and 128
``wgmma`` is five launches (a pre-pass, dV, dK, dQ, the GQA sum); at Dh
256 and at 192 / 128 four, dK and dV in one pass whose two warpgroups
split by role on the same 64 keys (S^T and P^T on one side, dP^T and
dS^T on the other, P^T handed over in shared memory).  With grad, MLA's
RoPE operands are joined to q and k first, so the backward takes q and
k 192 wide and autograd sums the shared RoPE key's gradient over the
heads.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import count_launch
from repro_torch.roofline import kernel_work
from repro_torch.roofline.op_costs import report_kernel

from .ref import join_rope

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VARIANTS = ("ffma", "mma_sync", "wgmma")     # the source's variant codes
BWD_VARIANTS = ("ffma", "wgmma")
WGMMA_HEAD_DIMS = (64, 128, 256)
# (Dh, Dv) of the wgmma instantiation for MLA, and the (q and k, RoPE)
# widths in which it takes the RoPE columns as operands of their own
WGMMA_MLA_DIMS = (192, 128)
WGMMA_ROPE_SPLIT = (128, 64)
BWD_HEAD_DIMS = (64, 128, 256)
# (Dh, Dv) the wgmma backward also takes: MLA's naive form
BWD_MLA_DIMS = (192, 128)
WGMMA_ROWS = 128                             # query rows per wgmma block
_INT32_MAX = 2 ** 31 - 1


def check_types(dtype: torch.dtype, Dh: int, Dv: int) -> None:
    """Raises where the forward refuses these operand types or head
    dims: TypeError for a dtype other than float32, bfloat16 and
    float16, ValueError for a head dim that is not a multiple of 8 up
    to 256."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda takes float32, bfloat16 or "
                        f"float16, got {dtype}")
    for name, d in (("Dh", Dh), ("Dv", Dv)):
        if not (0 < d <= 256 and d % 8 == 0):
            raise ValueError(f"flash_attention_cuda takes head dims that "
                             f"are multiples of 8 up to 256, got {name}={d}")


def flash_variant(dtype: torch.dtype, Dh: int, Dv: int) -> str:
    """The kernel variant that computes attention for these operand
    types and head dims."""
    if dtype == torch.float32:
        return "ffma"
    if (Dh == Dv and Dh in WGMMA_HEAD_DIMS) or (Dh, Dv) == WGMMA_MLA_DIMS:
        return "wgmma"
    return "mma_sync"


def bwd_variant(dtype: torch.dtype, Dh: int, Dv: int) -> str:
    """The backward kernel's variant for these types and head dims:
    ``"wgmma"`` for 16-bit types at ``Dh == Dv`` in
    :data:`BWD_HEAD_DIMS` or at :data:`BWD_MLA_DIMS`, else ``"ffma"``.
    Raises only where the forward raises (:func:`check_types`)."""
    check_types(dtype, Dh, Dv)
    if dtype != torch.float32 and (
            (Dh == Dv and Dh in BWD_HEAD_DIMS) or (Dh, Dv) == BWD_MLA_DIMS):
        return "wgmma"
    return "ffma"


# flash_attn_hd's C parameters, in order
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p]
# flash_attn_bwd_hd's C parameters, in order
BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p]
# flash_attn_bwd_probe_hd's: the same, then the probe's code
BWD_PROBE_ARGTYPES = BWD_ARGTYPES + [ctypes.c_int]
# the dK/dV pass's probes at Dh 192 / Dv 128 (the source's kNoMath and
# kNoCopies): its elementwise math left out, its copies after the first
# three parts left out
BWD_PROBES = {"no math": 1, "no copies": 2}
# the probe entry's launches of the function's own parts, for timing each
# by CUDA events (the source's kPrePassAlone and kPassAlone): the
# pre-pass alone, the pre-pass and the dK/dV pass alone
BWD_PARTS = {"pre-pass": 3, "pre-pass and dK/dV": 4}


def _entry(name: str = "flash_attn_hd", argtypes=ARGTYPES,
           lib: Optional[str] = None):
    fn = getattr(build.load(lib or name), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _strides(t: torch.Tensor, name: str, align: int):
    """(batch, position, head) element strides of a 4-d operand whose
    last dim is unit-stride; 16-bit types also need 16-byte rows."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"flash_attention_cuda needs a unit-stride last "
                         f"dim of {name}, got strides {t.stride()}")
    # a dim of extent 1 is never stepped along: its stride is free
    strides = [st if n > 1 else 0 for st, n in zip(t.stride()[:3], t.shape)]
    if align > 1 and (t.data_ptr() % 16 or any(st % align for st in strides)):
        raise ValueError(f"flash_attention_cuda needs 16-byte aligned rows "
                         f"of {name} (strides {t.stride()} elements, "
                         f"address {t.data_ptr():#x})")
    return strides


def _check(q, k, v, qpos):
    """Validates the operands of the forward; returns
    (B, T, S, Hq, Hkv, Dh, Dv)."""
    tensors = (q, k, v, qpos)
    if not all(t.is_cuda for t in tensors) or any(
            t.device != q.device for t in tensors):
        raise ValueError("flash_attention_cuda needs q, k, v and qpos on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32, bfloat16 or "
                        f"float16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d (B, T|S, H, D)")
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    if (k.shape[0], k.shape[3]) != (B, Dh) or tuple(v.shape[:3]) != (B, S, Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    check_types(q.dtype, Dh, Dv)
    if tuple(qpos.shape) != (B, T):
        raise ValueError(f"qpos {tuple(qpos.shape)} is not (B, T) = {(B, T)}")
    if max(B, Hq) > 65535 or max(T, S) > _INT32_MAX:
        raise ValueError("flash_attention_cuda grid limits: B and Hq up to "
                         "65535, T and S under 2**31")
    return B, T, S, Hq, Hkv, Dh, Dv


def check_rope(q, k, q_rope, k_rope) -> int:
    """Validates the RoPE operands against q and k; returns Dr, 0 when
    neither is given."""
    if q_rope is None and k_rope is None:
        return 0
    if q_rope is None or k_rope is None:
        raise ValueError("q_rope and k_rope come together")
    if q_rope.dtype != q.dtype or k_rope.dtype != q.dtype:
        raise TypeError(f"q_rope and k_rope must be {q.dtype}, got "
                        f"{q_rope.dtype}, {k_rope.dtype}")
    if q_rope.device != q.device or k_rope.device != q.device:
        raise ValueError(f"q_rope and k_rope must be on {q.device}, got "
                         f"{q_rope.device}, {k_rope.device}")
    Dr = q_rope.shape[-1] if q_rope.dim() == 4 else -1
    want_q, want_k = (*q.shape[:3], Dr), (k.shape[0], k.shape[1], 1, Dr)
    if q_rope.dim() != 4 or tuple(q_rope.shape) != want_q or \
            tuple(k_rope.shape) != want_k or Dr <= 0:
        raise ValueError(f"q_rope {tuple(q_rope.shape)} and k_rope "
                         f"{tuple(k_rope.shape)} must be (B, T, Hq, Dr) "
                         f"and (B, S, 1, Dr) beside q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)}")
    return Dr


def attention_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: Optional[torch.Tensor]) -> torch.Tensor:
    """The (B, T, Hq, Dv) output of attention on q, k and v: ``out``
    once checked (q's dtype and device, sharing no memory with an
    operand), or a new tensor."""
    shape = (*q.shape[:3], v.shape[3])
    if out is None:
        return torch.empty(shape, dtype=q.dtype, device=q.device)
    if tuple(out.shape) != shape or out.dtype != q.dtype or \
            out.device != q.device:
        raise ValueError(f"out must be {shape} {q.dtype} on {q.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if out.untyped_storage().data_ptr() in (
            t.untyped_storage().data_ptr() for t in (q, k, v)):
        raise ValueError("out must not share memory with q, k or v")
    return out


def _forward(q, k, v, qpos, window, softcap, scale, with_lse: bool,
             out=None, q_rope=None, k_rope=None):
    """One launch of the forward kernel into ``out`` (default a new
    tensor); returns (out, lse), lse None unless ``with_lse``.  The RoPE
    operands go to the kernel as they are where it takes them (wgmma at
    192 / 128, split at 128 / 64), else joined to q and k."""
    Dr = check_rope(q, k, q_rope, k_rope)
    if Dr and not (flash_variant(q.dtype, q.shape[-1] + Dr, v.shape[-1])
                   == "wgmma" and (q.shape[-1], Dr) == WGMMA_ROPE_SPLIT):
        q, k = join_rope(q, k, q_rope, k_rope)
        q_rope = k_rope = None
        Dr = 0
    B, T, S, Hq, Hkv, Dh, Dv = _check(q, k, v, qpos)
    variant = flash_variant(q.dtype, Dh + Dr, Dv)
    if variant == "wgmma" and -(-T // WGMMA_ROWS) > 65535:
        raise ValueError(f"flash_attention_cuda's wgmma variant takes T up "
                         f"to {65535 * WGMMA_ROWS}, got {T}")
    align = 8 if q.dtype != torch.float32 else 1
    out = attention_out(q, k, v, out)
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if T == 0:
        return out, lse
    qpos = qpos.to(torch.int32)
    rope = ((*_strides(q_rope, "q_rope", align),
             *_strides(k_rope, "k_rope", align)) if Dr else (0,) * 6)
    strides = (ctypes.c_longlong * 20)(
        *_strides(q, "q", align), *_strides(k, "k", align),
        *_strides(v, "v", align), *_strides(out, "out", align),
        *qpos.stride(), *rope)
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh + Dr)
    window = None if window is None else int(window)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_rope.data_ptr() if Dr else None,
            k_rope.data_ptr() if Dr else None, qpos.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            VARIANTS.index(variant), _DTYPES[q.dtype], B,
            T, S, Hq, Hkv, Dh, Dv, Dr,
            ctypes.addressof(strides),
            float(scale), float(softcap or 0.0), int(window is not None),
            window or 0, torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(
            f"flash_attn_hd ({variant}) could not build a TMA tensor map: "
            + ("the driver has no cuTensorMapEncodeTiled" if err == -1 else
               f"cuTensorMapEncodeTiled returned CUresult {-1000 - err}"))
    if err:
        raise RuntimeError(f"flash_attn_hd ({variant}) launch failed with "
                           f"CUDA error {err}")
    count_launch(flash_attention_cuda, variant)
    report_kernel("flash_attn_hd", lambda: kernel_work.flash_fwd(
        B, T, S, Hq, Hkv, Dh + Dr, Dv, q.element_size(),
        *kernel_work.visible(qpos, S, window), Dr, with_lse))
    return out, lse


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel pair as one differentiable op, the port of the
    reference's ``custom_vjp`` (``jnp_impl.py:202-241``): the forward
    kernel saves ``(o, lse)``, and the backward kernel rebuilds each
    probability from ``lse`` instead of storing any of them.  ``o`` is
    the kernel's output in the operands' type (the reference keeps its
    float32 block output for delta = sum dO * o)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, window, softcap, scale):
        out, lse = _forward(q, k, v, qpos, window, softcap, scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, qpos, out, lse)
        ctx.args = (window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, out, lse = ctx.saved_tensors
        window, softcap, scale = ctx.args
        dq, dk, dv = flash_attention_bwd_cuda(
            dout, q, k, v, out, lse, qpos=qpos, window=window,
            softcap=softcap, scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, qpos: torch.Tensor, window: Optional[int] = None,
                         softcap: float = 0.0,
                         scale: Optional[float] = None,
                         out: Optional[torch.Tensor] = None,
                         q_rope: Optional[torch.Tensor] = None,
                         k_rope: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q (B,T,Hq,Dh); k (B,S,Hkv,Dh); v (B,S,Hkv,Dv); qpos (B,T) absolute
    query positions, -1 for padding (kv position of slot s is s).
    ``q_rope`` (B,T,Hq,Dr) and ``k_rope`` (B,S,1,Dr), given together,
    are more columns of q and of every kv head's k (the logits are
    ``(q.k + q_rope.k_rope) * scale``, ``scale`` by default
    ``1/sqrt(Dh + Dr)``): the ``wgmma`` kernel reads them in place at
    Dh 128, Dr 64, Dv 128; any other split is concatenated first.
    Returns the (B,T,Hq,Dv) result of q's dtype: written into ``out``
    (any strides with a unit-stride last dim, sharing no memory with q,
    k or v; the kernel writes through its strides) or a new tensor.

    :func:`flash_variant` picks the kernel.  Launches are counted in
    ``flash_attention_cuda.launches`` and, by variant, in
    ``flash_attention_cuda.by_variant``, as executions
    (:mod:`repro_torch.kernels.counts`).

    q, k and v share one dtype, float32, bfloat16 or float16, on one
    CUDA device; any strides with a unit-stride last dim (a view of a
    layer's KV cache goes in without a copy; 16-bit rows must start on
    16 bytes).  Dh and Dv are multiples of 8 up to 256.  With grad
    enabled and q, k or v requiring it, the result has a ``grad_fn``
    (:class:`FlashAttentionFunction`; the backward takes every type
    and head dims the forward takes, the RoPE operands joined to q and
    k)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, q_rope, k_rope)):
        if out is not None:
            raise ValueError("flash_attention_cuda takes no out= with grad")
        if check_rope(q, k, q_rope, k_rope):
            q, k = join_rope(q, k, q_rope, k_rope)
        return FlashAttentionFunction.apply(q, k, v, qpos, window, softcap,
                                            scale)
    return _forward(q, k, v, qpos, window, softcap, scale,
                    with_lse=False, out=out, q_rope=q_rope,
                    k_rope=k_rope)[0]


def bwd_scratch(variant: str, B: int, T: int, S: int, Hq: int, Hkv: int,
                D: int, device, Dv: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """The backward kernels' scratch (delta, rows, part), as the C entry
    ``flash_attn_bwd_hd`` documents it: ``ffma`` takes delta (B, Hq, T)
    float32; ``wgmma`` takes per 64-row query
    tile (n = 2 * ceil(T / 128) of them) the rows' lse and delta (B, Hq,
    n, 2, 64) float32, row bounds and tile ranges (B*64n*2 + B*n*4)
    int32; both, with Hq > Hkv, the float32 per-query-head partials of
    dk and dv (2, B, S, Hq, max(D, Dv)) that their last launch sums over
    the group.  ``D`` is q's and k's head dim, ``Dv`` v's (default D)."""
    f32 = dict(dtype=torch.float32, device=device)
    Dp = D if Dv is None else max(D, Dv)
    part = torch.empty((2, B, S, Hq, Dp), **f32) if Hq > Hkv else None
    if variant != "wgmma":
        return torch.empty((B, Hq, T), **f32), None, part
    n = 2 * -(-T // WGMMA_ROWS)
    delta = torch.empty((B, Hq, n, 2, 64), **f32)
    rows = torch.empty(B * 64 * n * 2 + B * n * 4, dtype=torch.int32,
                       device=device)
    return delta, rows, part


def flash_attention_bwd_cuda(dout: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, *,
                             qpos: torch.Tensor,
                             window: Optional[int] = None,
                             softcap: float = 0.0,
                             scale: Optional[float] = None):
    """dq, dk, dv of attention from ``dout`` = dL/d``out``, where
    ``out`` and ``lse`` (B, Hq, T) float32 are the forward kernel's
    output and log-sum-exp on these q, k, v and qpos.  Returns new
    tensors in the operands' dtype: dq (B,T,Hq,Dh), dk (B,S,Hkv,Dh) and
    dv (B,S,Hkv,Dv).

    One call launches the kernels of ``csrc/flash_attn_bwd_hd.cu`` for
    :func:`bwd_variant`'s choice (``wgmma``: five at Dh 64 and 128, four
    at Dh 256 and at 192 / 128, whose dK and dV come from one pass;
    ``ffma``: three) and counts one launch in
    ``flash_attention_bwd_cuda.launches`` (and its variant in
    ``by_variant``).  Takes every type and head dims the forward takes
    (scale by default 1/sqrt(Dh)); operands with any strides whose last
    dim is unit-stride (16-byte rows for 16-bit types).  A launch that
    fails raises; nothing falls back to another variant or to the plain
    version."""
    grads = _bwd(dout, q, k, v, out, lse, qpos, window, softcap, scale)
    if q.shape[1] and k.shape[1]:            # else nothing was launched
        count_launch(flash_attention_bwd_cuda,
                     bwd_variant(q.dtype, q.shape[-1], v.shape[-1]))
        (B, T, Hq, Dh), (S, Hkv), Dv = q.shape, k.shape[1:3], v.shape[3]
        report_kernel("flash_attn_bwd_hd", lambda: kernel_work.flash_bwd(
            B, T, S, Hq, Hkv, Dh, Dv, q.element_size(),
            kernel_work.visible(qpos, S, window)[0]))
    return grads


def flash_attention_bwd_probe(dout: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, *,
                              qpos: torch.Tensor, probe: str,
                              scale: Optional[float] = None) -> None:
    """One uncounted launch of the pre-pass and a probe of the dK/dV pass
    (``probe``, a key of :data:`BWD_PROBES`), or of the parts of the
    function named by a key of :data:`BWD_PARTS`, on the operands of
    :func:`flash_attention_bwd_cuda`, for measurements: bf16 at Dh 192 /
    Dv 128 without a window or softcap.  Not the function: its gradients
    are not returned."""
    _bwd(dout, q, k, v, out, lse, qpos, None, 0.0, scale,
         probe={**BWD_PROBES, **BWD_PARTS}[probe])


def _bwd(dout, q, k, v, out, lse, qpos, window, softcap, scale, probe=0):
    """flash_attention_bwd_cuda's launch, or with ``probe`` the C entry
    flash_attn_bwd_probe_hd's; returns (dq, dk, dv), unwritten under a
    probe."""
    B, T, S, Hq, Hkv, Dh, Dv = _check(q, k, v, qpos)
    variant = bwd_variant(q.dtype, Dh, Dv)
    for name, t, shape in (("out", out, (B, T, Hq, Dv)),
                           ("dout", dout, (B, T, Hq, Dv))):
        if tuple(t.shape) != shape or t.dtype != q.dtype or \
                t.device != q.device:
            raise ValueError(f"{name} must be {shape} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if (tuple(lse.shape) != (B, Hq, T) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous (B, Hq, T) = "
                         f"{(B, Hq, T)} float32 tensor on {q.device}")
    if Hkv > 65535:
        raise ValueError("flash_attention_bwd_cuda grid limit: Hkv up to "
                         "65535")
    if variant == "wgmma" and max(T, S) > 65535 * WGMMA_ROWS:
        raise ValueError(f"flash_attention_bwd_cuda's wgmma variant takes T "
                         f"and S up to {65535 * WGMMA_ROWS}, got {T}, {S}")
    # the kernels write every row; with no query or no key all are 0
    new = torch.empty if T and S else torch.zeros
    kw = dict(dtype=q.dtype, device=q.device)
    dq = new((B, T, Hq, Dh), **kw)
    dk, dv = new((B, S, Hkv, Dh), **kw), new((B, S, Hkv, Dv), **kw)
    if T == 0 or S == 0:
        return dq, dk, dv
    align = 8 if q.dtype != torch.float32 else 1
    delta, rows, part = bwd_scratch(variant, B, T, S, Hq, Hkv, Dh, q.device,
                                    Dv)
    qpos = qpos.to(torch.int32)
    strides = (ctypes.c_longlong * 17)(
        *_strides(q, "q", align), *_strides(k, "k", align),
        *_strides(v, "v", align), *_strides(out, "out", align),
        *_strides(dout, "dout", align), *qpos.stride())
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    window = None if window is None else int(window)
    entry = _entry("flash_attn_bwd_hd", BWD_ARGTYPES) if not probe else \
        _entry("flash_attn_bwd_probe_hd", BWD_PROBE_ARGTYPES,
               "flash_attn_bwd_hd")
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), qpos.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if rows is None else rows.data_ptr(),
            None if part is None else part.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], B, T, S, Hq, Hkv, Dh, Dv,
            ctypes.addressof(strides), float(scale),
            float(softcap or 0.0), int(window is not None), window or 0,
            torch.cuda.current_stream().cuda_stream,
            *([probe] if probe else []))
    if err < 0:
        raise RuntimeError(
            f"flash_attn_bwd_hd ({variant}) could not build a TMA tensor "
            f"map: " + ("the driver has no cuTensorMapEncodeTiled"
                        if err == -1 else f"cuTensorMapEncodeTiled returned "
                        f"CUresult {-1000 - err}"))
    if err:
        raise RuntimeError(f"flash_attn_bwd_hd ({variant}) launch failed "
                           f"with CUDA error {err}")
    return dq, dk, dv


flash_attention_cuda.launches = 0
flash_attention_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.by_variant = dict.fromkeys(BWD_VARIANTS, 0)
