"""Launch wrapper of the hand-written flash-attention kernels
(``repro_torch/csrc/flash_attn_hd.cu``), the port of the reference's
``flash_attention_pallas``.  The library builds on the first launch.

The source holds three variants; :func:`flash_variant` picks one from
the dtype and head dims alone, and the wrapper launches it or raises:

* ``"wgmma"``: bf16 and fp16 with ``Dh == Dv`` in {64, 128}, every
  serving prefill (warp-specialised, TMA-fed wgmma);
* ``"mma_sync"``: the other bf16 and fp16 head dims;
* ``"ffma"``: float32 (IEEE FFMA, no TF32).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counts import count_launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VARIANTS = ("ffma", "mma_sync", "wgmma")     # the source's variant codes
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_ROWS = 128                             # query rows per wgmma block
_INT32_MAX = 2 ** 31 - 1


def flash_variant(dtype: torch.dtype, Dh: int, Dv: int) -> str:
    """The kernel variant that computes attention for these operand
    types and head dims."""
    if dtype == torch.float32:
        return "ffma"
    if Dh == Dv and Dh in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync"


# flash_attn_hd's C parameters, in order
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p]


def _entry():
    fn = build.load("flash_attn_hd").flash_attn_hd
    fn.argtypes = ARGTYPES
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, qpos: torch.Tensor, window: Optional[int] = None,
                         softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B,T,Hq,Dh); k (B,S,Hkv,Dh); v (B,S,Hkv,Dv); qpos (B,T) absolute
    query positions, -1 for padding (kv position of slot s is s).
    Returns a new (B,T,Hq,Dv) tensor of q's dtype.

    :func:`flash_variant` picks the kernel.  Launches are counted in
    ``flash_attention_cuda.launches`` and, by variant, in
    ``flash_attention_cuda.by_variant``, as executions
    (:mod:`repro_torch.kernels.counts`).

    q, k and v share one dtype, float32, bfloat16 or float16, on one
    CUDA device; any strides with a unit-stride last dim (a view of a
    layer's KV cache goes in without a copy; 16-bit rows must start on
    16 bytes).  Dh and Dv are multiples of 8 up to 256."""
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
    for name, d in (("Dh", Dh), ("Dv", Dv)):
        if not (0 < d <= 256 and d % 8 == 0):
            raise ValueError(f"flash_attention_cuda takes head dims that "
                             f"are multiples of 8 up to 256, got {name}={d}")
    if tuple(qpos.shape) != (B, T):
        raise ValueError(f"qpos {tuple(qpos.shape)} is not (B, T) = {(B, T)}")
    if max(B, Hq) > 65535 or max(T, S) > _INT32_MAX:
        raise ValueError("flash_attention_cuda grid limits: B and Hq up to "
                         "65535, T and S under 2**31")
    variant = flash_variant(q.dtype, Dh, Dv)
    if variant == "wgmma" and -(-T // WGMMA_ROWS) > 65535:
        raise ValueError(f"flash_attention_cuda's wgmma variant takes T up "
                         f"to {65535 * WGMMA_ROWS}, got {T}")
    align = 8 if q.dtype != torch.float32 else 1
    out = torch.empty((B, T, Hq, Dv), dtype=q.dtype, device=q.device)
    if T == 0:
        return out
    qpos = qpos.to(torch.int32)
    strides = (ctypes.c_longlong * 14)(
        *_strides(q, "q", align), *_strides(k, "k", align),
        *_strides(v, "v", align), *_strides(out, "out", align),
        *qpos.stride())
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    window = None if window is None else int(window)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
            out.data_ptr(), VARIANTS.index(variant), _DTYPES[q.dtype], B,
            T, S, Hq, Hkv, Dh, Dv,
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
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
