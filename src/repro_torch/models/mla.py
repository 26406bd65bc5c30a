"""Multi-head Latent Attention (deepseek-v3, arXiv:2412.19437): the port
of the reference's ``repro/models/mla.py``, per layer (the reference
stacks the layers with a leading ``L``).

Queries go through a low-rank bottleneck (``q_lora``); keys and values
through a compressed latent ``c_kv`` (``kv_lora``) plus one small RoPE
key shared by every head.  The cache stores only ``[c_kv, rope(k_rope)]``,
``kv_lora + d_rope`` values a token, in bf16.

``mla_attention`` takes the reference's two forms, chosen as the
reference chooses them (``mla.py:106-143``):

  * the naive form at ``T >= FLASH_MIN_T`` (train and long prefill):
    K and V of every head expanded from the latent with ``wk_b`` and
    ``wv_b``, then flash attention with ``Dh = d_nope + d_rope`` and
    ``Dv = d_v`` (192 and 128 at full width), the RoPE parts of q and
    of the shared key passed as ``q_rope`` and ``k_rope`` (one head)
    instead of concatenated: on the card the flash kernel's ``wgmma``
    variant reads them in place (a reduced width's split is
    concatenated by the wrapper), on the CPU its plain dispatch
    concatenates them as the reference does;
  * the absorbed form at ``T < FLASH_MIN_T`` and every decode step:
    ``wk_b`` folded into q, scores against the latent and the RoPE key,
    a float32 softmax under the ``-1e30`` mask, attention over the
    latent, then ``wv_b``.  Dense products in PyTorch, as the
    reference's einsums.

The cache path writes the chunk's rows in place, then reads every row
back from the bf16 cache in the compute dtype, as the reference's
``sharded_batch_update`` + ``.astype(cdt)`` do: a float32 prefill
attends to bf16-rounded rows of its own chunk.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .common import (batch_update, make_causal_mask, resolve_device,
                     rms_norm, rope)
from .layers import FLASH_MIN_T, _normal
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, torch.Tensor]


def mla_params(gen, cfg, *, dtype=torch.float32, device="cuda") -> Params:
    """One layer's MLA weights with the reference's scales; the norm
    scales ``q_norm`` and ``kv_norm`` zero-initialised and float32, as
    ``rms_norm`` reads them."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    return {
        "wq_a": _normal(gen, (D, m.q_lora), 1 / math.sqrt(D), **kw),
        "wq_b": _normal(gen, (m.q_lora, H * (m.d_nope + m.d_rope)),
                        1 / math.sqrt(m.q_lora), **kw),
        "wkv_a": _normal(gen, (D, m.kv_lora + m.d_rope), 1 / math.sqrt(D),
                         **kw),
        "wk_b": _normal(gen, (m.kv_lora, H * m.d_nope),
                        1 / math.sqrt(m.kv_lora), **kw),
        "wv_b": _normal(gen, (m.kv_lora, H * m.d_v), 1 / math.sqrt(m.kv_lora),
                        **kw),
        "wo": _normal(gen, (H * m.d_v, D), 1 / math.sqrt(H * m.d_v), **kw),
        "q_norm": torch.zeros((m.q_lora,), dtype=torch.float32, device=dev),
        "kv_norm": torch.zeros((m.kv_lora,), dtype=torch.float32, device=dev),
    }


# the reference's specs (``repro/models/mla.py:42-51``) without "layers"
MLA_SPECS = {"wq_a": ("embed", "lora"), "wq_b": ("lora", "qheads"),
             "wkv_a": ("embed", "lora"), "wk_b": ("lora", "qheads"),
             "wv_b": ("lora", "qheads"), "wo": ("qheads", "embed"),
             "q_norm": ("lora",), "kv_norm": ("lora",)}


def _split_q(q: torch.Tensor, H: int, m) -> Tuple[torch.Tensor, torch.Tensor]:
    qn, qr = q[..., :H * m.d_nope], q[..., H * m.d_nope:]
    return (qn.reshape(*q.shape[:-1], H, m.d_nope),
            qr.reshape(*q.shape[:-1], H, m.d_rope))


def mla_attention(p: Params, x: torch.Tensor, cfg, *,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  rope_base: float = 10000.0, naive: Optional[bool] = None):
    """Returns (out, new_cache).  cache: None (a full-sequence forward)
    or dict(ckv, pos): this layer's (B, T_max, kv_lora + d_rope) cache
    view and the per-sequence write offset (B,); new_cache holds the
    same ckv tensor, written in place, and pos + T.  ``naive`` picks the
    form; None picks it as the reference does, the naive form from
    ``FLASH_MIN_T`` query positions on."""
    m, H = cfg.mla, cfg.n_heads
    B, T, D = x.shape
    cdt = x.dtype
    q = rms_norm(x @ p["wq_a"].to(cdt), p["q_norm"]) @ p["wq_b"].to(cdt)
    q_nope, q_rope = _split_q(q, H, m)                 # (B,T,H,dn), (B,T,H,dr)
    kv = x @ p["wkv_a"].to(cdt)                        # (B,T,kv_lora+dr)
    c_kv = rms_norm(kv[..., :m.kv_lora], p["kv_norm"])
    k_rope = kv[..., m.kv_lora:]

    if cache is None:
        positions = torch.arange(T, device=x.device)[None, :]
        q_rope = rope(q_rope, positions, rope_base)
        ckv_all = c_kv
        kr_all = rope(k_rope[..., None, :], positions, rope_base)[..., 0, :]
        valid = make_causal_mask(T, T, 0, x.device)[None]      # (1,T,S)
        new_cache = None
    else:
        pos = cache["pos"]
        positions = pos[:, None] + torch.arange(T, device=x.device)[None, :]
        q_rope = rope(q_rope, positions, rope_base)
        k_rope_r = rope(k_rope[..., None, :], positions, rope_base)[..., 0, :]
        ckv_full = batch_update(cache["ckv"],
                                torch.cat([c_kv, k_rope_r], -1), pos)
        # every row, this chunk's too, as the cache holds it
        ckv_all = ckv_full[..., :m.kv_lora].to(cdt)
        kr_all = ckv_full[..., m.kv_lora:].to(cdt)
        kpos = torch.arange(ckv_full.shape[1], device=x.device)
        valid = kpos[None, None, :] <= positions[:, :, None]   # (B,T,S)
        new_cache = {"ckv": ckv_full, "pos": pos + T}

    scale = 1.0 / math.sqrt(m.d_nope + m.d_rope)
    S = ckv_all.shape[1]
    wk_b = p["wk_b"].to(cdt)
    wv_b = p["wv_b"].to(cdt)
    if naive is None:
        naive = T >= FLASH_MIN_T
    if naive:
        # naive form: K and V of every head from the latent, then flash
        # attention at Dh = d_nope + d_rope, Dv = d_v, the RoPE parts
        # passed beside q and K (the shared RoPE key as one head), not
        # concatenated to them
        k_nope = (ckv_all @ wk_b).reshape(B, S, H, m.d_nope)
        v_full = (ckv_all @ wv_b).reshape(B, S, H, m.d_v)
        o = flash_attention(q_nope, k_nope, v_full, q_rope=q_rope,
                            k_rope=kr_all[:, :, None, :],
                            qpos=positions.expand(B, T).to(torch.int32),
                            window=None, scale=scale)
    else:
        # absorbed form: wk_b folded into q, attention over the latent
        q_abs = torch.einsum("bthd,chd->bthc", q_nope,
                             wk_b.reshape(m.kv_lora, H, m.d_nope))
        s_nope = torch.einsum("bthc,bsc->bhts", q_abs, ckv_all)
        s_rope = torch.einsum("bthr,bsr->bhts", q_rope, kr_all)
        logits = (s_nope + s_rope).float() * scale
        logits = torch.where(valid[:, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(cdt)
        o_lat = torch.einsum("bhts,bsc->bthc", probs, ckv_all)
        o = torch.einsum("bthc,chv->bthv", o_lat,
                         wv_b.reshape(m.kv_lora, H, m.d_v))
    out = o.reshape(B, T, H * m.d_v) @ p["wo"].to(cdt)
    return out, new_cache


def init_mla_cache(cfg, n_layers: int, B: int, T_max: int,
                   dtype=torch.bfloat16, device="cuda"):
    """``{"ckv": (n_layers, B, T_max, kv_lora + d_rope)}``, bfloat16
    whatever the compute dtype, as the reference's."""
    m = cfg.mla
    return {"ckv": torch.zeros((n_layers, B, T_max, m.kv_lora + m.d_rope),
                               dtype=dtype, device=resolve_device(device))}
