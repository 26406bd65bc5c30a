"""Transformer building blocks with cache support: the attention part
of the reference's ``repro/models/layers.py``, with the full cache,
the sliding-window ring cache and cross-attention.

Conventions:
  * params are plain dicts of tensors, one dict per layer (the
    reference stacks them with a leading ``L`` for ``lax.scan``);
  * every attention works in three modes: forward (no cache), prefill
    (build cache), decode (read + update cache, q_len == 1);
  * per-sequence positions ``pos: (B,)`` (ragged serving); the cache
    is updated in place (the reference's update is functional).

Initialisation draws from a ``torch.Generator`` with the reference's
scales; the numbers differ from ``jax.random``'s, so the tests carry
the reference's own weights across (``models/convert.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .common import (as_dtensor, batch_update, gqa_attention,
                     make_causal_mask, make_local_mask, resolve_device, rope)
from repro_torch.kernels.flash_attention import flash_attention

# From this many query positions on, the dense O(T·S) logit tensor is
# replaced by flash attention (kernels/flash_attention): on the card
# the hand-written kernel, on the CPU the reference's choice of plain
# version.
FLASH_MIN_T = 1024

Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------------
# parameter init helpers
# ----------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """Standard normal times ``scale``, drawn in float32 and stored in
    ``dtype``, one tensor at a time so the float32 draw of the largest
    matrix is the only temporary."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def attn_params(gen, cfg, *, dtype=torch.float32, device="cuda") -> Params:
    """One layer's GQA attention weights (the reference's ``attn_params``
    for one of its ``L`` stacked layers)."""
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=resolve_device(device))
    return {
        "wq": _normal(gen, (D, Hq * Dh), 1 / math.sqrt(D), **kw),
        "wk": _normal(gen, (D, Hkv * Dh), 1 / math.sqrt(D), **kw),
        "wv": _normal(gen, (D, Hkv * Dh), 1 / math.sqrt(D), **kw),
        "wo": _normal(gen, (Hq * Dh, D), 1 / math.sqrt(Hq * Dh), **kw),
    }


def mlp_params(gen, d_model: int, d_ff: int, *, dtype=torch.float32,
               device="cuda") -> Params:
    kw = dict(dtype=dtype, device=resolve_device(device))
    return {
        "w_gate": _normal(gen, (d_model, d_ff), 1 / math.sqrt(d_model), **kw),
        "w_up": _normal(gen, (d_model, d_ff), 1 / math.sqrt(d_model), **kw),
        "w_down": _normal(gen, (d_ff, d_model), 1 / math.sqrt(d_ff), **kw),
    }


# The logical axes of each leaf above, the reference's specs
# (``repro/models/layers.py:53-80``) without their leading "layers" axis:
# the port's layers are a list, one dict a layer
ATTN_SPECS = {"wq": ("embed", "qheads"), "wk": ("embed", "kvheads"),
              "wv": ("embed", "kvheads"), "wo": ("qheads", "embed")}
MLP_SPECS = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
             "w_down": ("mlp", "embed")}


def norms_specs(names) -> Dict[str, Tuple[str, ...]]:
    return {n: ("embed",) for n in names}


def norms_params(d_model: int, names, *, device="cuda") -> Params:
    """rms scales, zero-initialised (the norm multiplies by 1 + w) and
    kept in float32, as ``rms_norm`` reads them."""
    device = resolve_device(device)
    return {n: torch.zeros((d_model,), dtype=torch.float32, device=device)
            for n in names}


# ----------------------------------------------------------------------
# attention (one layer)
# ----------------------------------------------------------------------
def _update_ring(cache_kv: torch.Tensor, kpos: torch.Tensor,
                 new_kv: torch.Tensor, new_pos: torch.Tensor):
    """Sliding-window ring cache of width W, written in place: new
    (B, t, H, Dh) goes to slots (new_pos + i) % W, and kpos (B, W) takes
    the absolute positions (-1 = empty slot).  A t > W writes only the
    last W tokens, the ones that survive, so no slot is written twice
    and the result does not depend on the order of a scatter.  A
    DTensor cache (the dry-run's) is written shard by shard, as
    ``batch_update`` writes one.  Returns (cache_kv, kpos)."""
    from torch.distributed.tensor import DTensor
    if isinstance(cache_kv, DTensor):
        return _sharded_update_ring(cache_kv, kpos, new_kv, new_pos)
    W = cache_kv.shape[1]
    t = new_kv.shape[1]
    t0 = max(0, t - W)
    p = new_pos.long()[:, None] + torch.arange(t0, t, device=cache_kv.device)
    idx = p % W
    bidx = torch.arange(cache_kv.shape[0], device=cache_kv.device)[:, None]
    cache_kv[bidx, idx] = new_kv[:, t0:].to(cache_kv.dtype)
    kpos[bidx, idx] = p.to(kpos.dtype)
    return cache_kv, kpos


def _sharded_update_ring(cache_kv, kpos, new_kv, new_pos):
    """:func:`_update_ring` of a DTensor ring, each rank writing its own
    rows: ``new_kv`` takes the cache's placements, ``new_pos`` its batch
    dim's, which ``kpos`` must have already; then each shard is written
    in place."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_kv.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in cache_kv.placements]
    kpos = as_dtensor(kpos, mesh)
    if list(kpos.placements) != rows:
        raise ValueError(f"ring positions placed {kpos.placements}, the "
                         f"cache's rows {rows}")
    new_kv = as_dtensor(new_kv, mesh).redistribute(mesh, cache_kv.placements)
    new_pos = as_dtensor(new_pos, mesh).redistribute(mesh, rows)
    _update_ring(cache_kv.to_local(), kpos.to_local(), new_kv.to_local(),
                 new_pos.to_local())
    return cache_kv, kpos


def attention(p: Params, x: torch.Tensor, *, cfg, window=None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              attn_softcap: float = 0.0, rope_base: float = 10000.0
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One GQA attention layer.

    ``window``: sliding-window size (an int; the decoder stacks pass a
    huge one for global attention) or None.  cache: None (forward),
    dict(k, v, pos) -- this layer's (B, T_max, Hkv, Dh) cache views and
    the per-sequence write offset (B,) -- or dict(k, v, kpos, pos), a
    ring of (B, W, Hkv, Dh) with W = ``cfg.window`` and the absolute
    position of each slot (B, W).  Returns (out, new_cache), where
    new_cache holds the same k, v (and kpos) tensors, written in place.
    """
    B, T, D = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = x.dtype
    q = (x @ p["wq"].to(cdt)).reshape(B, T, Hq, Dh)
    k = (x @ p["wk"].to(cdt)).reshape(B, T, Hkv, Dh)
    v = (x @ p["wv"].to(cdt)).reshape(B, T, Hkv, Dh)

    if cache is None:
        positions = torch.arange(T, device=x.device)[None, :]
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
        if T >= FLASH_MIN_T:
            qpos = positions.expand(B, T).to(torch.int32)
            out = flash_attention(q, k, v, qpos=qpos, window=window,
                                  softcap=attn_softcap or 0.0)
        else:
            mask = (make_causal_mask(T, T, 0, x.device) if window is None
                    else make_local_mask(T, T, 0, window, x.device))
            out = gqa_attention(q, k, v, mask, attn_softcap)
        new_cache = None
    else:
        pos = cache["pos"]                       # (B,)
        positions = pos[:, None] + torch.arange(T, device=x.device)[None, :]
        q = rope(q, positions, rope_base)
        k = rope(k, positions, rope_base)
        if "kpos" in cache:                      # ring (sliding window)
            ck, kp = _update_ring(cache["k"], cache["kpos"], k, pos)
            cv, _ = _update_ring(cache["v"], cache["kpos"], v, pos)
            if T > 1:
                # windowed prefill over THIS call's tokens, as the
                # reference: the ring's slots are overwritten T/W times
                # in a long prefill, so they cannot serve early queries.
                # Exact for a prefill from 0
                out = flash_attention(q, k, v, qpos=positions.to(torch.int32),
                                      window=int(cfg.window),
                                      softcap=attn_softcap or 0.0)
            else:
                # decode: the ring slots holding positions (qpos-W, qpos]
                qpos = positions                 # (B, T)
                valid = (kp[:, None, :] <= qpos[:, :, None]) & \
                        (kp[:, None, :] > qpos[:, :, None] - cfg.window) & \
                        (kp[:, None, :] >= 0)
                out = gqa_attention(q, ck.to(cdt), cv.to(cdt), valid,
                                    attn_softcap)
            new_cache = {"k": ck, "v": cv, "kpos": kp, "pos": pos + T}
        else:                                    # full cache
            ck = batch_update(cache["k"], k, pos)
            cv = batch_update(cache["v"], v, pos)
            Tmax = ck.shape[1]
            if T >= FLASH_MIN_T:
                # a bf16 cache in a bf16 model goes in as the cache's view
                out = flash_attention(q, ck.to(cdt), cv.to(cdt),
                                      qpos=positions.to(torch.int32),
                                      window=window,
                                      softcap=attn_softcap or 0.0)
            else:
                kpos = torch.arange(Tmax, device=x.device)[None, :]
                qpos = positions
                valid = kpos[:, None, :] <= qpos[:, :, None]
                if window is not None:
                    valid &= kpos[:, None, :] > qpos[:, :, None] - window
                out = gqa_attention(q, ck.to(cdt), cv.to(cdt), valid,
                                    attn_softcap)
            new_cache = {"k": ck, "v": cv, "pos": pos + T}
    out = out.reshape(B, T, Hq * Dh) @ p["wo"].to(cdt)
    return out, new_cache


def cross_attention(p: Params, x: torch.Tensor, kv_src: torch.Tensor, *,
                    cfg) -> torch.Tensor:
    """Cross-attention: q from x (B, T, D), k and v projected from a
    source (B, S_kv, D_src) in x's dtype with ``Hq`` heads (not
    ``Hkv``), every key visible, then ``wo``.  whisper's encoder calls
    it with the source x itself; whisper's decoder and llama-vision
    project their source once at prefill, cache it and call
    ``attend_source``."""
    B = x.shape[0]
    Hq, Dh = cfg.n_heads, cfg.head_dim
    cdt = x.dtype
    k = (kv_src @ p["wk"].to(cdt)).reshape(B, -1, Hq, Dh)
    v = (kv_src @ p["wv"].to(cdt)).reshape(B, -1, Hq, Dh)
    return attend_source(p, x, k, v, cfg=cfg)


def attend_source(p: Params, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, cfg) -> torch.Tensor:
    """The rest of ``cross_attention`` once the source's k and v
    (B, S_kv, Hq, Dh) are projected: q from x, every key visible,
    then ``wo``."""
    B, T, D = x.shape
    Hq, Dh = cfg.n_heads, cfg.head_dim
    cdt = x.dtype
    q = (x @ p["wq"].to(cdt)).reshape(B, T, Hq, Dh)
    mask = torch.ones((T, k.shape[1]), dtype=torch.bool, device=x.device)
    out = gqa_attention(q, k.to(cdt), v.to(cdt), mask)
    return out.reshape(B, T, Hq * Dh) @ p["wo"].to(cdt)


def cross_attn_params(gen, cfg, d_src: int, *, dtype=torch.float32,
                      device="cuda") -> Params:
    """One layer's cross-attention weights (the reference's
    ``cross_attn_params`` for one of its ``L`` stacked layers): k and v
    project the source's ``d_src`` to ``Hq`` heads."""
    D, Hq, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=resolve_device(device))
    return {
        "wq": _normal(gen, (D, Hq * Dh), 1 / math.sqrt(D), **kw),
        "wk": _normal(gen, (d_src, Hq * Dh), 1 / math.sqrt(d_src), **kw),
        "wv": _normal(gen, (d_src, Hq * Dh), 1 / math.sqrt(d_src), **kw),
        "wo": _normal(gen, (Hq * Dh, D), 1 / math.sqrt(Hq * Dh), **kw),
    }


# the reference's ``cross_attn_params`` specs (``layers.py:213-216``)
CROSS_SPECS = {"wq": ("embed", "qheads"), "wk": ("vision", "qheads"),
               "wv": ("vision", "qheads"), "wo": ("qheads", "embed")}


def init_full_cache(cfg, n_layers: int, B: int, T_max: int,
                    dtype=torch.bfloat16, device="cuda"):
    """bfloat16 by default whatever the compute dtype, as the
    reference's: an f32 model rounds K and V to bf16 in the cache."""
    device = resolve_device(device)
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, B, T_max, Hkv, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ring_cache(cfg, n_layers: int, B: int, dtype=torch.bfloat16,
                    device="cuda"):
    """The sliding-window ring of ``cfg.window`` slots a layer; every
    slot starts empty (``kpos`` -1)."""
    device = resolve_device(device)
    W, Hkv, Dh = cfg.window, cfg.n_kv_heads, cfg.head_dim
    shape = (n_layers, B, W, Hkv, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kpos": torch.full((n_layers, B, W), -1, dtype=torch.int32,
                               device=device)}
