"""Model assembly: init / forward / prefill / decode, the decoder
families of the reference's ``repro/models/lm.py``: dense (global,
local or gemma2's alternating attention) and moe.

Structure notes:
  * layers are a Python list of per-layer parameter dicts, run in a
    Python loop (the reference stacks them and runs ``lax.scan``);
  * the per-layer window comes from ``_window_array`` as in the
    reference: gemma2's even layers get its local window, its odd
    layers ``BIG_WINDOW`` (global);
  * a moe layer's feed-forward is ``models/moe.py``; the stack sums
    each layer's load-balance aux loss, which ``forward`` returns;
  * caches are dicts of ``(L, B, T_max, Hkv, Dh)`` tensors plus the
    per-slot ``pos``, updated in place by prefill and decode;
  * ``forward`` and ``forward_fused`` (the train paths) run each layer
    under ``torch.utils.checkpoint`` while grad is enabled, the
    reference's ``remat=True`` (its ``jax.checkpoint`` of the scanned
    layer): a layer's activations are recomputed in the backward, so
    only each layer's input is kept;
  * ``init(seed, dtype)`` stores the matrices in ``dtype``, the compute
    dtype by default (serving's bf16 weights); training passes
    float32 for the reference's float32 masters, which every use
    casts to the compute dtype.

``build(cfg, compute_dtype, device)`` returns a ModelBundle of closures
and raises ``NotImplementedError`` for the families not ported yet.
Every entry point runs on ``device``, which defaults to "cuda" and
raises without a card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as LY
from . import moe as MOE
from .common import (fused_cross_entropy, gated_mlp, resolve_device,
                     rms_norm, softcap)

Params = Dict[str, Any]
BIG_WINDOW = 1 << 30   # "global attention" as a window


class ModelBundle(NamedTuple):
    cfg: Any
    init: Callable        # (seed or torch.Generator[, dtype]) -> params
    forward: Callable     # (params, batch) -> (logits, aux)
    prefill: Callable     # (params, batch, cache) -> (logits_last, cache)
    decode: Callable      # (params, batch, cache) -> (logits, cache)
    init_cache: Callable  # (B, T_max[, device]) -> cache
    device: torch.device
    # the fused head+CE train path (never materializes B,S,V logits)
    forward_fused: Optional[Callable] = None  # (params, batch) -> (loss, metrics)


# ======================================================================
# shared embedding / head
# ======================================================================
def _embed_params(gen, cfg, dtype, device) -> Params:
    return {
        "in_emb": LY._normal(gen, (cfg.vocab, cfg.d_model), 0.01, dtype,
                             device),
        "out_emb": LY._normal(gen, (cfg.d_model, cfg.vocab),
                              1 / math.sqrt(cfg.d_model), dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=device),
    }


def _embed(p, tokens, cfg, dt) -> torch.Tensor:
    x = p["in_emb"][tokens].to(dt)
    if cfg.name.startswith(("gemma", "recurrentgemma")):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def _head(p, x, cfg) -> torch.Tensor:
    h = rms_norm(x, p["final_norm"])
    logits = h @ p["out_emb"].to(x.dtype)
    return softcap(logits.float(), cfg.final_softcap or None)


# ======================================================================
# dense / gemma2 / moe decoder stack
# ======================================================================
def _window_array(cfg) -> List[int]:
    """Per-layer attention window; BIG_WINDOW = global."""
    L = cfg.n_layers
    if cfg.attn_kind == "local":
        return [cfg.window] * L
    if cfg.attn_kind == "alternating":
        return [cfg.window if i % 2 == 0 else BIG_WINDOW for i in range(L)]
    return [BIG_WINDOW] * L


def _dense_stack_params(gen, cfg, n_layers, dtype, device) -> List[Params]:
    names = ["pre_attn", "pre_mlp"] + (["post_attn", "post_mlp"]
                                       if cfg.post_norms else [])
    kw = dict(dtype=dtype, device=device)
    return [{"attn": LY.attn_params(gen, cfg, **kw),
             "norms": LY.norms_params(cfg.d_model, names, device=device),
             "ffn": (MOE.moe_params(gen, cfg.d_model, cfg.moe, **kw)
                     if cfg.moe is not None else
                     LY.mlp_params(gen, cfg.d_model, cfg.d_ff, **kw))}
            for _ in range(n_layers)]


def _dense_block(cfg, pl, x, window, cache_sl):
    """One decoder layer.  Returns (x, new_cache, aux): aux is the moe
    layer's load-balance loss, None for a dense layer and on the cache
    paths (prefill and decode drop it)."""
    aux = None
    h = rms_norm(x, pl["norms"]["pre_attn"])
    a, new_c = LY.attention(pl["attn"], h, cfg=cfg, window=window,
                            cache=cache_sl, attn_softcap=cfg.attn_softcap,
                            rope_base=cfg.rope_base)
    if cfg.post_norms:
        a = rms_norm(a, pl["norms"]["post_attn"])
    x = x + a
    h = rms_norm(x, pl["norms"]["pre_mlp"])
    if cfg.moe is not None:
        f, aux = MOE.moe_ffn(pl["ffn"], h, cfg.moe, aux=cache_sl is None)
    else:
        f = gated_mlp(h, pl["ffn"]["w_gate"].to(x.dtype),
                      pl["ffn"]["w_up"].to(x.dtype),
                      pl["ffn"]["w_down"].to(x.dtype), act=cfg.act)
    if cfg.post_norms:
        f = rms_norm(f, pl["norms"]["post_mlp"])
    return x + f, new_c, aux


def _remat_block(cfg, pl, x, window):
    """One layer without a cache, for ``torch.utils.checkpoint``:
    (x, aux)."""
    x, _, aux = _dense_block(cfg, pl, x, window, None)
    return x, aux


def _run_stack(cfg, stack_p, x, windows, cache, remat: bool = False):
    """The layer loop over one group.  cache: None or dict(k, v, pos)
    with (L, ...) k and v; returns (x, aux, cache): aux summed over the
    layers, the cache's pos advanced by T.  ``remat`` (no cache, grad
    enabled): each layer under ``torch.utils.checkpoint``."""
    pos = None if cache is None else cache["pos"]
    remat = remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (pl, w) in enumerate(zip(stack_p, windows)):
        if remat:
            # no layer draws random numbers: no RNG state to replay
            x, a = checkpoint(_remat_block, cfg, pl, x, w,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            csl = None if cache is None else {
                "k": cache["k"][i], "v": cache["v"][i], "pos": pos}
            x, _, a = _dense_block(cfg, pl, x, w, csl)
        if a is not None:
            aux = aux + a
    if cache is not None:
        cache["pos"] = pos + x.shape[1]
    return x, aux, cache


def _build_decoder_lm(cfg, dt, dev) -> ModelBundle:
    """The dense or moe decoder: embedding, one stack, head."""
    windows = _window_array(cfg)

    def init(seed=0, dtype=None) -> Params:
        """Matrices in ``dtype`` (default the compute dtype); norm
        scales float32."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt = dt if dtype is None else dtype
        return {"emb": _embed_params(gen, cfg, pdt, dev),
                "main": _dense_stack_params(gen, cfg, cfg.n_layers, pdt,
                                            dev)}

    def forward(params, batch):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x, aux, _ = _run_stack(cfg, params["main"], x, windows, None,
                               remat=True)
        return _head(params["emb"], x, cfg), {"aux_loss": aux}

    def forward_fused(params, batch):
        """Train path with the head+CE fused over sequence chunks."""
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x, aux, _ = _run_stack(cfg, params["main"], x, windows, None,
                               remat=True)
        emb = params["emb"]
        loss = fused_cross_entropy(x, emb["final_norm"], emb["out_emb"],
                                   batch["labels"], batch.get("mask"),
                                   cfg.final_softcap)
        return loss, {"ce": loss, "aux": aux}

    def init_cache(B, T_max, device=None):
        """``device`` defaults to the model's ("meta" probes shapes)."""
        on = dev if device is None else device
        return {"main": {**LY.init_full_cache(cfg, cfg.n_layers, B, T_max,
                                              device=on),
                         "pos": torch.zeros((B,), dtype=torch.int32,
                                            device=on)}}

    def prefill(params, batch, cache):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x, _, cache["main"] = _run_stack(cfg, params["main"], x, windows,
                                         cache["main"])
        return _head(params["emb"], x[:, -1:, :], cfg), cache

    def decode(params, batch, cache):
        x = _embed(params["emb"], batch["token"], cfg, dt)
        # decode positions come from the batch (ragged serving)
        cache["main"]["pos"] = batch["pos"]
        x, _, cache["main"] = _run_stack(cfg, params["main"], x, windows,
                                         cache["main"])
        return _head(params["emb"], x, cfg), cache

    return ModelBundle(cfg, init, forward, prefill, decode, init_cache, dev,
                       forward_fused)


# ======================================================================
# dispatcher
# ======================================================================
_NOT_PORTED = ("is not ported yet (ROADMAP: 'Still to port', the other "
               "model families)")


def build(cfg, compute_dtype=torch.bfloat16, device="cuda") -> ModelBundle:
    """The model of ``cfg`` in ``compute_dtype`` on ``device``.  Ported:
    the dense decoder with global, local or alternating attention
    (yi-9b, deepseek-7b, mistral-large-123b, gemma2-9b) and the moe
    decoder without MLA, leading dense layers or MTP
    (qwen3-moe-30b-a3b)."""
    dev = resolve_device(device)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name} ({cfg.family}) {_NOT_PORTED}")
    if cfg.mla is not None or cfg.dense_layers > 0 or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}'s MLA attention, leading dense layers and MTP head "
            f"are not ported yet (ROADMAP: 'Still to port', the other model "
            f"families: mla, with deepseek-v3)")
    return _build_decoder_lm(cfg, compute_dtype, dev)
