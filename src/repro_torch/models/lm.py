"""Model assembly: init / forward / prefill / decode, the decoder
families of the reference's ``repro/models/lm.py``: dense (global,
local or gemma2's alternating attention), moe (deepseek-v3's MLA
attention, leading dense layers and MTP head among them) and vlm
(llama-3.2-vision: the dense stack in super-blocks, each with one
cross-attention to image embeddings).  ``build`` also dispatches the
hybrid family (recurrentgemma) and the ssm family's xLSTM to
``models/hybrid.py``, and the audio family (whisper) to
``models/encdec.py``.

Structure notes:
  * layers are a Python list of per-layer parameter dicts, run in a
    Python loop (the reference stacks them and runs ``lax.scan``);
  * the per-layer window comes from ``_window_array`` as in the
    reference: gemma2's even layers get its local window, its odd
    layers ``BIG_WINDOW`` (global);
  * a moe layer's feed-forward is ``models/moe.py``; the stack sums
    each layer's load-balance aux loss, which ``forward`` returns.  A
    moe config's ``dense_layers`` leading layers (deepseek-v3's 3) and
    its MTP block have a plain ``d_ff`` feed-forward instead: each
    stack says whether its layers are moe (``is_moe``), as the
    reference's ``_scan_stack`` does;
  * with ``cfg.mla`` every layer's attention is ``models/mla.py``;
  * caches are dicts of ``(L, B, T_max, Hkv, Dh)`` tensors (MLA: the
    latent ``ckv`` (L, B, T_max, kv_lora + d_rope)) plus the per-slot
    ``pos``, one dict per group (``"dense"`` and ``"main"``), updated
    in place by prefill and decode;
  * the MTP head (``cfg.mtp``) joins each position's normed hidden
    state with the embedding of the next token (``torch.roll``, which
    wraps as ``jnp.roll``), projects the pair with ``mtp_proj``, runs
    one dense block and the shared head: ``forward``'s
    ``out["mtp_logits"]``, ``forward_fused``'s ``metrics["mtp"]``;
  * ``forward`` and ``forward_fused`` (the train paths) run each layer
    under ``torch.utils.checkpoint`` while grad is enabled, the
    reference's ``remat=True`` (its ``jax.checkpoint`` of the scanned
    layer): a layer's activations are recomputed in the backward, so
    only each layer's input is kept;
  * ``init(seed, dtype)`` stores the matrices in ``dtype``, the compute
    dtype by default (serving's bf16 weights); training passes
    float32 for the reference's float32 masters, which every use
    casts to the compute dtype;
  * ``specs()`` gives every leaf's logical axes in a tree parallel to
    ``init``'s params: the reference's spec tree (its ``init`` returns
    ``(params, specs)``) with each layer's leaves in a list and without
    the leading "layers" axis, which the sharding rules never map.

The vlm family's cache is the reference's ``{"kv": {"k", "v"}, "pos",
"img_k", "img_v"}``: K and V (n_sb, SB, B, T_max, Hkv, Dh), the image
K/V (n_sb, B, n_image_tokens, Hq, Dh), all bf16.  Its prefill attends
with the image K/V in the compute dtype and stores them rounded to
bf16; decode reads the bf16 copies, as the reference's.

``build(cfg, compute_dtype, device)`` returns a ModelBundle of closures
for every registered architecture.  Every entry point runs on
``device``, which defaults to "cuda" and raises without a card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as LY
from . import mla as MLA
from . import moe as MOE
from .common import (fused_cross_entropy, gated_mlp, gather_rows,
                     resolve_device, rms_norm, roll, softcap)

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
    # () -> the logical axes of every leaf, a tree parallel to init's
    # params (train/sharding.py maps them to mesh axes)
    specs: Optional[Callable] = None


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


EMBED_SPECS = {"in_emb": ("vocab", "embed"),
               # the head's contracting dim: never FSDP-sharded
               "out_emb": ("embed_head", "vocab"),
               "final_norm": ("embed",)}


def _embed(p, tokens, cfg, dt) -> torch.Tensor:
    x = gather_rows(p["in_emb"], tokens).to(dt)
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
    """``n_layers`` layers: MLA or GQA attention, norms, and a moe
    feed-forward where ``cfg.moe`` is set (the leading dense layers and
    the MTP block pass a cfg without it)."""
    names = ["pre_attn", "pre_mlp"] + (["post_attn", "post_mlp"]
                                       if cfg.post_norms else [])
    kw = dict(dtype=dtype, device=device)
    attn = MLA.mla_params if cfg.mla is not None else LY.attn_params
    return [{"attn": attn(gen, cfg, **kw),
             "norms": LY.norms_params(cfg.d_model, names, device=device),
             "ffn": (MOE.moe_params(gen, cfg.d_model, cfg.moe, **kw)
                     if cfg.moe is not None else
                     LY.mlp_params(gen, cfg.d_model, cfg.d_ff, **kw))}
            for _ in range(n_layers)]


def _dense_stack_specs(cfg, n_layers) -> List[Dict[str, Any]]:
    """The logical axes of :func:`_dense_stack_params`'s layers."""
    names = ["pre_attn", "pre_mlp"] + (["post_attn", "post_mlp"]
                                       if cfg.post_norms else [])
    one = {"attn": MLA.MLA_SPECS if cfg.mla is not None else LY.ATTN_SPECS,
           "norms": LY.norms_specs(names),
           "ffn": (MOE.moe_specs(cfg.moe) if cfg.moe is not None
                   else LY.MLP_SPECS)}
    return [one] * n_layers


def _dense_block(cfg, pl, x, window, cache_sl, is_moe=False):
    """One decoder layer, its feed-forward moe with ``is_moe``.  Returns
    (x, new_cache, aux): aux is the moe layer's load-balance loss, None
    for a dense layer and on the cache paths (prefill and decode drop
    it)."""
    aux = None
    h = rms_norm(x, pl["norms"]["pre_attn"])
    if cfg.mla is not None:
        a, new_c = MLA.mla_attention(pl["attn"], h, cfg, cache=cache_sl,
                                     rope_base=cfg.rope_base)
    else:
        a, new_c = LY.attention(pl["attn"], h, cfg=cfg, window=window,
                                cache=cache_sl, attn_softcap=cfg.attn_softcap,
                                rope_base=cfg.rope_base)
    if cfg.post_norms:
        a = rms_norm(a, pl["norms"]["post_attn"])
    x = x + a
    h = rms_norm(x, pl["norms"]["pre_mlp"])
    if is_moe:
        f, aux = MOE.moe_ffn(pl["ffn"], h, cfg.moe, aux=cache_sl is None)
    else:
        f = gated_mlp(h, pl["ffn"]["w_gate"].to(x.dtype),
                      pl["ffn"]["w_up"].to(x.dtype),
                      pl["ffn"]["w_down"].to(x.dtype), act=cfg.act)
    if cfg.post_norms:
        f = rms_norm(f, pl["norms"]["post_mlp"])
    return x + f, new_c, aux


def _remat_block(cfg, pl, x, window, is_moe):
    """One layer without a cache, for ``torch.utils.checkpoint``:
    (x, aux)."""
    x, _, aux = _dense_block(cfg, pl, x, window, None, is_moe)
    return x, aux


def _run_stack(cfg, stack_p, x, windows, cache, remat: bool = False,
               is_moe: bool = False):
    """The layer loop over one group.  cache: None or a dict of (L, ...)
    leaves (k and v, or MLA's ckv) and pos; returns (x, aux, cache): aux
    summed over the layers, the cache's pos advanced by T.  ``remat``
    (no cache, grad enabled): each layer under
    ``torch.utils.checkpoint``."""
    pos = None if cache is None else cache["pos"]
    remat = remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (pl, w) in enumerate(zip(stack_p, windows)):
        if remat:
            # no layer draws random numbers: no RNG state to replay
            x, a = checkpoint(_remat_block, cfg, pl, x, w, is_moe,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            csl = None if cache is None else {
                **{n: c[i] for n, c in cache.items() if n != "pos"},
                "pos": pos}
            x, _, a = _dense_block(cfg, pl, x, w, csl, is_moe)
        if a is not None:
            aux = aux + a
    if cache is not None:
        cache["pos"] = pos + x.shape[1]
    return x, aux, cache


def _build_decoder_lm(cfg, dt, dev) -> ModelBundle:
    """The dense or moe decoder: embedding, a moe config's
    ``dense_layers`` leading layers (MLA attention where the config has
    it, a plain ``d_ff`` feed-forward), the main stack, head, and the
    MTP head where ``cfg.mtp``."""
    n_dense = cfg.dense_layers if cfg.moe is not None else 0
    n_main = cfg.n_layers - n_dense
    windows = _window_array(cfg)
    main_moe = cfg.moe is not None

    def init(seed=0, dtype=None) -> Params:
        """Matrices in ``dtype`` (default the compute dtype); norm
        scales float32."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt = dt if dtype is None else dtype
        dcfg = dataclasses.replace(cfg, moe=None)
        p = {"emb": _embed_params(gen, cfg, pdt, dev)}
        if n_dense:
            p["dense"] = _dense_stack_params(gen, dcfg, n_dense, pdt, dev)
        p["main"] = _dense_stack_params(gen, cfg, n_main, pdt, dev)
        if cfg.mtp:
            p["mtp"] = _dense_stack_params(gen, dcfg, 1, pdt, dev)
            p["mtp_proj"] = LY._normal(
                gen, (2 * cfg.d_model, cfg.d_model),
                1 / math.sqrt(2 * cfg.d_model), pdt, dev)
        return p

    def specs():
        dcfg = dataclasses.replace(cfg, moe=None)
        s = {"emb": EMBED_SPECS}
        if n_dense:
            s["dense"] = _dense_stack_specs(dcfg, n_dense)
        s["main"] = _dense_stack_specs(cfg, n_main)
        if cfg.mtp:
            s["mtp"] = _dense_stack_specs(dcfg, 1)
            s["mtp_proj"] = ("embed2", "embed")
        return s

    def _run(params, x, cache, remat=False):
        """The leading dense layers, then the main stack; with a cache,
        each group's rows written and its pos advanced."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if n_dense:
            x, a, _ = _run_stack(cfg, params["dense"], x, windows[:n_dense],
                                 None if cache is None else cache["dense"],
                                 remat)
            aux = aux + a
        x, a, _ = _run_stack(cfg, params["main"], x, windows[n_dense:],
                             None if cache is None else cache["main"],
                             remat, is_moe=main_moe)
        return x, aux + a

    def _mtp_hidden(params, x, tokens):
        """The MTP block's output: position t's normed hidden state
        beside the embedding of token t + 1 (wrapping), projected, one
        dense block (no remat, as the reference's)."""
        emb = params["emb"]
        e2 = _embed(emb, roll(tokens, -1, 1), cfg, dt)
        h2 = torch.cat([rms_norm(x, emb["final_norm"]), e2], -1) \
            @ params["mtp_proj"].to(dt)
        h2, _, _ = _run_stack(cfg, params["mtp"], h2, windows[:1], None)
        return h2

    def forward(params, batch):
        tokens = batch["tokens"]
        x = _embed(params["emb"], tokens, cfg, dt)
        x, aux = _run(params, x, None, remat=True)
        out = {"aux_loss": aux}
        if cfg.mtp:
            out["mtp_logits"] = _head(params["emb"],
                                      _mtp_hidden(params, x, tokens), cfg)
        return _head(params["emb"], x, cfg), out

    def forward_fused(params, batch):
        """Train path with the head+CE fused over sequence chunks."""
        tokens, mask = batch["tokens"], batch.get("mask")
        x = _embed(params["emb"], tokens, cfg, dt)
        x, aux = _run(params, x, None, remat=True)
        emb = params["emb"]
        loss = fused_cross_entropy(x, emb["final_norm"], emb["out_emb"],
                                   batch["labels"], mask, cfg.final_softcap)
        metrics = {"ce": loss}
        if cfg.mtp:
            metrics["mtp"] = fused_cross_entropy(
                _mtp_hidden(params, x, tokens), emb["final_norm"],
                emb["out_emb"], roll(batch["labels"], -1, 1), mask,
                cfg.final_softcap)
        metrics["aux"] = aux
        return loss, metrics

    def init_cache(B, T_max, device=None):
        """``device`` defaults to the model's ("meta" probes shapes)."""
        on = dev if device is None else device
        mk = MLA.init_mla_cache if cfg.mla is not None else \
            LY.init_full_cache
        groups = ({"dense": n_dense} if n_dense else {}) | {"main": n_main}
        return {g: {**mk(cfg, n, B, T_max, device=on),
                    "pos": torch.zeros((B,), dtype=torch.int32, device=on)}
                for g, n in groups.items()}

    def prefill(params, batch, cache):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x, _ = _run(params, x, cache)
        return _head(params["emb"], x[:, -1:, :], cfg), cache

    def decode(params, batch, cache):
        x = _embed(params["emb"], batch["token"], cfg, dt)
        # decode positions come from the batch (ragged serving)
        for g in cache.values():
            g["pos"] = batch["pos"]
        x, _ = _run(params, x, cache)
        return _head(params["emb"], x, cfg), cache

    return ModelBundle(cfg, init, forward, prefill, decode, init_cache, dev,
                       forward_fused, specs)


# ======================================================================
# vlm: llama-3.2-vision (a cross-attention after the next-to-last block
# of every super-block of ``cross_every`` blocks)
# ======================================================================
def _build_vlm(cfg, dt, dev) -> ModelBundle:
    """The decoder stack in super-blocks of ``SB = cross_every`` blocks,
    each followed, after its block ``SB - 2``, by a cross-attention to
    the image embeddings projected once a super-block (``Hq`` heads,
    every image token visible)."""
    V = cfg.vision
    SB = V.cross_every                     # super-block size
    n_sb = cfg.n_layers // SB
    windows = _window_array(cfg)
    Hq, Dh = cfg.n_heads, cfg.head_dim

    def init(seed=0, dtype=None) -> Params:
        """Matrices in ``dtype`` (default the compute dtype); norm
        scales float32."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt = dt if dtype is None else dtype
        return {"emb": _embed_params(gen, cfg, pdt, dev),
                "main": _dense_stack_params(gen, cfg, cfg.n_layers, pdt, dev),
                "cross": [LY.cross_attn_params(gen, cfg, V.d_vision,
                                               dtype=pdt, device=dev)
                          for _ in range(n_sb)],
                "cross_norm": [LY.norms_params(cfg.d_model, ["pre_cross"],
                                               device=dev)
                               for _ in range(n_sb)]}

    def specs():
        return {"emb": EMBED_SPECS,
                "main": _dense_stack_specs(cfg, cfg.n_layers),
                "cross": [LY.CROSS_SPECS] * n_sb,
                "cross_norm": [LY.norms_specs(["pre_cross"])] * n_sb}

    def _img_kv(params, image_embeds):
        """Each super-block's image K and V (B, S_img, Hq, Dh), projected
        once from the image embeddings (a numpy array from the Engine,
        or a tensor)."""
        ie = torch.as_tensor(image_embeds, device=dev).to(dt)
        B = ie.shape[0]
        return [((ie @ cp["wk"].to(dt)).reshape(B, -1, Hq, Dh),
                 (ie @ cp["wv"].to(dt)).reshape(B, -1, Hq, Dh))
                for cp in params["cross"]]

    def _super_block(params, sb, x, kc, vc, cache, pos):
        """Super-block ``sb``; with a cache, its layers' rows written in
        place."""
        for i in range(SB):
            j = sb * SB + i
            csl = None if cache is None else {
                "k": cache["kv"]["k"][sb, i], "v": cache["kv"]["v"][sb, i],
                "pos": pos}
            x, _, _ = _dense_block(cfg, params["main"][j], x, windows[j],
                                   csl)
            if i == SB - 2:
                h = rms_norm(x, params["cross_norm"][sb]["pre_cross"])
                x = x + LY.attend_source(params["cross"][sb], h, kc, vc,
                                         cfg=cfg)
        return x

    def _run(params, x, kv, cache, pos):
        """Every super-block in order; without a cache, each under
        ``torch.utils.checkpoint`` while grad is enabled (the
        reference's ``remat=True`` of its scanned super-block)."""
        remat = cache is None and torch.is_grad_enabled()
        for sb, (kc, vc) in enumerate(kv):
            args = (params, sb, x, kc, vc, cache, pos)
            if remat:
                # no layer draws random numbers: no RNG state to replay
                x = checkpoint(_super_block, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _super_block(*args)
        return x

    def forward(params, batch):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        kv = _img_kv(params, batch["image_embeds"])
        x = _run(params, x, kv, None, None)
        return _head(params["emb"], x, cfg), {
            "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}

    def init_cache(B, T_max, device=None):
        """``device`` defaults to the model's ("meta" probes shapes)."""
        on = dev if device is None else device
        full = LY.init_full_cache(cfg, cfg.n_layers, B, T_max, device=on)
        shape = (n_sb, B, V.n_image_tokens, Hq, Dh)
        return {"kv": {n: a.reshape(n_sb, SB, *a.shape[1:])
                       for n, a in full.items()},
                "pos": torch.zeros((B,), dtype=torch.int32, device=on),
                "img_k": torch.zeros(shape, dtype=torch.bfloat16, device=on),
                "img_v": torch.zeros(shape, dtype=torch.bfloat16, device=on)}

    def prefill(params, batch, cache):
        """Attends with the image K/V in the compute dtype, then stores
        them rounded to bf16, as the reference does."""
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        kv = _img_kv(params, batch["image_embeds"])
        pos = cache["pos"]
        x = _run(params, x, kv, cache, pos)
        for sb, (kc, vc) in enumerate(kv):
            cache["img_k"][sb].copy_(kc)
            cache["img_v"][sb].copy_(vc)
        cache["pos"] = pos + x.shape[1]
        return _head(params["emb"], x[:, -1:, :], cfg), cache

    def decode(params, batch, cache):
        x = _embed(params["emb"], batch["token"], cfg, dt)
        # decode positions come from the batch (ragged serving)
        pos = batch["pos"]
        x = _run(params, x, zip(cache["img_k"], cache["img_v"]), cache, pos)
        cache["pos"] = pos + 1
        return _head(params["emb"], x, cfg), cache

    return ModelBundle(cfg, init, forward, prefill, decode, init_cache, dev,
                       specs=specs)


# ======================================================================
# dispatcher
# ======================================================================
def build(cfg, compute_dtype=torch.bfloat16, device="cuda") -> ModelBundle:
    """The model of ``cfg`` in ``compute_dtype`` on ``device``, for
    every registered architecture: the dense decoder with global, local
    or alternating attention (yi-9b, deepseek-7b, mistral-large-123b,
    gemma2-9b), the moe decoder (qwen3-moe-30b-a3b; deepseek-v3-671b
    with MLA, leading dense layers and the MTP head), the vision
    decoder (llama-3.2-vision-11b), the encoder-decoder (whisper-base),
    the RG-LRU hybrid (recurrentgemma-2b) and the xLSTM LM
    (xlstm-125m).  Dispatched on ``cfg.family`` as the reference's."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return _build_decoder_lm(cfg, compute_dtype, dev)
    if cfg.family == "vlm":
        return _build_vlm(cfg, compute_dtype, dev)
    if cfg.family == "hybrid":
        from .hybrid import build_recurrentgemma
        return build_recurrentgemma(cfg, compute_dtype, dev)
    if cfg.family == "ssm":
        from .hybrid import build_xlstm_lm
        return build_xlstm_lm(cfg, compute_dtype, dev)
    if cfg.family == "audio":
        from .encdec import build_whisper
        return build_whisper(cfg, compute_dtype, dev)
    raise ValueError(cfg.family)
