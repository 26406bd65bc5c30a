"""The whisper-style encoder-decoder (audio family) of the reference's
``repro/models/encdec.py``.

The conv frontend is a stub, as in the reference: the inputs are
frame embeddings (B, n_frames, d_model).  The encoder is a
bidirectional self-attention stack with sinusoidal positions and a
final norm; the decoder is causal self-attention (RoPE on top of the
sinusoidal embedding, as the reference's ``LY.attention`` call applies
it) plus cross-attention to the encoder's output, each block with a
plain ``w1``/``w2`` tanh-gelu MLP.

Structure notes:
  * params are ``{"emb", "enc": {"attn", "mlp", "norms", "final_norm"},
    "dec": {"attn", "cross", "mlp", "norms"}}`` as in the reference,
    each layer group a Python list of per-layer dicts (the reference
    stacks them with a leading ``L``);
  * the cache is the reference's flat dict: the decoder's self-attention
    ``k``/``v`` (n_dec, B, T_max, Hkv, Dh) and ``pos`` (B,), and the
    cross K/V ``cross_k``/``cross_v`` (n_dec, B, n_frames, Hq, Dh),
    all bf16.  Prefill attends with the cross K/V in the compute dtype
    and stores them rounded to bf16; decode reads the bf16 copies, so a
    float32 model sees unrounded cross K/V in prefill and rounded ones
    in decode, as the reference's does.  Prefill and decode update the
    cache in place (the reference's steps are functional);
  * prefill adds the sinusoid from position 0 whatever the cache's
    ``pos``, as the reference does; decode adds the rows at
    ``batch["pos"]``, computed alone with the same float32 formula (the
    reference indexes a table of 65,536 rows built every step);
  * the encoder's self-attention (``layers.cross_attention`` with x as
    its own source) and the decoder's attention to the encoder's output
    (``layers.attend_source``) are dense ``gqa_attention``, outside any
    kernel, as in the reference; the decoder's self-attention reaches
    flash attention from ``FLASH_MIN_T`` query positions on
    (``layers.attention``);
  * ``forward`` runs each layer under ``torch.utils.checkpoint`` while
    grad is enabled, the reference's ``remat=True``.

Extra inputs (``batch["frames"]``) may be numpy arrays, as the slot
``Engine`` passes them; they move to the model's device.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import layers as LY
from .common import rms_norm
from .lm import (EMBED_SPECS, ModelBundle, Params, _embed,
                 _embed_params, _head)


def _sinusoid(positions: torch.Tensor, D: int, dtype) -> torch.Tensor:
    """The sinusoidal embedding of ``positions`` (...,): (..., D) in
    ``dtype``, computed in float32 (the reference's ``_sinusoid`` rows
    at those positions)."""
    pos = positions.float()[..., None]
    i = torch.arange(D // 2, dtype=torch.float32, device=positions.device)
    ang = pos / torch.pow(10000.0, 2 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _plain_mlp_params(gen, d_model: int, d_ff: int, *, dtype,
                      device) -> Params:
    return {"w1": LY._normal(gen, (d_model, d_ff), 1 / math.sqrt(d_model),
                             dtype, device),
            "w2": LY._normal(gen, (d_ff, d_model), 1 / math.sqrt(d_ff),
                             dtype, device)}


# the reference's ``_plain_mlp_params`` specs (``encdec.py:35``)
PLAIN_MLP_SPECS = {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")}


def _plain_mlp(p: Params, h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh form."""
    dt = h.dtype
    return F.gelu(h @ p["w1"].to(dt), approximate="tanh") @ p["w2"].to(dt)


def build_whisper(cfg, dt, dev) -> ModelBundle:
    E = cfg.encdec
    n_enc, n_dec = E.n_enc_layers, cfg.n_layers
    Hq, Dh = cfg.n_heads, cfg.head_dim

    def init(seed=0, dtype=None) -> Params:
        """Matrices in ``dtype`` (default the compute dtype); norm
        scales float32."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt = dt if dtype is None else dtype
        kw = dict(dtype=pdt, device=dev)
        D = cfg.d_model
        return {
            "emb": _embed_params(gen, cfg, pdt, dev),
            "enc": {
                "attn": [LY.attn_params(gen, cfg, **kw) for _ in range(n_enc)],
                "mlp": [_plain_mlp_params(gen, D, cfg.d_ff, **kw)
                        for _ in range(n_enc)],
                "norms": [LY.norms_params(D, ["pre_attn", "pre_mlp"],
                                          device=dev) for _ in range(n_enc)],
                "final_norm": torch.zeros((D,), dtype=torch.float32,
                                          device=dev)},
            "dec": {
                "attn": [LY.attn_params(gen, cfg, **kw) for _ in range(n_dec)],
                "cross": [LY.cross_attn_params(gen, cfg, D, **kw)
                          for _ in range(n_dec)],
                "mlp": [_plain_mlp_params(gen, D, cfg.d_ff, **kw)
                        for _ in range(n_dec)],
                "norms": [LY.norms_params(D, ["pre_attn", "pre_cross",
                                              "pre_mlp"], device=dev)
                          for _ in range(n_dec)]}}

    def specs():
        return {"emb": EMBED_SPECS,
                "enc": {"attn": [LY.ATTN_SPECS] * n_enc,
                        "mlp": [PLAIN_MLP_SPECS] * n_enc,
                        "norms": [LY.norms_specs(["pre_attn", "pre_mlp"])]
                        * n_enc,
                        "final_norm": ("embed",)},
                "dec": {"attn": [LY.ATTN_SPECS] * n_dec,
                        "cross": [LY.CROSS_SPECS] * n_dec,
                        "mlp": [PLAIN_MLP_SPECS] * n_dec,
                        "norms": [LY.norms_specs(["pre_attn", "pre_cross",
                                                  "pre_mlp"])] * n_dec}}

    def _layers(fn, params, n, x, remat, *args):
        """``fn(params, i, x, *args)`` for i < n; under
        ``torch.utils.checkpoint`` with ``remat`` while grad is on."""
        remat = remat and torch.is_grad_enabled()
        for i in range(n):
            if remat:
                # no layer draws random numbers: no RNG state to replay
                x = checkpoint(fn, params, i, x, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = fn(params, i, x, *args)
        return x

    # -- encoder ---------------------------------------------------------
    def _enc_layer(params, i, x):
        """Bidirectional self-attention: q, k and v from the same
        normed x with ``Hq`` heads, every frame visible."""
        pe = params["enc"]
        nm = pe["norms"][i]
        h = rms_norm(x, nm["pre_attn"])
        x = x + LY.cross_attention(pe["attn"][i], h, h, cfg=cfg)
        return x + _plain_mlp(pe["mlp"][i], rms_norm(x, nm["pre_mlp"]))

    def encode(params, frames, remat=False):
        """The encoder's output for ``frames`` (a numpy array from the
        Engine, or a tensor)."""
        frames = torch.as_tensor(frames, device=dev)
        T = frames.shape[1]
        x = frames.to(dt) + _sinusoid(
            torch.arange(T, device=frames.device), cfg.d_model, dt)[None]
        x = _layers(_enc_layer, params, n_enc, x, remat)
        return rms_norm(x, params["enc"]["final_norm"])

    def _cross_kv(params, enc_out):
        """Every decoder layer's cross K/V (n_dec, B, S, Hq, Dh) from
        the encoder's output."""
        B, S, _ = enc_out.shape
        cross = params["dec"]["cross"]
        k = torch.stack([enc_out @ c["wk"].to(dt) for c in cross])
        v = torch.stack([enc_out @ c["wv"].to(dt) for c in cross])
        return (k.reshape(n_dec, B, S, Hq, Dh),
                v.reshape(n_dec, B, S, Hq, Dh))

    # -- decoder ---------------------------------------------------------
    def _dec_layer(params, i, x, cross_k, cross_v, cache, pos):
        pd = params["dec"]
        nm = pd["norms"][i]
        h = rms_norm(x, nm["pre_attn"])
        csl = None if cache is None else {
            "k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        o, _ = LY.attention(pd["attn"][i], h, cfg=cfg, window=None,
                            cache=csl, rope_base=cfg.rope_base)
        x = x + o
        # cross-attention to the encoder's output
        h = rms_norm(x, nm["pre_cross"])
        x = x + LY.attend_source(pd["cross"][i], h, cross_k[i], cross_v[i],
                                 cfg=cfg)
        return x + _plain_mlp(pd["mlp"][i], rms_norm(x, nm["pre_mlp"]))

    def _dec_input(params, tokens, pos=None):
        """Token embeddings plus the sinusoid at ``pos`` (B,) (decode),
        or from position 0 (forward, and prefill whatever the cache's
        ``pos``, as the reference)."""
        x = _embed(params["emb"], tokens, cfg, dt)
        positions = (torch.arange(tokens.shape[1], device=dev)[None]
                     if pos is None else pos[:, None])
        return x + _sinusoid(positions, cfg.d_model, dt)

    # -- public fns -------------------------------------------------------
    def forward(params, batch):
        enc_out = encode(params, batch["frames"], remat=True)
        ck, cv = _cross_kv(params, enc_out)
        x = _dec_input(params, batch["tokens"])
        x = _layers(_dec_layer, params, n_dec, x, True, ck, cv, None, None)
        return _head(params["emb"], x, cfg), {
            "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}

    def init_cache(B, T_max, device=None) -> Dict[str, torch.Tensor]:
        """``device`` defaults to the model's ("meta" probes shapes)."""
        on = dev if device is None else device
        shape = (n_dec, B, E.n_frames, Hq, Dh)
        return {**LY.init_full_cache(cfg, n_dec, B, T_max, device=on),
                "cross_k": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=on),
                "cross_v": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=on),
                "pos": torch.zeros((B,), dtype=torch.int32, device=on)}

    def prefill(params, batch, cache):
        enc_out = encode(params, batch["frames"])
        ck, cv = _cross_kv(params, enc_out)
        x = _dec_input(params, batch["tokens"])
        pos = cache["pos"]
        x = _layers(_dec_layer, params, n_dec, x, False, ck, cv, cache, pos)
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
        cache["pos"] = pos + x.shape[1]
        return _head(params["emb"], x[:, -1:, :], cfg), cache

    def decode(params, batch, cache):
        pos = batch["pos"]
        x = _dec_input(params, batch["token"], pos)
        x = _layers(_dec_layer, params, n_dec, x, False, cache["cross_k"],
                    cache["cross_v"], cache, pos)
        cache["pos"] = pos + 1
        return _head(params["emb"], x, cfg), cache

    return ModelBundle(cfg, init, forward, prefill, decode, init_cache, dev,
                       specs=specs)
