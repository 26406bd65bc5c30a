"""The recurrent hybrids of the reference's ``repro/models/hybrid.py``:
RecurrentGemma (``build_recurrentgemma``), RG-LRU blocks and local
attention in super-blocks of (rec, rec, attn) and a tail of rec layers
(26 layers: 18 recurrent, 8 attention), and the xLSTM LM
(``build_xlstm_lm``), mLSTM blocks with every ``slstm_every``-th block
an sLSTM (12 layers: 10 mLSTM, 2 sLSTM at layers 5 and 11).

Structure notes:
  * params are ``{"emb", "rec", "attn", "mlp", "norms"}`` as in the
    reference, each layer group a Python list of per-layer dicts (the
    reference stacks them with a leading ``L``); ``_rec_at``,
    ``_attn_at`` and ``_mlp_at`` index them as the reference does;
  * the cache is the reference's flat dict of ``rec_h`` (n_rec, B, W)
    float32, ``rec_conv`` (n_rec, B, cw-1, W), the attention layers'
    ring ``att_k``/``att_v`` (n_attn, B, window, Hkv, Dh) and
    ``att_kpos``, and ``pos`` (B,).  Its size does not depend on
    ``T_max``.  Prefill and decode update it in place (the reference's
    steps are functional): the recurrent state and the conv tail are
    copied into their rows, the ring written by ``_update_ring``;
  * ``forward`` and ``forward_fused`` run each layer under
    ``torch.utils.checkpoint`` while grad is enabled, the reference's
    ``remat=True``; on the card their gradients come from the RG-LRU
    scan's and flash attention's backward kernels.

The xLSTM LM's params are ``{"emb", "mlstm", "slstm", "norms"}``, each a
list of per-layer dicts; its cache is the reference's ``{"m": {C, n,
m}, "s": {c, n, h, m}, "pos"}`` (mLSTM state (n_m, B, H, Dh, Dh),
(n_m, B, H, Dh), (n_m, B, H); sLSTM state (n_s, B, D) each; all
float32), whose size does not depend on ``T_max``.  Prefill and decode
update it in place.  It trains as recurrentgemma does, each layer under
``torch.utils.checkpoint``; on the card the sLSTM layers' gradient comes
from the recurrence's backward kernel, the mLSTM's from autograd.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as LY
from . import rglru as RG
from . import xlstm as XL
from .common import fused_cross_entropy, gated_mlp, rms_norm
from .lm import (EMBED_SPECS, ModelBundle, Params, _embed,
                 _embed_params, _head)


def build_recurrentgemma(cfg, dt, dev) -> ModelBundle:
    pat = cfg.rg.pattern                       # 2 rec per attn
    n_sb = cfg.n_layers // (pat + 1)           # full (rec, rec, attn) blocks
    n_tail = cfg.n_layers - n_sb * (pat + 1)   # trailing rec blocks
    n_rec = n_sb * pat + n_tail
    n_attn = n_sb

    def init(seed=0, dtype=None) -> Params:
        """Matrices in ``dtype`` (default the compute dtype); norm
        scales, ``lam`` and the recurrent biases float32."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt = dt if dtype is None else dtype
        kw = dict(dtype=pdt, device=dev)
        return {
            "emb": _embed_params(gen, cfg, pdt, dev),
            "rec": [RG.rglru_params(gen, cfg, **kw) for _ in range(n_rec)],
            "attn": [LY.attn_params(gen, cfg, **kw) for _ in range(n_attn)],
            "mlp": [LY.mlp_params(gen, cfg.d_model, cfg.d_ff, **kw)
                    for _ in range(cfg.n_layers)],
            "norms": [LY.norms_params(cfg.d_model, ["pre_mix", "pre_mlp"],
                                      device=dev)
                      for _ in range(cfg.n_layers)]}

    def specs():
        return {"emb": EMBED_SPECS, "rec": [RG.RGLRU_SPECS] * n_rec,
                "attn": [LY.ATTN_SPECS] * n_attn,
                "mlp": [LY.MLP_SPECS] * cfg.n_layers,
                "norms": [LY.norms_specs(["pre_mix", "pre_mlp"])]
                * cfg.n_layers}

    def _mlp_at(params, j, x):
        pl, nm = params["mlp"][j], params["norms"][j]
        h = rms_norm(x, nm["pre_mlp"])
        return x + gated_mlp(h, pl["w_gate"].to(dt), pl["w_up"].to(dt),
                             pl["w_down"].to(dt), act=cfg.act)

    def _rec_at(params, r, j, x, cache):
        """Recurrent block r (global layer j); its state in ``cache``'s
        rows r, updated in place."""
        h = rms_norm(x, params["norms"][j]["pre_mix"])
        csl = None
        if cache is not None:
            csl = {"h": cache["rec_h"][r], "conv": cache["rec_conv"][r]}
        o, new_c = RG.rglru_block(params["rec"][r], h, cfg, cache=csl)
        if cache is not None:
            csl["h"].copy_(new_c["h"])
            csl["conv"].copy_(new_c["conv"])
        return _mlp_at(params, j, x + o)

    def _attn_at(params, a, j, x, cache, pos):
        h = rms_norm(x, params["norms"][j]["pre_mix"])
        csl = None
        if cache is not None:
            csl = {"k": cache["att_k"][a], "v": cache["att_v"][a],
                   "kpos": cache["att_kpos"][a], "pos": pos}
        o, _ = LY.attention(params["attn"][a], h, cfg=cfg, window=cfg.window,
                            cache=csl, rope_base=cfg.rope_base)
        return _mlp_at(params, j, x + o)

    def _run(params, x, cache, pos):
        """All layers in order; with a cache, its rows updated in place.
        Without one, each layer runs under ``torch.utils.checkpoint``
        while grad is enabled."""
        remat = cache is None and torch.is_grad_enabled()
        r = a = 0
        for j in range(cfg.n_layers):
            if j % (pat + 1) < pat or j >= n_sb * (pat + 1):
                fn, args = _rec_at, (r, j, x, cache)
                r += 1
            else:
                fn, args = _attn_at, (a, j, x, cache, pos)
                a += 1
            if remat:
                # no layer draws random numbers: no RNG state to replay
                x = checkpoint(fn, params, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = fn(params, *args)
        return x

    def forward(params, batch):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x = _run(params, x, None, None)
        return _head(params["emb"], x, cfg), {
            "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}

    def forward_fused(params, batch):
        """Train path with the head+CE fused over sequence chunks."""
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x = _run(params, x, None, None)
        emb = params["emb"]
        loss = fused_cross_entropy(x, emb["final_norm"], emb["out_emb"],
                                   batch["labels"], batch.get("mask"),
                                   cfg.final_softcap)
        return loss, {"ce": loss}

    def init_cache(B, T_max, device=None) -> Dict[str, torch.Tensor]:
        """``device`` defaults to the model's ("meta" probes shapes).
        The state is O(width) plus the ring: ``T_max`` is unused."""
        del T_max
        on = dev if device is None else device
        rc = RG.init_rglru_cache(cfg, n_rec, B, device=on)
        ring = LY.init_ring_cache(cfg, n_attn, B, device=on)
        return {"rec_h": rc["h"], "rec_conv": rc["conv"],
                "att_k": ring["k"], "att_v": ring["v"],
                "att_kpos": ring["kpos"],
                "pos": torch.zeros((B,), dtype=torch.int32, device=on)}

    def prefill(params, batch, cache):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        pos = cache["pos"]
        x = _run(params, x, cache, pos)
        cache["pos"] = pos + x.shape[1]
        return _head(params["emb"], x[:, -1:, :], cfg), cache

    def decode(params, batch, cache):
        x = _embed(params["emb"], batch["token"], cfg, dt)
        # decode positions come from the batch (ragged serving)
        pos = batch["pos"]
        x = _run(params, x, cache, pos)
        cache["pos"] = pos + 1
        return _head(params["emb"], x, cfg), cache

    return ModelBundle(cfg, init, forward, prefill, decode, init_cache, dev,
                       forward_fused, specs)


# ======================================================================
# xLSTM LM: (slstm_every - 1 mLSTM, 1 sLSTM) repeating
# ======================================================================
def build_xlstm_lm(cfg, dt, dev) -> ModelBundle:
    ev = cfg.xlstm.slstm_every
    n_s = cfg.n_layers // ev
    n_m = cfg.n_layers - n_s

    def init(seed=0, dtype=None) -> Params:
        """Matrices in ``dtype`` (default the compute dtype); ``r_in``,
        the biases and the norm scales float32."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt = dt if dtype is None else dtype
        kw = dict(dtype=pdt, device=dev)
        return {
            "emb": _embed_params(gen, cfg, pdt, dev),
            "mlstm": [XL.mlstm_params(gen, cfg, **kw) for _ in range(n_m)],
            "slstm": [XL.slstm_params(gen, cfg, **kw)
                      for _ in range(max(n_s, 1))],
            "norms": [LY.norms_params(cfg.d_model, ["pre"], device=dev)
                      for _ in range(cfg.n_layers)]}

    def specs():
        return {"emb": EMBED_SPECS, "mlstm": [XL.MLSTM_SPECS] * n_m,
                "slstm": [XL.SLSTM_SPECS] * max(n_s, 1),
                "norms": [LY.norms_specs(["pre"])] * cfg.n_layers}

    def _block(params, kind, i, j, x, cache):
        """Block i of ``kind`` ("m" or "s"; global layer j) with its
        pre-norm and residual; its state in ``cache``'s rows i, updated
        in place."""
        h = rms_norm(x, params["norms"][j]["pre"])
        csl = None if cache is None else \
            {k: v[i] for k, v in cache[kind].items()}
        if kind == "s":
            o, _ = XL.slstm_block(params["slstm"][i], h, cfg, cache=csl)
        else:
            o, new_c = XL.mlstm_block(params["mlstm"][i], h, cfg, cache=csl)
            if csl is not None:
                for k, v in new_c.items():
                    csl[k].copy_(v)
        return x + o

    def _run(params, x, cache):
        """All layers in order; with a cache, its rows updated in place.
        Without one, each layer runs under ``torch.utils.checkpoint``
        while grad is enabled."""
        remat = cache is None and torch.is_grad_enabled()
        mi = si = 0
        for j in range(cfg.n_layers):
            if (j + 1) % ev == 0:
                args = ("s", si, j, x, cache)
                si += 1
            else:
                args = ("m", mi, j, x, cache)
                mi += 1
            if remat:
                # no layer draws random numbers: no RNG state to replay
                x = checkpoint(_block, params, *args, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _block(params, *args)
        return x

    def forward(params, batch):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x = _run(params, x, None)
        return _head(params["emb"], x, cfg), {
            "aux_loss": torch.zeros((), dtype=torch.float32, device=x.device)}

    def forward_fused(params, batch):
        """Train path with the head+CE fused over sequence chunks."""
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x = _run(params, x, None)
        emb = params["emb"]
        loss = fused_cross_entropy(x, emb["final_norm"], emb["out_emb"],
                                   batch["labels"], batch.get("mask"),
                                   cfg.final_softcap)
        return loss, {"ce": loss}

    def init_cache(B, T_max, device=None) -> Dict[str, torch.Tensor]:
        """``device`` defaults to the model's ("meta" probes shapes).
        The state is O(width): ``T_max`` is unused."""
        del T_max
        on = dev if device is None else device
        c = XL.init_xlstm_caches(cfg, n_m, max(n_s, 1), B, device=on)
        c["pos"] = torch.zeros((B,), dtype=torch.int32, device=on)
        return c

    def prefill(params, batch, cache):
        x = _embed(params["emb"], batch["tokens"], cfg, dt)
        x = _run(params, x, cache)
        cache["pos"] = cache["pos"] + x.shape[1]
        return _head(params["emb"], x[:, -1:, :], cfg), cache

    def decode(params, batch, cache):
        x = _embed(params["emb"], batch["token"], cfg, dt)
        x = _run(params, x, cache)
        cache["pos"] = batch["pos"] + 1
        return _head(params["emb"], x, cfg), cache

    return ModelBundle(cfg, init, forward, prefill, decode, init_cache, dev,
                       forward_fused, specs)
