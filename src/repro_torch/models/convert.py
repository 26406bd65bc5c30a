"""Carry the reference's weights across to the port.

``from_jax_params`` takes the pytree that the reference's
``bundle.init`` returns, with every leaf as a numpy array and the
layers stacked with a leading ``L`` (``repro/models/lm.py:99-112``), and
returns the port's parameters: one dict per layer.

Both ported families come across: the dense decoder (gemma2's
``post_attn``/``post_mlp`` norms among its norms) and the moe decoder,
whose ``ffn`` group is the router (L, D, E), kept float32 because
``_route`` computes in float32 (``moe.py:63``), and the expert stacks
``w_gate``/``w_up`` (L, E, D, F) and ``w_down`` (L, E, F, D), with a
``shared`` group where the config has shared experts.

Every matrix is stored in ``compute_dtype``.  The reference keeps
float32 masters but casts each matrix to the compute dtype right
before every use (``layers.py:121-124``, ``lm.py:72``, ``:80``,
``:135-137``), so a matrix rounded once at load gives the same values
for serving.  Training needs the masters themselves: pass
``compute_dtype=torch.float32`` and the weights come across as the
reference's float32 values, bit for bit, whatever dtype the model
computes in.  Norm scales stay float32, because ``rms_norm`` reads
them as float32 (``common.py:159``).

``opt_state_from_jax`` carries the reference's optimizer state
(``repro.optim.adamw.OptState``) across the same way, so both packages
can train on from one state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.optim.adamw import OptState, _q8

from .lm import Params, resolve_device


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def from_jax_params(params_np: Dict[str, Any], cfg, *, device="cuda",
                    compute_dtype=torch.bfloat16) -> Params:
    """The port's params of a dense or moe decoder from the reference's
    ``{"emb": ..., "main": {"attn", "norms", "ffn"}}`` pytree of numpy
    arrays."""
    dev = resolve_device(device)
    if set(params_np) != {"emb", "main"}:
        raise NotImplementedError(
            f"from_jax_params carries the dense and moe decoders without "
            f"leading dense layers or MTP, got groups {sorted(params_np)}")
    emb = params_np["emb"]
    main = params_np["main"]
    mat = lambda x: _t(x, compute_dtype, dev)          # noqa: E731
    f32 = lambda x: _t(x, torch.float32, dev)          # noqa: E731

    def ffn(group, i):
        return {n: ffn(w, i) if isinstance(w, dict) else
                (f32 if n == "router" else mat)(w[i])
                for n, w in group.items()}

    layers = []
    for i in range(cfg.n_layers):
        layers.append({
            "attn": {n: mat(w[i]) for n, w in main["attn"].items()},
            "norms": {n: f32(w[i]) for n, w in main["norms"].items()},
            "ffn": ffn(main["ffn"], i),
        })
    return {"emb": {"in_emb": mat(emb["in_emb"]),
                    "out_emb": mat(emb["out_emb"]),
                    "final_norm": f32(emb["final_norm"])},
            "main": layers}


def _moment(m, like: np.ndarray, i, block: int, dev):
    """One moment leaf of the reference (an fp32 or bf16 array, or an
    int8 ``{"q", "s"}`` dict quantized over the flattened leaf ``like``)
    for layer ``i`` of a stacked leaf (``i`` None: the leaf whole)."""
    if not (isinstance(m, dict) and set(m) == {"q", "s"}):
        x = np.asarray(m)
        dtype = torch.bfloat16 if x.dtype.name == "bfloat16" \
            else torch.float32
        return _t(x if i is None else x[i], dtype, dev)
    q = np.asarray(m["q"])
    s = np.asarray(m["s"], dtype=np.float32)
    if i is None:
        return {"q": torch.from_numpy(q.astype(np.int8)).to(dev),
                "s": _t(s, torch.float32, dev)}
    L, per = like.shape[0], int(np.prod(like.shape[1:]))
    if per % block == 0:
        # every layer's elements fill whole blocks: its blocks are the
        # port's own quantization of that layer, bit for bit
        n = per // block
        return {"q": torch.from_numpy(
                    q[i * n:(i + 1) * n].astype(np.int8)).to(dev),
                "s": _t(s[i * n:(i + 1) * n], torch.float32, dev)}
    # a block spans two layers: dequantize, take the layer, quantize it
    # alone (what the port would have stored for it)
    flat = (q.astype(np.float32) * s).reshape(-1)[:L * per]
    x = torch.from_numpy(flat.reshape(like.shape)[i].copy()).to(dev)
    qi, si, _, _ = _q8(x, block)
    return {"q": qi, "s": si}


def opt_state_from_jax(opt_np, params_np: Dict[str, Any], cfg, *,
                       device="cuda", int8_block: int = 256) -> OptState:
    """The port's :class:`~repro_torch.optim.adamw.OptState` from the
    reference's (numpy leaves), whose moments are shaped like
    ``params_np`` with stacked layers.  fp32 and bf16 moments come
    across bit for bit; int8 ``{"q", "s"}`` moments too wherever a
    layer's leaf fills whole blocks of ``int8_block`` (otherwise that
    layer is re-quantized alone, as the port stores it)."""
    dev = resolve_device(device)

    def carry(tree):
        emb, main = tree["emb"], tree["main"]
        pe, pm = params_np["emb"], params_np["main"]
        mom = lambda m, like, i: _moment(m, np.asarray(like), i,  # noqa: E731
                                         int8_block, dev)
        return {"emb": {n: mom(emb[n], pe[n], None) for n in emb},
                "main": [{g: {n: mom(main[g][n], pm[g][n], i)
                              for n in main[g]} for g in main}
                         for i in range(cfg.n_layers)]}

    step = torch.tensor(int(np.asarray(opt_np.step)), dtype=torch.int32,
                        device=dev)
    return OptState(step, carry(opt_np.mu), carry(opt_np.nu))
