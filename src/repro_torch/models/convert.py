"""Carry the reference's weights across to the port.

``from_jax_params`` takes the pytree that the reference's
``bundle.init`` returns, with every leaf as a numpy array and the
layers stacked with a leading ``L`` (``repro/models/lm.py:99-112``), and
returns the port's parameters: one dict per layer.

The ported families come across: the dense decoder (gemma2's
``post_attn``/``post_mlp`` norms among its norms), the moe decoder,
whose ``ffn`` group is the router (L, D, E), kept float32 because
``_route`` computes in float32 (``moe.py:63``), and the expert stacks
``w_gate``/``w_up`` (L, E, D, F) and ``w_down`` (L, E, F, D), with a
``shared`` group where the config has shared experts, and the hybrid
recurrentgemma, whose ``{"emb", "rec", "attn", "mlp", "norms"}``
groups each unstack by their own leading dim (18 recurrent, 8
attention and 26 mlp and norm layers at full size).  Its ``lam`` and
recurrent biases stay float32: ``lam`` is read in float32
(``rglru.py:78``), the biases cast at each use.  The xLSTM LM's
``{"emb", "mlstm", "slstm", "norms"}`` groups unstack the same way (10
mLSTM, 2 sLSTM and 12 norm layers at full size); its sLSTM recurrent
weights ``r_in`` stay float32, because the recurrence reads them in
float32 (``xlstm.py:201``), and so do the biases ``b_in`` and ``b_if``.
The encoder-decoder's ``{"emb", "enc": {"attn", "mlp", "norms",
"final_norm"}, "dec": {"attn", "cross", "mlp", "norms"}}`` (whisper: 6
encoder and 6 decoder layers at full size) and the vision decoder's
``{"emb", "main", "cross", "cross_norm"}`` (llama-3.2-vision: 40 main
layers, 8 cross layers and their norms) unstack each group by its own
leading dim too.

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


_HYBRID = {"emb", "rec", "attn", "mlp", "norms"}
_REC_F32 = ("lam", "conv_b", "b_a", "b_i")
_XLSTM = {"emb", "mlstm", "slstm", "norms"}
_XLSTM_F32 = ("r_in", "b_in", "b_if")
_ENCDEC = {"emb", "enc", "dec"}
_VLM = {"emb", "main", "cross", "cross_norm"}


def from_jax_params(params_np: Dict[str, Any], cfg, *, device="cuda",
                    compute_dtype=torch.bfloat16) -> Params:
    """The port's params of a dense or moe decoder from the reference's
    ``{"emb": ..., "main": {"attn", "norms", "ffn"}}`` pytree of numpy
    arrays, of the vision decoder from its ``{"emb", "main", "cross",
    "cross_norm"}``, of the encoder-decoder from its ``{"emb", "enc",
    "dec"}``, of recurrentgemma from its ``{"emb", "rec", "attn",
    "mlp", "norms"}``, or of the xLSTM LM from its ``{"emb", "mlstm",
    "slstm", "norms"}``."""
    dev = resolve_device(device)
    mat = lambda x: _t(x, compute_dtype, dev)          # noqa: E731
    f32 = lambda x: _t(x, torch.float32, dev)          # noqa: E731
    emb = params_np["emb"]
    emb_p = {"in_emb": mat(emb["in_emb"]), "out_emb": mat(emb["out_emb"]),
             "final_norm": f32(emb["final_norm"])}
    def unstack(group, f32_names=()):
        n = len(next(iter(group.values())))
        return [{k: (f32 if k in f32_names else mat)(w[i])
                 for k, w in group.items()} for i in range(n)]

    def norms(group):
        return unstack(group, tuple(group))

    if set(params_np) == _ENCDEC:
        enc, dec = params_np["enc"], params_np["dec"]
        return {"emb": emb_p,
                "enc": {"attn": unstack(enc["attn"]),
                        "mlp": unstack(enc["mlp"]),
                        "norms": norms(enc["norms"]),
                        "final_norm": f32(enc["final_norm"])},
                "dec": {"attn": unstack(dec["attn"]),
                        "cross": unstack(dec["cross"]),
                        "mlp": unstack(dec["mlp"]),
                        "norms": norms(dec["norms"])}}
    if set(params_np) == _XLSTM:
        return {"emb": emb_p,
                "mlstm": unstack(params_np["mlstm"], _XLSTM_F32),
                "slstm": unstack(params_np["slstm"], _XLSTM_F32),
                "norms": norms(params_np["norms"])}
    if set(params_np) == _HYBRID:
        return {"emb": emb_p,
                "rec": unstack(params_np["rec"], _REC_F32),
                "attn": unstack(params_np["attn"]),
                "mlp": unstack(params_np["mlp"]),
                "norms": norms(params_np["norms"])}
    if set(params_np) not in ({"emb", "main"}, _VLM):
        raise NotImplementedError(
            f"from_jax_params carries the dense and moe decoders without "
            f"leading dense layers or MTP, the vision decoder, the "
            f"encoder-decoder, recurrentgemma and the xLSTM LM, got groups "
            f"{sorted(params_np)}")
    main = params_np["main"]

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
    if set(params_np) == _VLM:
        return {"emb": emb_p, "main": layers,
                "cross": unstack(params_np["cross"]),
                "cross_norm": norms(params_np["cross_norm"])}
    return {"emb": emb_p, "main": layers}


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
