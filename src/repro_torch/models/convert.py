"""Carry the reference's weights across to the port.

``from_jax_params`` takes the pytree that the reference's
``bundle.init`` returns, with every leaf as a numpy array and the
layers stacked with a leading ``L`` (``repro/models/lm.py:99-112``), and
returns the port's parameters: one dict per layer.

Every family comes across: the dense decoder (gemma2's
``post_attn``/``post_mlp`` norms among its norms), the moe decoder,
whose ``ffn`` group is the router (L, D, E), kept float32 because
``_route`` computes in float32 (``moe.py:63``), and the expert stacks
``w_gate``/``w_up`` (L, E, D, F) and ``w_down`` (L, E, F, D), with a
``shared`` group where the config has shared experts; deepseek-v3's
``dense`` (its leading dense layers) and ``mtp`` groups unstack like
``main``, ``mtp_proj`` comes across whole, and MLA's ``q_norm`` and
``kv_norm`` stay float32 because ``rms_norm`` reads them so; the hybrid
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
(``repro.optim.adamw.OptState``) across the same way, every group that
``from_jax_params`` carries, so both packages can train on from one
state.  Both walk one layout of the reference's tree (``_layout``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import OptState, _q8
from repro_torch.tree import tree_map

from .lm import Params, resolve_device


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


_HYBRID = {"emb", "rec", "attn", "mlp", "norms"}
_REC_F32 = ("lam", "conv_b", "b_a", "b_i")
_XLSTM = {"emb", "mlstm", "slstm", "norms"}
_XLSTM_F32 = ("r_in", "b_in", "b_if")
_ENCDEC = {"emb", "enc", "dec"}
# the router (``moe.py:63``) and MLA's q_norm and kv_norm are read in
# float32 by the decoder families
_DECODER_F32 = ("router", "q_norm", "kv_norm")
_WHOLE = ("emb", "mtp_proj")          # groups without a layer axis


class _Leaf(NamedTuple):
    """Where one leaf of the port's tree comes from: the reference's
    leaf at ``path``, its layer ``i`` (None: the leaf whole), kept
    float32 or stored in the matrix dtype."""
    path: Tuple[str, ...]
    i: Optional[int]
    f32: bool


def _layout(params_np: Dict[str, Any]):
    """The port's parameter tree for the reference's ``params_np``, with
    a :class:`_Leaf` at each leaf.  Every group is stacked with a
    leading layer axis and becomes a list of per-layer dicts, nested
    dicts walked (a moe layer's ``shared``); ``emb``, ``mtp_proj`` and
    the encoder's ``final_norm`` come across whole; the
    encoder-decoder's ``enc`` and ``dec`` hold stacked groups.  A leaf
    stays float32 where a norm reads it (any name on its path holds
    "norm") or its family reads it in float32."""
    groups = set(params_np)
    f32_names = (_REC_F32 if groups == _HYBRID else
                 _XLSTM_F32 if groups == _XLSTM else _DECODER_F32)

    def leaf(path, i):
        return _Leaf(path, i, path[-1] in f32_names
                     or any("norm" in k for k in path))

    def at(tree, path, i=None):
        """``tree``'s leaves whole (``i`` None) or their layer ``i``."""
        if isinstance(tree, dict):
            return {k: at(v, path + (k,), i) for k, v in tree.items()}
        return leaf(path, i)

    def stacked(tree, path):
        first = tree
        while isinstance(first, dict):
            first = next(iter(first.values()))
        return [at(tree, path, i) for i in range(len(first))]

    out = {}
    for g, tree in params_np.items():
        if g in _WHOLE:
            out[g] = at(tree, (g,))
        elif groups == _ENCDEC:
            out[g] = {k: at(v, (g, k)) if k == "final_norm" else
                      stacked(v, (g, k)) for k, v in tree.items()}
        else:
            out[g] = stacked(tree, (g,))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _map_layout(fn, params_np):
    return tree_map(fn, _layout(params_np),
                    is_leaf=lambda x: isinstance(x, _Leaf))


def from_jax_params(params_np: Dict[str, Any], cfg, *, device="cuda",
                    compute_dtype=torch.bfloat16) -> Params:
    """The port's params from the reference's pytree of numpy arrays, for
    every family: the dense and moe decoders' ``{"emb", "main"}`` with
    deepseek-v3's ``"dense"``, ``"mtp"`` and ``"mtp_proj"``, the vision
    decoder's ``{"emb", "main", "cross", "cross_norm"}``, the
    encoder-decoder's ``{"emb", "enc", "dec"}``, recurrentgemma's
    ``{"emb", "rec", "attn", "mlp", "norms"}`` and the xLSTM LM's
    ``{"emb", "mlstm", "slstm", "norms"}`` (:func:`_layout`)."""
    dev = resolve_device(device)

    def leaf(r: _Leaf):
        x = _get(params_np, r.path)
        return _t(x if r.i is None else x[r.i],
                  torch.float32 if r.f32 else compute_dtype, dev)

    return _map_layout(leaf, params_np)


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
        return _map_layout(lambda r: _moment(
            _get(tree, r.path), np.asarray(_get(params_np, r.path)), r.i,
            int8_block, dev), params_np)

    step = torch.tensor(int(np.asarray(opt_np.step)), dtype=torch.int32,
                        device=dev)
    return OptState(step, carry(opt_np.mu), carry(opt_np.nu))
