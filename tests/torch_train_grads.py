"""The model-gradient check of the port's training slice and the
helpers that tests/test_torch_train.py shares: the reference's and the
port's float32 models on the same weights, one batch for both, the
port's leaves keyed like the reference's stacked tree.  The check's
cases live in tests/test_torch_train_grads.py, recurrentgemma-2b's, the
two slowest, in tests/test_torch_train_grads_rg.py, and those of the
families with extra inputs or capacity drops (qwen3-moe,
llama-3.2-vision, whisper) in tests/test_torch_train_grads_xfam.py, so
that a run on several workers (one file a worker) spreads them.

Tolerances, with their reasons in tests/test_torch_train.py: a loss
within rtol 1e-5 and atol 1e-6; every leaf's gradient within a
Frobenius-relative 1e-4, each element within 1e-4 of the leaf's largest
gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.train import _extra_inputs as ref_extra_inputs
from repro.models import build as ref_build
from repro.train import step as ref_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.train import _extra_inputs
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params
from repro_torch.train import step as port_step

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_FRO_TOL = 1e-4
GRAD_MAX_TOL = 1e-4


def _models(cfg, seed=0):
    """The reference's float32 bundle and numpy params, and the port's
    float32 bundle with the same weights on the CPU."""
    rb = ref_build(cfg, jnp.float32)
    pr = jax.jit(lambda k: rb.init(k)[0])(jax.random.PRNGKey(seed))
    pr_np = jax.tree.map(np.asarray, pr)
    pb = build(cfg, torch.float32, "cpu")
    pp = from_jax_params(pr_np, cfg, device="cpu",
                         compute_dtype=torch.float32)
    return rb, pr, pr_np, pb, pp


def _batch(cfg, seq, batch, seed=0):
    """One batch for both packages: the pipeline's tokens, and each
    package's ``_extra_inputs`` (audio frames, image embeddings) from
    its own ``np.random.default_rng(123)``, the same bf16 values."""
    b = TokenPipeline(DataConfig(cfg.vocab, seq, batch, seed)).batch_at(0)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    bj.update(ref_extra_inputs(cfg, batch, seq, np.random.default_rng(123)))
    bt.update(_extra_inputs(cfg, batch, seq, np.random.default_rng(123),
                            "cpu"))
    return bj, bt


def _port_leaves(pp, cfg):
    """The port's leaves keyed like the reference's stacked tree: a
    layer leaf as (group, sub, name, layer), or (group, name, layer)
    where the group's layers hold leaves directly (the hybrid's per-kind
    lists: rec, attn, mlp, norms; the vision decoder's cross and
    cross_norm), with a moe layer's nested dicts in the path (group,
    "ffn", "shared", name, layer); a group that is a dict of layer lists
    (whisper's enc and dec: attn, cross, mlp, norms) adds its key to the
    path, (group, kind, name, layer); a group, or a dict's entry, that is
    one tensor (deepseek's mtp_proj, the encoder's final_norm) as
    ("top", group[, key])."""
    out = {("emb", n): t for n, t in pp["emb"].items()}

    def walk(path, d, i):
        for n, t in d.items():
            if isinstance(t, dict):
                walk(path + (n,), t, i)
            else:
                out[path + (n, i)] = t

    def group(path, layers):
        if isinstance(layers, torch.Tensor):
            out[("top",) + path] = layers
        elif isinstance(layers, dict):
            for k, v in layers.items():
                group(path + (k,), v)
        else:
            for i, layer in enumerate(layers):
                walk(path, layer, i)

    for name, layers in pp.items():
        if name != "emb":
            group((name,), layers)
    return out


def _ref_leaf(tree, key):
    if key[0] == "emb":
        return np.asarray(tree["emb"][key[1]])
    if key[0] == "top":
        node = tree
        for k in key[1:]:
            node = node[k]
        return np.asarray(node)
    node = tree
    for k in key[:-1]:
        node = node[k]
    return np.asarray(node)[key[-1]]


def _assert_grads_close(got, want_tree, cfg):
    for key, g in _port_leaves(got, cfg).items():
        w = _ref_leaf(want_tree, key)
        g = g.numpy()
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        fro = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert fro <= GRAD_FRO_TOL, (key, fro)
        assert float(np.abs(g - w).max()) <= GRAD_MAX_TOL * scale, key


def model_loss_and_every_grad_match_reference(arch, seq, batch, layers,
                                              vocab, d_head,
                                              capacity_factor=None):
    """The float32 loss and every leaf's gradient of ``arch``, reduced
    (``layers``: a layer count, or (layers, leading dense layers);
    ``vocab``, ``d_head`` and a moe config's ``capacity_factor``
    overriding the reduced config's), on one batch of ``batch`` x
    ``seq`` tokens with the family's extra inputs, against the
    reference's."""
    cfg = get_config(arch).reduced()
    if isinstance(layers, tuple):
        layers, dense = layers
        cfg = dataclasses.replace(cfg, dense_layers=dense)
    if layers or vocab or d_head:
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                  vocab=vocab or cfg.vocab,
                                  d_head=d_head or cfg.d_head)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    rb, pr, _, pb, pp = _models(cfg)
    bj, bt = _batch(cfg, seq, batch)
    tcfg_r, tcfg_p = ref_step.TrainConfig(), port_step.TrainConfig()
    (want, _), gwant = jax.value_and_grad(
        ref_step.make_loss_fn(rb, tcfg_r), has_aux=True)(pr, bj)
    grad_fn = port_step.value_and_grad(port_step.make_loss_fn(pb, tcfg_p))
    got, metrics, grads = grad_fn(pp, bt)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert "ce" in metrics
    _assert_grads_close(grads, jax.tree.map(np.asarray, gwant), cfg)
