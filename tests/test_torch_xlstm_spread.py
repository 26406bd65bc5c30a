"""How far xlstm-125m's bf16 gradients move under a change far below a
bf16 ulp, in the reference and in the port, and which operation moves
them: why the card's gradient gate for xlstm (chip_smoke.py's
XLSTM_GATE_DTYPE) computes in float32.

Both packages get the same weights (the reference's initialisation) at
xlstm-125m's depth and layout (12 layers, the sLSTM at layers 6 and 12)
with d_model cut to 128 and the vocabulary to 1024, and one sequence of
256 tokens.  Each takes the gradient of the loss twice: with the weights
as drawn, and with the sLSTM's recurrent weights ``r_in`` scaled by
1 + 2**-20 (they are float32 in every compute type).  In float32 the two
gradients agree to 1e-4 at every leaf; in bf16 the reference's own part
by over 0.1 at the worst leaf, and the port's too.  The amplifier is the
mLSTM chunk's normaliser max(|den|, exp(-m)) (the reference's
``xlstm.py:86``): its clamp binds in about half the rows at
initialisation, and a row that crosses it switches its gradient between
den and the stabiliser m, whose gradient goes whole to one maximum.  Made
smooth, as sqrt(den**2 + exp(-2 m)) (a diagnostic, not the model), the
spread falls in both packages.

Measured on a CPU, the worst leaf: the reference 0.373 in bf16
(0.0445 with the smooth normaliser), 2.4e-5 in float32; the port 0.367
(0.0751), 4.4e-5.

Nor is the spread the port's own: with every float32 of both packages
widened to float64 and the same weights, at T 1024 (four mLSTM chunks a
layer), the port's loss and every gradient are the reference's to
1.0e-11 at the worst leaf.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import repro.models.common as RC  # noqa: E402
import repro.models.hybrid as RH  # noqa: E402
import repro.models.layers as RY  # noqa: E402
import repro.models.lm as RL  # noqa: E402
import repro.models.xlstm as RX  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.train import step as ref_step  # noqa: E402

import repro_torch.models.common as PC  # noqa: E402
import repro_torch.models.hybrid as PH  # noqa: E402
import repro_torch.models.layers as PY  # noqa: E402
import repro_torch.models.lm as PL  # noqa: E402
import repro_torch.models.xlstm as XL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.train import step as port_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

D_MODEL, VOCAB, T = 128, 1024, 256
NUDGE = 1 + 2.0 ** -20
# float32: the two gradients agree to summation order (measured 2.4e-5
# and 4.4e-5 at the worst leaf)
F32_SPREAD_MAX = 1e-3
# bf16: the reference's worst leaf moves by 0.373, the port's by 0.367;
# chip_smoke.py's TRAIN_GRAD_TOL is 5e-2
BF16_SPREAD_MIN = 0.1
# the smooth normaliser takes the worst leaf down 8.4-fold in the
# reference, 4.9-fold in the port
SMOOTH_CUT = 3
# float64 end to end, the same weights, T 1024: the loss equal to 2e-15
# relative, the worst leaf 1.0e-11 (the model's own conditioning: f64
# rounding amplified a few thousand times)
F64_LOSS_TOL, F64_GRAD_TOL = 1e-12, 1e-9


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("xlstm-125m"), d_model=D_MODEL,
                              vocab=VOCAB)
    rb = ref_build(cfg, jnp.float32)
    pr = jax.jit(lambda k: rb.init(k)[0])(jax.random.PRNGKey(0))
    nudged = dict(pr, slstm=dict(pr["slstm"], r_in=pr["slstm"]["r_in"] * NUDGE))
    b = TokenPipeline(DataConfig(cfg.vocab, T, 1, 0)).batch_at(0)
    return dict(cfg=cfg, reference=(pr, nudged),
                port=tuple(from_jax_params(jax.tree.map(np.asarray, p), cfg,
                                           device="cpu",
                                           compute_dtype=torch.float32)
                           for p in (pr, nudged)),
                bj={k: jnp.asarray(v) for k, v in b.items()},
                bt={k: torch.from_numpy(v) for k, v in b.items()}, spreads={})


def _ref_grads(s, dtype, params):
    loss = ref_step.make_loss_fn(ref_build(s["cfg"], dtype),
                                 ref_step.TrainConfig())
    _, g = jax.value_and_grad(loss, has_aux=True)(params, s["bj"])
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(g)]


def _port_grads(s, dtype, params):
    fn = port_step.value_and_grad(port_step.make_loss_fn(
        build(s["cfg"], dtype, "cpu"), port_step.TrainConfig()))
    return [x.double().numpy() for x in tree_leaves(fn(params, s["bt"])[2])]


def _smooth(module, xp):
    """``module``'s _mlstm_chunk with the normaliser made smooth."""
    clamp = f"{xp}.maximum(den, {xp}.exp(-m_new))"
    src = inspect.getsource(module._mlstm_chunk)
    assert clamp in src
    ns = dict(vars(module))
    exec(src.replace(clamp, f"{xp}.sqrt(den * den + {xp}.exp(-2 * m_new))"),
         ns)
    return ns["_mlstm_chunk"]


def _spread(s, package, bf16, smooth=False):
    """The worst leaf's Frobenius-relative change under the nudge."""
    key = (package, bf16, smooth)
    if key not in s["spreads"]:
        ref = package == "reference"
        grads = _ref_grads if ref else _port_grads
        dtype = {(True, True): jnp.bfloat16, (True, False): jnp.float32,
                 (False, True): torch.bfloat16,
                 (False, False): torch.float32}[ref, bf16]
        module = RX if ref else XL
        real = module._mlstm_chunk
        if smooth:
            module._mlstm_chunk = _smooth(module, "jnp" if ref else "torch")
        try:
            a, b = (grads(s, dtype, p) for p in s[package])
        finally:
            module._mlstm_chunk = real
        s["spreads"][key] = max(_fro(y, x) for x, y in zip(a, b))
    return s["spreads"][key]


@pytest.mark.parametrize("package", ["reference", "port"])
def test_float32_gradients_hold_under_the_nudge(setup, package):
    assert _spread(setup, package, bf16=False) <= F32_SPREAD_MAX


@pytest.mark.parametrize("package", ["reference", "port"])
def test_bf16_gradients_part_under_the_nudge(setup, package):
    assert _spread(setup, package, bf16=True) >= BF16_SPREAD_MIN


@pytest.mark.parametrize("package", ["reference", "port"])
def test_the_normaliser_clamp_amplifies_the_bf16_spread(setup, package):
    assert _spread(setup, package, bf16=True, smooth=True) \
        <= _spread(setup, package, bf16=True) / SMOOTH_CUT


class _Wide:
    """A module whose ``float32`` is ``float64``: the packages' float32
    pins (states, norms, the loss) widened."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


def _ref_leaf(tree, path):
    """The reference's leaf for the port's path: its blocks stack their
    layers on axis 0."""
    if path[0] in ("mlstm", "slstm", "norms"):
        return tree[path[0]][path[2]][path[1]]
    return tree[path[0]][path[1]]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, t in tree.items():
            yield from _paths(t, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (i,))
    else:
        yield prefix, tree


def test_float64_gradients_are_the_references(setup, monkeypatch):
    """The port computes the reference's function and gradient: every
    float32 pin of both packages widened to float64, the same weights
    (the reference's float32 initialisation) and T 1024."""
    for module in (RC, RH, RL, RX, RY, ref_step):
        monkeypatch.setattr(module, "jnp", _Wide(jnp, jnp.float64))
    for module in (PC, PH, PL, PY, XL, port_step):
        monkeypatch.setattr(module, "torch", _Wide(torch, torch.float64))
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    cfg = setup["cfg"]
    b = TokenPipeline(DataConfig(cfg.vocab, 1024, 1, 0)).batch_at(0)
    params = tree_unflatten(setup["port"][0], [
        x.double() for x in tree_leaves(setup["port"][0])])
    loss, _, grads = port_step.value_and_grad(port_step.make_loss_fn(
        build(cfg, torch.float64, "cpu"), port_step.TrainConfig()))(
            params, {k: torch.from_numpy(v) for k, v in b.items()})
    with jax.enable_x64(True):
        pr = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          setup["reference"][0])
        (want, _), gwant = jax.value_and_grad(
            ref_step.make_loss_fn(ref_build(cfg, jnp.float64),
                                  ref_step.TrainConfig()), has_aux=True)(
                pr, {k: jnp.asarray(v) for k, v in b.items()})
        gwant = jax.tree.map(np.asarray, gwant)
    assert abs(float(loss) - float(want)) <= F64_LOSS_TOL * abs(float(want))
    for path, g in _paths(grads):
        w = _ref_leaf(gwant, path)
        assert w.dtype == np.float64 and g.shape == w.shape, path
        assert _fro(g.numpy(), w) <= F64_GRAD_TOL, path
