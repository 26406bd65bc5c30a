"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's.

The same numpy parameters and gradients go through both packages'
``apply_updates`` for three steps.  Both compute every update in
float32 in the same order of operations; ``global_norm`` sums its
squares in another order (torch's reduction against XLA's), so the clip
factor and through it every update may differ in the last float32 bits:
parameters are held to rtol 1e-5, atol 1e-7.  bf16 and int8 moments
round those nearly equal float32 moments to 8 bits, where a value on a
rounding boundary can land one step apart, so moments are held to one
rounding step: bf16 2**-8 relative, int8 one quantization step
(the block's scale) plus 1e-6 of the block's largest value.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ref  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

P_TOL = dict(rtol=1e-5, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((37, 29))).astype(np.float32),
            "blk": {"b": (scale * rng.standard_normal((300,))).astype(
                        np.float32),
                    "m": (scale * rng.standard_normal((16, 16, 2))).astype(
                        np.float32)}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree, dtype=np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) and set(tree) != {"q", "s"}:
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _run_both(cfg_kw, steps=3, decay_mask=None):
    params_np = _tree(0)
    cfg_r = ref.AdamWConfig(**cfg_kw)
    cfg_p = adamw.AdamWConfig(**cfg_kw)
    pr = jax.tree.map(jnp.asarray, params_np)
    pp = _torch(params_np)
    sr, sp = ref.init_opt_state(cfg_r, pr), adamw.init_opt_state(cfg_p, pp)
    for i in range(steps):
        g = _tree(10 + i, scale=3.0)
        mask_r = None if decay_mask is None else jax.tree.map(
            float, decay_mask)
        pr, sr, mr = ref.apply_updates(cfg_r, pr, jax.tree.map(jnp.asarray, g),
                                       sr, mask_r)
        pp, sp, mp = adamw.apply_updates(cfg_p, pp, _torch(g), sp,
                                         decay_mask)
        np.testing.assert_allclose(float(mp["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(mp["lr"]), float(mr["lr"]),
                                   rtol=1e-6)
    return pr, sr, pp, sp


def _check_moments(sr, sp, dtype):
    for tr, tp in ((sr.mu, sp.mu), (sr.nu, sp.nu)):
        fr, fp = _flat(tr), _flat(tp)
        assert fr.keys() == fp.keys()
        for key in fr:
            r, p = fr[key], fp[key]
            if dtype == "int8":
                q_r, s_r = np.asarray(r["q"]), np.asarray(r["s"])
                q_p, s_p = p["q"].numpy(), p["s"].numpy()
                assert q_p.dtype == np.int8 and q_p.shape == q_r.shape
                np.testing.assert_allclose(s_p, s_r, rtol=1e-5)
                diff = np.abs(q_p.astype(np.float32) * s_p
                              - q_r.astype(np.float32) * s_r)
                assert (diff <= s_r * (1 + 1e-6) + 1e-6 * 127 * s_r).all()
            else:
                want = np.asarray(r, dtype=np.float32)
                got = p.float().numpy()
                rtol = 2 ** -8 if dtype == "bf16" else 1e-5
                np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-9)
    assert int(sp.step) == int(sr.step)


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
@pytest.mark.parametrize("clip_norm", [1.0, 0.0])
def test_apply_updates_matches_reference(moment_dtype, schedule, clip_norm):
    """Clipping fires (gradient norms near 150 against 1.0) or is off;
    the schedule is mid-warmup at step 1 and decays after."""
    kw = dict(lr=1e-2, moment_dtype=moment_dtype, schedule=schedule,
              clip_norm=clip_norm, warmup_steps=2, total_steps=5,
              int8_block=64)
    pr, sr, pp, sp = _run_both(kw)
    for key, want in _flat(_np(jax.tree.map(np.asarray, pr))).items():
        np.testing.assert_allclose(_flat(_np(pp))[key], want, **P_TOL)
    _check_moments(sr, sp, moment_dtype)


def test_apply_updates_decay_mask_matches_reference():
    """An explicit mask decays only the 1-d leaf (the default mask
    decays the matrices)."""
    kw = dict(lr=1e-2, weight_decay=0.5, warmup_steps=1, total_steps=10)
    mask = {"w": 0.0, "blk": {"b": 1.0, "m": 0.0}}
    pr, sr, pp, sp = _run_both(kw, decay_mask=mask)
    for key, want in _flat(_np(jax.tree.map(np.asarray, pr))).items():
        np.testing.assert_allclose(_flat(_np(pp))[key], want, **P_TOL)
    _check_moments(sr, sp, "fp32")


def test_apply_updates_writes_in_place():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    params = _torch(_tree(0))
    state = adamw.init_opt_state(cfg, params)
    w, mu = params["w"], state.mu["w"]
    p2, s2, _ = adamw.apply_updates(cfg, params, _torch(_tree(1)), state)
    assert p2["w"] is w and s2.mu["w"] is mu
    assert not np.array_equal(w.numpy(), _tree(0)["w"])


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=30, schedule=schedule)
    for step in (0, 1, 6, 7, 8, 20, 30, 45):
        np.testing.assert_allclose(
            float(adamw.schedule_lr(adamw.AdamWConfig(**kw),
                                    torch.tensor(step, dtype=torch.int32))),
            float(ref.schedule_lr(ref.AdamWConfig(**kw), jnp.int32(step))),
            rtol=1e-6)


def test_q8_round_trip_matches_reference():
    x = np.random.default_rng(2).standard_normal((5, 77)).astype(np.float32)
    q_r, s_r, _, pad_r = ref._q8(jnp.asarray(x), 64)
    q_p, s_p, _, pad_p = adamw._q8(torch.from_numpy(x), 64)
    assert pad_p == pad_r
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-7)
    np.testing.assert_allclose(
        adamw._dq8(q_p, s_p, x.shape, pad_p).numpy(),
        np.asarray(ref._dq8(q_r, s_r, x.shape, pad_r)), rtol=1e-7)


# -- the reference's own system tests, test_system.py:97-120 -------------
@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16", "int8"])
def test_adamw_converges_quadratic(moment_dtype):
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=60, schedule="const",
                            moment_dtype=moment_dtype)
    params = {"w": torch.tensor([4.0, -3.0, 2.0])}
    state = adamw.init_opt_state(cfg, params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_compression_roundtrip():
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .standard_normal((64,)).astype(np.float32))}
    d = adamw.decompress_grads(adamw.compress_grads(g, "bf16"), "bf16")
    np.testing.assert_allclose(d["w"].numpy(), g["w"].numpy(), atol=1e-2)
    gen = torch.Generator().manual_seed(0)
    c8 = adamw.compress_grads(g, "int8", gen)
    assert c8["w"][0].dtype == torch.int8
    d8 = adamw.decompress_grads(c8, "int8")
    np.testing.assert_allclose(d8["w"].numpy(), g["w"].numpy(), atol=0.05)


def test_int8_compression_is_unbiased():
    """Stochastic rounding: the mean over many draws tends to g."""
    g = {"w": torch.linspace(-1, 1, 33)}
    gen = torch.Generator().manual_seed(1)
    mean = sum(adamw.decompress_grads(adamw.compress_grads(g, "int8", gen),
                                      "int8")["w"] for _ in range(400)) / 400
    step = float(g["w"].abs().max()) / 127
    assert float((mean - g["w"]).abs().max()) < 0.2 * step


# -- step 0 repair: an OptState (a NamedTuple) through a checkpoint -------
@pytest.mark.parametrize("moment_dtype", ["fp32", "int8"])
def test_checkpoint_restores_named_tuple_opt_state(tmp_path, moment_dtype):
    """``CheckpointManager.restore`` rebuilt tuples from a generator,
    which a NamedTuple such as OptState does not take; the training
    loop checkpoints {"params", "opt": OptState} with int8 moments'
    {"q", "s"} dicts inside."""
    cfg = adamw.AdamWConfig(lr=1e-2, moment_dtype=moment_dtype,
                            int8_block=64, warmup_steps=0)
    params = _torch(_tree(0))
    opt = adamw.init_opt_state(cfg, params)
    params, opt, _ = adamw.apply_updates(cfg, params, _torch(_tree(1)), opt)
    state = {"params": params, "opt": opt}
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(3, state)
    like = {"params": _torch(_tree(5)),
            "opt": adamw.init_opt_state(cfg, _torch(_tree(5)))}
    step, got = cm.restore(None, like)
    assert step == 3 and isinstance(got["opt"], adamw.OptState)
    assert int(got["opt"].step) == 1
    want, have = tree_leaves(state), tree_leaves(got)
    assert len(want) == len(have) == 3 + 1 + (
        2 * 2 * 3 if moment_dtype == "int8" else 2 * 3)
    for x, y in zip(want, have):
        assert x.dtype == y.dtype and torch.equal(x, y)
