"""gemma2-9b in the port against the reference, on
``get_config("gemma2-9b").reduced()`` (4 layers, d_model 64, 4/2 heads
of 16, window 16, attention softcap 50, final softcap 30, post-norms,
tanh gelu) with the reference's own weights carried across by
``from_jax_params``.

Tolerances, as ``tests/test_torch_serve.py`` states them for yi-9b:

* float32 compute: logits within rtol 1e-4 (plus 2e-4 of max|logit|
  where a bf16 KV cache is read: a K or V value may round to the
  neighbouring bf16 value), greedy tokens identical;
* bfloat16 compute: logits within 2e-2 of max|logit| (XLA keeps
  float32 between the reference's fused bf16 ops, the port rounds
  after each op), greedy tokens equal where the reference's top-2
  margin exceeds twice that bound.

Prompts of 1024 tokens take the flash-attention branch with the local
window on the even layers and both softcaps; shorter ones take the
dense ``gqa_attention``.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, layers, lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "gemma2-9b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_get_config(ARCH).reduced()
    params, _ = ref_build(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _models(ref_params, dtype):
    jdt, tdt = DTYPES[dtype]
    params, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    rb = ref_build(ref_get_config(ARCH).reduced(), jdt)
    tb = build(cfg, tdt, "cpu")
    tp = from_jax_params(params_np, cfg, device="cpu", compute_dtype=tdt)
    return rb, params, tb, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel, of_max=None):
    got, want = _np(got), _np(want)
    bound = (rel if of_max is None else of_max) * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=bound)


@pytest.mark.parametrize("reduced", [True, False])
def test_windows_alternate_as_the_reference(reduced):
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    got = lm._window_array(cfg)
    assert got == np.asarray(ref_lm._window_array(rcfg)).tolist()
    assert got[:2] == [cfg.window, lm.BIG_WINDOW]


def test_embed_scale_rounds_in_the_compute_dtype():
    """sqrt(3584) rounds to 59.75 in bf16 before it scales, as the
    reference's ``jnp.asarray(..., dt)``."""
    cfg = get_config(ARCH)
    table = np.random.default_rng(0).standard_normal(
        (8, cfg.d_model)).astype(np.float32)
    toks = np.array([[1, 5, 7]])
    want = ref_lm._embed({"in_emb": jnp.asarray(table)}, jnp.asarray(toks),
                         ref_get_config(ARCH), jnp.bfloat16)
    got = lm._embed({"in_emb": torch.from_numpy(table)},
                    torch.from_numpy(toks), cfg, torch.bfloat16)
    assert float(torch.tensor(math.sqrt(cfg.d_model),
                              dtype=torch.bfloat16)) == 59.75
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T, monkeypatch):
    """The whole stack without a cache, every position's logits; at
    T = 1024 every layer goes through flash attention with its window
    and the attention softcap."""
    calls = []
    flash = layers.flash_attention

    def spy(*args, **kw):
        calls.append((kw["window"], kw["softcap"]))
        return flash(*args, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T + 2).integers(0, 256, (2, T))
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)
    assert float(aux["aux_loss"]) == 0.0
    cfg = tb.cfg
    assert calls == ([(w, cfg.attn_softcap) for w in lm._window_array(cfg)]
                     if T >= layers.FLASH_MIN_T else [])


def test_forward_bf16_matches_reference(ref_params):
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    toks = np.random.default_rng(5).integers(0, 256, (2, 40))
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(got, want, 2e-2)


def _prefill_decode(rb, rp, tb, tp, prompts, steps, max_seq):
    """Prefill both models, then decode greedily, feeding both the
    reference's tokens.  Yields (ref_logits, port_logits) per step."""
    rc, tc = rb.init_cache(2, max_seq), tb.init_cache(2, max_seq)
    prefill, decode = jax.jit(rb.prefill), jax.jit(rb.decode)
    toks = np.asarray(prompts, np.int32)
    rl, rc = prefill(rp, {"tokens": jnp.asarray(toks)}, rc)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    yield rl, tl
    pos = np.full(2, toks.shape[1], np.int32)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(rl)[:, -1], axis=-1).astype(np.int32)
        rl, rc = decode(rp, {"token": jnp.asarray(nxt[:, None]),
                             "pos": jnp.asarray(pos)}, rc)
        tl, tc = tb.decode(tp, {"token": torch.from_numpy(nxt[:, None]).long(),
                                "pos": torch.from_numpy(pos.copy())}, tc)
        pos = pos + 1
        yield rl, tl


@pytest.mark.parametrize("T", [1024, 37])
def test_prefill_decode_f32_matches_reference(ref_params, T):
    """Decode steps past the window of 16 on the local layers."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    prompts = np.random.default_rng(T).integers(0, 256, (2, T))
    for rl, tl in _prefill_decode(rb, rp, tb, tp, prompts, 8, T + 12):
        _close(tl, rl, 1e-4, of_max=2e-4)
        assert np.array_equal(np.argmax(_np(tl), -1), np.argmax(_np(rl), -1))


@pytest.mark.parametrize("T", [1024, 37])
def test_prefill_decode_bf16_matches_reference(ref_params, T):
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    prompts = np.random.default_rng(T + 1).integers(0, 256, (2, T))
    checked = 0
    for rl, tl in _prefill_decode(rb, rp, tb, tp, prompts, 8, T + 12):
        _close(tl, rl, 2e-2)
        want, got = _np(rl)[:, -1], _np(tl)[:, -1]
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * 2e-2 * np.abs(want).max()
        assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
        checked += int(sure.sum())
    assert checked >= 6                 # a third of the 18 tokens decided


def _drive(engine_cls, scfg_cls, bundle, params):
    """Staggered admits (one sharing a prefix), decode steps past the
    window, finishes.  Returns what the engine reported."""
    rng = np.random.default_rng(13)
    eng = engine_cls(bundle, params, scfg_cls(max_seq=64, slots=2,
                                              prefix_reuse=True))
    pa = rng.integers(0, 256, 20)
    pb = np.concatenate([pa[:9], rng.integers(0, 256, 8)])
    log = [eng.add_request(pa)]
    for _ in range(6):
        log.append(eng.step())
    log.append(eng.add_request(pb))
    for _ in range(12):
        log.append(eng.step())
    log += [eng.finish(0), eng.finish(1)]
    log.append(eng.generate(rng.integers(0, 256, 30), 10))
    log.append((eng.prefill_tokens_computed, eng.prefix_hits))
    return log


def test_engine_streams_equal_reference_engine(ref_params):
    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _drive(RefEngine, RefServeConfig, rb, rp)
    got = _drive(Engine, ServeConfig, tb, tp)
    assert got == want
    assert got[-1][1] == 1                           # the prefix was reused


def test_load_engine_serves_gemma2(capsys):
    from repro_torch.launch.serve import load_engine, main

    main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
          "--tokens", "4"])
    assert "1 requests, 4 tokens" in capsys.readouterr().out

    eng = load_engine(ARCH, slots=2, max_seq=48, device="cpu")
    out = eng.generate(np.arange(20), 24)      # past the window of 16
    assert len(out) == 44 and all(0 <= t < eng.cfg.vocab for t in out)


def _failover(engine, fail):
    """Two requests; with ``fail`` a RecoveryEngine's instance 1 fails
    mid-decode (a checkpoint restore and a decode replay) and rejoins.
    Returns the streams."""
    p = [np.random.default_rng(21).integers(0, 256, n) for n in (6, 5)]
    a = engine.add_request(p[0])
    for _ in range(2):
        engine.step()
    b = engine.add_request(p[1])
    for _ in range(4):
        engine.step()
    if fail:
        engine.fail_instance(1)
    engine.step()
    if fail:
        engine.rejoin_instance(1)
    for _ in range(2):
        engine.step()
    return [engine.finish(a), engine.finish(b)]


def test_recovery_engine_failover_keeps_the_reference_streams(ref_params):
    """RecoveryEngine needs no family-specific code: its KV leaves are
    the family's cache dicts, and a failover leaves the streams as the
    reference Engine's."""
    from repro_torch.serve import RecoveryEngine

    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _failover(RefEngine(rb, rp, RefServeConfig(max_seq=40, slots=3)),
                     False)
    eng = RecoveryEngine(tb, tp, ServeConfig(max_seq=40, slots=3),
                         instances=3, checkpoint_interval=3)
    assert _failover(eng, True) == want
    assert [r["kind"] for r in eng.recovery_log] == ["instance_loss",
                                                     "instance_join"]
