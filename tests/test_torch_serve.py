"""The port's serving path (configs -> models -> serve Engine) against
the reference, on ``get_config("yi-9b").reduced()`` with the
reference's own weights carried across by ``from_jax_params``.

Tolerances, each with its reason:

* float32 compute: logits within rtol 1e-4 plus an atol of 2e-4 of
  max|logit|, and greedy tokens identical.  The frameworks sum matrix
  products in other orders, and the KV cache rounds K and V to bf16
  as the reference's does: a value that lands by that noise on the
  other side of a bf16 rounding midpoint moves one ulp (2**-8), which
  moves a logit by about 1e-4 of the range (seen once in 512).
* bfloat16 compute: logits within 2e-2 of max|logit|.  The port
  rounds after every op as the reference's ops are written (one layer
  is bit-identical when the reference runs op by op), but XLA fuses
  the reference's layer stack and keeps float32 between fused bf16 ops,
  which moves the logits by about 1% of their range.  Greedy tokens
  must agree wherever the reference's top-2 margin exceeds twice that
  bound; both models are fed the reference's tokens so one flip does
  not fork the streams.

Prompts of 1024 tokens take the flash-attention branch
(``FLASH_MIN_T``); shorter ones take the dense ``gqa_attention``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.lm import BIG_WINDOW  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import load_engine  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig, SlotsExhausted  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "yi-9b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ref_params():
    """The reference's float32 master weights, as jax and numpy."""
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
    """|got - want| <= rel * |want| + of_max * max|want| elementwise
    (of_max defaults to rel)."""
    got, want = _np(got), _np(want)
    bound = (rel if of_max is None else of_max) * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=bound)


def test_config_registry_matches_reference():
    from repro.configs import ALL_ARCHS as ref_archs
    from repro_torch.configs import ALL_ARCHS
    assert ALL_ARCHS == ref_archs
    for name in ALL_ARCHS:
        mine, theirs = get_config(name), ref_get_config(name)
        assert repr(mine) == repr(theirs)
        assert repr(mine.reduced()) == repr(theirs.reduced())
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()


@pytest.mark.parametrize("T", [40, 1024])
@pytest.mark.parametrize("with_cache", [False, True])
def test_one_attention_layer_matches_reference(ref_params, T, with_cache):
    """Layer 0's attention in float32, without a cache and writing a
    (bf16) cache at ragged offsets; T = 1024 takes the flash branch."""
    params, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    rcfg = ref_get_config(ARCH).reduced()
    rp = jax.tree.map(lambda a: a[0], params["main"]["attn"])
    tp = from_jax_params(params_np, cfg, device="cpu",
                         compute_dtype=torch.float32)["main"][0]["attn"]
    x = np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    ref_attention = jax.jit(lambda p, x, c: ref_layers.attention(
        p, x, cfg=rcfg, window=BIG_WINDOW, cache=c))
    if not with_cache:
        want, _ = ref_attention(rp, jnp.asarray(x), None)
        got, _ = layers.attention(tp, torch.from_numpy(x), cfg=cfg,
                                  window=BIG_WINDOW)
        _close(got, want, 1e-4)
        return
    S = T + 24
    pos = np.array([0, 5], np.int32)
    rc = dict(ref_layers.init_full_cache(rcfg, 1, 2, S))
    rc = {"k": rc["k"][0], "v": rc["v"][0], "pos": jnp.asarray(pos)}
    tc = layers.init_full_cache(cfg, 1, 2, S, device="cpu")
    tc = {"k": tc["k"][0], "v": tc["v"][0], "pos": torch.from_numpy(pos)}
    want, rnew = ref_attention(rp, jnp.asarray(x), rc)
    got, tnew = layers.attention(tp, torch.from_numpy(x), cfg=cfg,
                                 window=BIG_WINDOW, cache=tc)
    _close(got, want, 1e-4)
    assert tnew["k"].dtype == torch.bfloat16      # the reference's cache
    for name in ("k", "v"):
        # float32 K/V may round to a neighbouring bf16 value: 1 ulp
        np.testing.assert_allclose(_np(tnew[name]), _np(rnew[name]),
                                   rtol=2 ** -7, atol=1e-6)
    assert np.array_equal(tnew["pos"].numpy(), np.asarray(rnew["pos"]))


def test_cache_write_clamps_like_dynamic_update_slice():
    """A start past the end writes the LAST t rows, as the reference's
    lax.dynamic_update_slice does (the engine prefills every slot)."""
    new = np.arange(2 * 5 * 2 * 3, dtype=np.float32).reshape(2, 5, 2, 3)
    pos = np.array([9, 2], np.int32)
    want = ref_layers._update_cache(jnp.zeros((2, 12, 2, 3), jnp.bfloat16),
                                    jnp.asarray(new), jnp.asarray(pos))
    got = layers.batch_update(torch.zeros((2, 12, 2, 3),
                                          dtype=torch.bfloat16),
                              torch.from_numpy(new), torch.from_numpy(pos))
    assert np.array_equal(_np(got), _np(want))
    assert float(got[0, 7:].sum()) > 0 and float(got[0, :7].abs().sum()) == 0


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T):
    """The whole stack without a cache, every position's logits."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T + 2).integers(0, 256, (2, T))
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)


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
        assert tl.dtype == torch.float32
        _close(tl, rl, 2e-2)
        want, got = _np(rl)[:, -1], _np(tl)[:, -1]
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * 2e-2 * np.abs(want).max()
        assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
        checked += int(sure.sum())
    assert checked >= 6                 # a third of the 18 tokens decided


def _drive(engine_cls, scfg_cls, bundle, params):
    """Staggered admits, a shared prefix, the queue, cancel of a ticket
    and of a live slot, backfill, finish.  Returns what the engine
    reported."""
    rng = np.random.default_rng(11)
    eng = engine_cls(bundle, params, scfg_cls(max_seq=48, slots=2,
                                              queue_depth=2,
                                              prefix_reuse=True))
    pa = rng.integers(0, 256, 12)
    pb = np.concatenate([pa[:7], rng.integers(0, 256, 5)])   # shares 7
    pc, pd = rng.integers(0, 256, 9), rng.integers(0, 256, 6)
    log = [eng.add_request(pa)]
    for _ in range(3):
        log.append(eng.step())
    log.append(eng.add_request(pb))                  # prefix hit on slot 0
    for _ in range(2):
        log.append(eng.step())
    log += [eng.add_request(pc), eng.add_request(pd)]   # tickets -1, -2
    try:
        eng.add_request(pd)
    except Exception as e:                           # the queue is full
        log.append(type(e).__name__)
    log.append(eng.cancel(-2))                       # queued: removed
    log.append(eng.cancel(0))                        # live: backfilled by -1
    log.append(dict(eng.admitted))
    for _ in range(3):
        log.append(eng.step())
    log += [eng.finish(0), eng.finish(1)]
    log.append((eng.prefill_tokens_computed, eng.prefix_hits,
                eng.prefix_tokens_reused))
    return log


def test_engine_streams_equal_reference_engine(ref_params):
    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _drive(RefEngine, RefServeConfig, rb, rp)
    got = _drive(Engine, ServeConfig, tb, tp)
    assert got == want
    assert "SlotsExhausted" in got and got[-1][1] >= 1   # queue, reuse hit


def test_engine_keeps_other_slots_and_rejects_when_full(ref_params):
    rb, rp, tb, tp = _models(ref_params, "float32")
    eng = Engine(tb, tp, ServeConfig(max_seq=40, slots=2))
    rng = np.random.default_rng(12)
    p = rng.integers(0, 256, 10)
    solo = eng.generate(p, 6)
    sa = eng.add_request(p)
    for _ in range(2):
        eng.step()
    sb = eng.add_request(rng.integers(0, 256, 30))   # passes max_seq - pos
    for _ in range(3):
        eng.step()
    with pytest.raises(SlotsExhausted):
        eng.add_request(p)
    assert eng.finish(sa) == solo
    eng.finish(sb)


def test_load_engine_and_device_default():
    eng = load_engine(ARCH, slots=2, max_seq=32, device="cpu")
    out = eng.generate(np.arange(5), 4)
    assert len(out) == 9 and eng.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build(get_config(ARCH).reduced())          # device="cuda"
    # every registered architecture builds on the CPU
    from repro_torch.configs import ALL_ARCHS
    for name in ALL_ARCHS:
        assert build(get_config(name).reduced(), device="cpu").device == \
            torch.device("cpu"), name


LAYER_HELPERS = {
    "attn_params": lambda cfg, **kw: layers.attn_params(
        torch.Generator().manual_seed(0), cfg, **kw),
    "mlp_params": lambda cfg, **kw: layers.mlp_params(
        torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff, **kw),
    "norms_params": lambda cfg, **kw: layers.norms_params(
        cfg.d_model, ["pre_attn", "pre_mlp"], **kw),
    "init_full_cache": lambda cfg, **kw: layers.init_full_cache(
        cfg, 1, 2, 8, **kw),
    "cross_attn_params": lambda cfg, **kw: layers.cross_attn_params(
        torch.Generator().manual_seed(0), cfg, 32, **kw),
}


@pytest.mark.parametrize("name", sorted(LAYER_HELPERS))
def test_layer_helpers_default_to_the_card(name):
    """Each public layer helper puts its tensors on ``device``, which
    defaults to "cuda" and raises without a card."""
    cfg = get_config(ARCH).reduced()
    make = LAYER_HELPERS[name]
    made = make(cfg, device="cpu")
    assert made and all(t.device == torch.device("cpu")
                        for t in made.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            make(cfg)


def test_serving_port_imports_no_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch.serve, repro_torch.models, "
            "repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
