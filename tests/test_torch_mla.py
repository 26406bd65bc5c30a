"""MLA and deepseek-v3-671b in the port against the reference.

One MLA layer on the config of ``tests/test_mla_forms.py`` (d_model 32,
4 heads, q_lora 16, kv_lora 16, d_nope 8, d_rope 4, d_v 8), and the
model on ``get_config("deepseek-v3-671b").reduced()``: 4 layers, the
first dense (MLA attention, a plain d_ff FFN), 3 moe layers of 8
experts top-2 plus 1 shared, dropless (capacity factor 8), the MTP
head; MLA at q_lora 32, kv_lora 16, d_nope 16, d_rope 8, d_v 16.  The
reference's own weights come across by ``from_jax_params``, with
nonzero norm scales (q_norm and kv_norm among them), so that a scale
read from the wrong place shows; tokens and inputs from numpy seeds.

Tolerances, each with its reason:

* float32: within rtol 1e-4 plus 1e-4 of max|value| (2e-4 where a bf16
  cache is read back: ``tests/test_torch_moe.py``), greedy tokens
  identical.  The frameworks sum matrix products in other orders.
* naive against absorbed, one layer in float32: the reference's own
  bound for the two forms (rtol = atol = 2e-3, ``test_mla_forms.py``).
  In bf16 the two forms round at other points (K and V expanded and
  rounded, or q folded into the latent and rounded); their outputs
  part by ``MLA_FORMS_BF16_TOL`` at most, Frobenius-relative, which the
  card's check of the full-width layer reuses.
* the model in bf16: the moe family's outlier share
  (``tests/test_torch_moe.py``): near-tie top-k choices flip under
  rounding in the reference too.
* decode after prefill against the forward: the reference's MoE budget.

A forward of 1024 tokens takes the naive form in every layer (flash
attention at Dh 24, Dv 16: on the CPU its plain dispatch); shorter
ones and every decode step the absorbed form.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ArchConfig, MLACfg  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, mla  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train import step as port_step  # noqa: E402

ARCH = "deepseek-v3-671b"
# the reference's layer, jitted (op by op it compiles each op)
ref_attention = jax.jit(ref_mla.mla_attention, static_argnames=("cfg",))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# naive against absorbed in bf16, Frobenius-relative: 4.5e-3 to 5.0e-3
# on the layer below at T 40 and 1024 over three inputs (each bf16 form
# 6e-3 to 7e-3 from the float32 one); four times that
MLA_FORMS_BF16_TOL = 2e-2
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel=1e-4, of_max=None):
    got, want = _np(got), _np(want)
    bound = (rel if of_max is None else of_max) * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=bound)


def _fro(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ref_init(bundle, seed):
    """The reference's params (its init jitted; the specs dropped)."""
    return jax.jit(lambda k: bundle.init(k)[0])(jax.random.PRNGKey(seed))


def _draw_norms(tree, rng):
    """Every leaf whose name holds "norm" drawn N(0, 0.2), in place."""
    for name, v in tree.items():
        if isinstance(v, dict):
            _draw_norms(v, rng)
        elif "norm" in name:
            tree[name] = jnp.asarray(rng.normal(0, 0.2, v.shape), jnp.float32)


# ----------------------------------------------------------------------
# one layer
# ----------------------------------------------------------------------
def _layer_cfg():
    kw = dict(name="mla-test", family="moe", n_layers=1, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=64, vocab=128, d_head=8)
    return ArchConfig(**kw, mla=MLACfg(q_lora=16, kv_lora=16, d_nope=8,
                                       d_rope=4, d_v=8))


@pytest.fixture(scope="module")
def layer():
    """The reference's layer params (jax, one layer of the stack) and
    the port's (torch, float32)."""
    cfg = _layer_cfg()
    rp = jax.jit(lambda k: jax.tree.map(
        lambda a: a[0], ref_mla.mla_params(k, cfg, n_layers=1)[0]))(
            jax.random.PRNGKey(0))
    _draw_norms(rp, np.random.default_rng(3))
    tp = {n: torch.from_numpy(np.array(a)) for n, a in rp.items()}
    return cfg, rp, tp


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def test_params_keep_the_references_shapes_and_f32_norms(layer):
    cfg, rp, _ = layer
    got = mla.mla_params(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.bfloat16, device="cpu")
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(a.shape) for n, a in rp.items()}
    assert {n for n, t in got.items() if t.dtype == torch.float32} == \
        {"q_norm", "kv_norm"}
    cache = mla.init_mla_cache(cfg, 3, 2, 16, device="cpu")
    assert tuple(cache["ckv"].shape) == (3, 2, 16, 20)
    assert cache["ckv"].dtype == torch.bfloat16


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_matches_reference(layer, T):
    """The full-sequence form the reference picks at T: absorbed at 40,
    naive (flash) at 1024."""
    cfg, rp, tp = layer
    x = _x(cfg, 2, T, T)
    want, _ = ref_attention(rp, jnp.asarray(x), cfg=cfg)
    got, none = mla.mla_attention(tp, torch.from_numpy(x), cfg)
    assert none is None
    _close(got, want)


@pytest.mark.parametrize("T", [40, 1024])
def test_naive_and_absorbed_forms_agree(layer, T):
    """The two forms on one input: float32 within the reference's
    bound; bf16 (the served dtype) within MLA_FORMS_BF16_TOL."""
    cfg, _, tp = layer
    x = torch.from_numpy(_x(cfg, 2, T, 7))
    naive, _ = mla.mla_attention(tp, x, cfg, naive=True)
    absorbed, _ = mla.mla_attention(tp, x, cfg, naive=False)
    np.testing.assert_allclose(naive.numpy(), absorbed.numpy(), rtol=2e-3,
                               atol=2e-3)
    tb = {n: t if t.dtype == torch.float32 and "norm" in n
          else t.to(torch.bfloat16) for n, t in tp.items()}
    xb = x.to(torch.bfloat16)
    nb, _ = mla.mla_attention(tb, xb, cfg, naive=True)
    ab, _ = mla.mla_attention(tb, xb, cfg, naive=False)
    assert nb.dtype == ab.dtype == torch.bfloat16
    assert _fro(nb, ab) <= MLA_FORMS_BF16_TOL
    assert _fro(ab, absorbed) <= MLA_FORMS_BF16_TOL


@pytest.mark.parametrize("T", [12, 1024])
def test_cache_prefill_then_decode_match_reference(layer, T):
    """A bf16 cache: prefill T rows from 0 (and a second slot from 5),
    then 3 decode steps; outputs within the float32 gate (2e-4 of the
    range: the chunk's own rows are read back rounded) and the cache's
    bits equal."""
    cfg, rp, tp = layer
    B, Tmax = 2, T + 16
    x = _x(cfg, B, T + 3, 11)
    pos0 = np.array([0, 5], np.int32)
    rc = {"ckv": jnp.zeros((B, Tmax, 20), jnp.bfloat16),
          "pos": jnp.asarray(pos0)}
    tc = {"ckv": mla.init_mla_cache(cfg, 1, B, Tmax, device="cpu")["ckv"][0],
          "pos": torch.from_numpy(pos0)}
    for lo, hi in ((0, T), (T, T + 1), (T + 1, T + 2), (T + 2, T + 3)):
        want, rc = ref_attention(rp, jnp.asarray(x[:, lo:hi]), cfg=cfg,
                                 cache=rc)
        got, tc = mla.mla_attention(tp, torch.from_numpy(x[:, lo:hi]), cfg,
                                    cache=tc)
        _close(got, want, 1e-4, of_max=2e-4)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
        diff = _np(tc["ckv"]) != _np(rc["ckv"])
        # a value on a bf16 rounding midpoint may round either way
        assert diff.mean() <= 1e-3


def test_f32_prefill_reads_its_rows_back_rounded(layer):
    """A float32 prefill attends to the bf16 rows the cache holds, as the
    reference's: with unrounded rows its output parts from the
    reference's by far more than the float32 gate."""
    cfg, rp, tp = layer
    x = _x(cfg, 1, 40, 5)
    rc = {"ckv": jnp.zeros((1, 48, 20), jnp.bfloat16),
          "pos": jnp.zeros((1,), jnp.int32)}
    want, _ = ref_attention(rp, jnp.asarray(x), cfg=cfg, cache=rc)
    tc = {"ckv": torch.zeros((1, 48, 20), dtype=torch.bfloat16),
          "pos": torch.zeros((1,), dtype=torch.int32)}
    got, _ = mla.mla_attention(tp, torch.from_numpy(x), cfg, cache=tc)
    _close(got, want, 1e-4, of_max=2e-4)
    exact, _ = mla.mla_attention(tp, torch.from_numpy(x), cfg)
    assert np.abs(_np(exact) - _np(want)).max() > \
        10 * np.abs(_np(got) - _np(want)).max()


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_get_config(ARCH).reduced()
    params = _ref_init(ref_build(cfg), 0)
    _draw_norms(params, np.random.default_rng(0))
    return params, jax.tree.map(np.asarray, params)


def _models(ref_params, dtype):
    jdt, tdt = DTYPES[dtype]
    params, params_np = ref_params
    cfg, rcfg = get_config(ARCH).reduced(), ref_get_config(ARCH).reduced()
    rb = ref_build(rcfg, jdt)
    tb = build(cfg, tdt, "cpu")
    tp = from_jax_params(params_np, cfg, device="cpu", compute_dtype=tdt)
    return rb, params, tb, tp


def test_reduced_config_and_converter(ref_params):
    """1 dense layer, 3 moe layers, the MTP block; the router, norms,
    q_norm and kv_norm float32, every matrix bf16; the port's init
    gives the same groups and shapes."""
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.dense_layers, cfg.mtp) == (4, 1, True)
    _, params_np = ref_params
    tp = from_jax_params(params_np, cfg, device="cpu")
    init = build(cfg, torch.bfloat16, "cpu").init(0)
    for got in (tp, init):
        assert [len(got[g]) for g in ("dense", "main", "mtp")] == [1, 3, 1]
        assert tuple(got["mtp_proj"].shape) == (2 * cfg.d_model, cfg.d_model)
        for g in ("dense", "main", "mtp"):
            for layer in got[g]:
                assert layer["attn"]["q_norm"].dtype == torch.float32
                assert layer["attn"]["kv_norm"].dtype == torch.float32
                assert layer["attn"]["wk_b"].dtype == torch.bfloat16
                assert all(t.dtype == torch.float32
                           for t in layer["norms"].values())
                assert ("router" in layer["ffn"]) == (g == "main")
        assert got["main"][0]["ffn"]["router"].dtype == torch.float32
        assert got["main"][0]["ffn"]["shared"]["w_up"].dtype == \
            torch.bfloat16
        assert "w_gate" in got["dense"][0]["ffn"]
        assert tuple(got["dense"][0]["ffn"]["w_gate"].shape) == \
            (cfg.d_model, cfg.d_ff)
    for g in ("dense", "main", "mtp"):
        for i, layer in enumerate(tp[g]):
            for n in ("q_norm", "kv_norm"):
                assert np.array_equal(layer["attn"][n].numpy(),
                                      params_np[g]["attn"][n][i])
    assert set(tp) == set(init)


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T):
    """Logits, MTP logits and the summed aux loss."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T + 2).integers(0, 256, (2, T))
    want, wout = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, out = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    _close(out["mtp_logits"], wout["mtp_logits"])
    assert float(out["aux_loss"]) > 0
    np.testing.assert_allclose(float(out["aux_loss"]),
                               float(wout["aux_loss"]), rtol=1e-5)


def test_forward_fused_matches_reference(ref_params):
    rb, rp, tb, tp = _models(ref_params, "float32")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 40))
    labels = rng.integers(0, 256, (2, 40))
    mask = (rng.random((2, 40)) > 0.2).astype(np.float32)
    want, wm = jax.jit(rb.forward_fused)(rp, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "mask": jnp.asarray(mask)})
    got, m = tb.forward_fused(tp, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
        "mask": torch.from_numpy(mask)})
    assert list(m) == ["ce", "mtp", "aux"]
    for k in ("ce", "mtp", "aux"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("vocab", [None, 65536])
def test_eval_step_loss_matches_reference(vocab):
    """CE + 0.3 MTP + 0.01 aux, through the plain loss and, at a
    vocabulary of 65536, the fused head + CE."""
    cfg, rcfg = get_config(ARCH).reduced(), ref_get_config(ARCH).reduced()
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
        rcfg = dataclasses.replace(rcfg, vocab=vocab)
    rb = ref_build(rcfg, jnp.float32)
    rp = _ref_init(rb, 1)
    tb = build(cfg, torch.float32, "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, rp), cfg, device="cpu",
                         compute_dtype=torch.float32)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones((2, 24), np.float32)}
    want = jax.jit(ref_step.make_eval_step(rb))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = port_step.make_eval_step(tb)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "mtp", "aux"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **LOSS_TOL)


def _prefill_decode(rb, rp, tb, tp, prompts, steps, max_seq):
    """Prefill both models, then decode greedily, feeding both the
    reference's tokens.  Yields (ref_logits, port_logits) per step."""
    rc, tc = rb.init_cache(2, max_seq), tb.init_cache(2, max_seq)
    prefill, decode = jax.jit(rb.prefill), jax.jit(rb.decode)
    toks = np.asarray(prompts, np.int32)
    rl, rc = prefill(rp, {"tokens": jnp.asarray(toks)}, rc)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    assert set(tc) == {"dense", "main"}
    assert all(int(g["pos"][0]) == toks.shape[1] for g in tc.values())
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
    for rl, tl in _prefill_decode(rb, rp, tb, tp, prompts, 4, T + 8):
        _close(tl, rl, 1e-4, of_max=2e-4)
        assert np.array_equal(np.argmax(_np(tl), -1), np.argmax(_np(rl), -1))


def test_forward_bf16_within_the_references_own_spread(ref_params):
    """Pooled over 4 prompts: the share of the port's bf16 logits beyond
    2e-2 of the range from the reference's bf16 logits, against the
    share of the reference's bf16 logits beyond it from its float32
    ones (``tests/test_torch_moe.py``'s gate)."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    fwd, fwd32 = jax.jit(rb.forward), jax.jit(rb32.forward)
    port_out, ref_out = [], []
    for seed in range(4):
        toks = np.random.default_rng(seed).integers(0, 256, (2, 40))
        ref16 = _np(fwd(rp, {"tokens": jnp.asarray(toks)})[0])
        ref32 = _np(fwd32(rp, {"tokens": jnp.asarray(toks)})[0])
        got = tb.forward(tp, {"tokens": torch.from_numpy(toks)})[0]
        assert got.dtype == torch.float32
        span = np.abs(ref32).max()
        port_out.append(np.abs(_np(got) - ref16) > 2e-2 * span)
        ref_out.append(np.abs(ref16 - ref32) > 2e-2 * span)
    port_share, ref_share = np.mean(port_out), np.mean(ref_out)
    assert port_share <= min(ref_share, 0.05), (port_share, ref_share)


def test_decode_consistent_with_forward(ref_params):
    """The port's decode after prefill against its forward over the
    sequence one token longer, under the reference's MoE budget."""
    _, _, tb, tp = _models(ref_params, "float32")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (B, S)))
    cache = tb.init_cache(B, S + 8)
    pre, cache = tb.prefill(tp, {"tokens": toks}, cache)
    nxt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, 1)))
    dec, _ = tb.decode(tp, {"token": nxt,
                            "pos": torch.full((B,), S, dtype=torch.int32)},
                       cache)
    full, _ = tb.forward(tp, {"tokens": torch.cat([toks, nxt], 1)})
    a, b = dec[:, 0].numpy(), full[:, -1].numpy()
    close = np.isclose(a, b, rtol=2e-2, atol=2e-2)
    assert 1.0 - close.mean() <= 0.05
    assert np.abs(a - b).max() <= 0.12


def _drive(engine_cls, scfg_cls, bundle, params):
    """Staggered admits (one sharing a prefix), decode steps, finishes,
    a generate.  Returns what the engine reported."""
    rng = np.random.default_rng(17)
    eng = engine_cls(bundle, params, scfg_cls(max_seq=48, slots=2,
                                              prefix_reuse=True))
    pa = rng.integers(0, 256, 14)
    pb = np.concatenate([pa[:6], rng.integers(0, 256, 7)])
    log = [eng.add_request(pa)]
    for _ in range(4):
        log.append(eng.step())
    log.append(eng.add_request(pb))
    for _ in range(6):
        log.append(eng.step())
    log += [eng.finish(0), eng.finish(1)]
    log.append(eng.generate(rng.integers(0, 256, 11), 8))
    log.append((eng.prefill_tokens_computed, eng.prefix_hits))
    return log


def test_engine_streams_equal_reference_engine(ref_params):
    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _drive(RefEngine, RefServeConfig, rb, rp)
    got = _drive(Engine, ServeConfig, tb, tp)
    assert got == want
    assert got[-1][1] == 1


def test_load_engine_and_train_setup_take_deepseek_v3():
    from repro_torch.launch.serve import load_engine, main
    from repro_torch.launch.train import setup, train

    eng = load_engine(ARCH, slots=2, max_seq=32, device="cpu")
    out = eng.generate(np.arange(9), 4)
    assert len(out) == 13 and all(0 <= t < eng.cfg.vocab for t in out)
    assert set(eng.cache) == {"dense", "main"}
    main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
          "--tokens", "2"])
    run = setup(ARCH, seq_len=16, global_batch=2, device="cpu")
    got = train(run, 2, verbose=False)
    assert np.isfinite(got["losses"]).all() and len(got["losses"]) == 2
