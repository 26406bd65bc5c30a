"""recurrentgemma-2b in the port against the reference, on
``get_config("recurrentgemma-2b").reduced()`` (4 layers: rec, rec,
attn, rec; d_model 64, lru_width 64, 4/1 heads of 16, window 16, tanh
gelu) with the reference's own weights carried across by
``from_jax_params``.

Tolerances (float32 as ``tests/test_torch_gemma2.py`` states them):

* float32 compute: logits within rtol 1e-4 (plus 2e-4 of max|logit|
  where the bf16 ring is read: a K or V value may round to the
  neighbouring bf16 value), greedy tokens identical;
* bfloat16 compute: the reference's own bf16 spread.  Two bf16
  programs that round at other points part by more than 2e-2 of
  max|logit| on this config: the reference's jitted and op-by-op
  (``jax.disable_jit()``) programs part by up to 3.2% of it, and its
  jitted bf16 logits leave its float32 ones by up to 6.2% (forward at
  T = 40, prompts of seeds 0-4).  The gate is that, pooled over the
  prompts (or the decode steps), the port's bf16 logits leave the
  reference's jitted bf16 logits beyond 2e-2 of the range on no larger
  a share than those leave the reference's float32 logits; that their
  largest gap is at most sqrt(2) times the reference's own (the gap
  between two programs that each round as much as the reference,
  independently); and that the greedy tokens are equal where the
  reference's top-2 margin exceeds twice its own largest gap.

A prompt of 40 tokens fills the ring of 16 more than twice over, and
the decode steps after it wrap the ring again.  Prompts of 1024
tokens take flash attention's banded plain version with the window.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, layers  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "recurrentgemma-2b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_get_config(ARCH).reduced()
    params, _ = ref_build(cfg).init(jax.random.PRNGKey(0))
    # lam spread over decays near 1 and near 0 (the init's 4.0 gives
    # a ~ 1e-7), so that the recurrent state carries across steps
    rng = np.random.default_rng(0)
    params["rec"]["lam"] = jnp.asarray(
        rng.uniform(-6, 4, params["rec"]["lam"].shape), jnp.float32)
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


def test_reduced_config_is_three_rec_and_one_attention():
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.window, cfg.rg.lru_width) == \
        (4, 64, 4, 1, 16, 16, 64)
    tp = build(cfg, torch.float32, "cpu").init(0)
    assert (len(tp["rec"]), len(tp["attn"]), len(tp["mlp"]),
            len(tp["norms"])) == (3, 1, 4, 4)


def test_from_jax_params_keeps_lam_biases_and_norms_float32(ref_params):
    _, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    tp = from_jax_params(params_np, cfg, device="cpu",
                         compute_dtype=torch.bfloat16)
    rec = tp["rec"][1]
    assert {n: rec[n].dtype for n in ("lam", "conv_b", "b_a", "b_i")} == \
        dict.fromkeys(("lam", "conv_b", "b_a", "b_i"), torch.float32)
    assert {n: rec[n].dtype for n in ("w_x", "w_g", "conv_w", "w_a", "w_i",
                                      "w_out")} == dict.fromkeys(
        ("w_x", "w_g", "conv_w", "w_a", "w_i", "w_out"), torch.bfloat16)
    assert np.array_equal(rec["lam"].numpy(), params_np["rec"]["lam"][1])
    assert all(t.dtype == torch.float32 for n in tp["norms"]
               for t in n.values())
    assert tp["attn"][0]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T, monkeypatch):
    """The whole stack without a cache; at T = 1024 the attention layer
    goes through flash attention with the window."""
    calls = []
    flash = layers.flash_attention

    def spy(*args, **kw):
        calls.append(kw["window"])
        return flash(*args, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T + 2).integers(0, 256, (2, T))
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)
    assert float(aux["aux_loss"]) == 0.0
    assert calls == ([tb.cfg.window] if T >= layers.FLASH_MIN_T else [])


def _within_own_spread(port, ref16, ref32):
    """The bf16 gate of the module's docstring, over lists of logits
    pooled together; returns the reference's own largest gap."""
    port, ref16, ref32 = (np.concatenate([_np(a).ravel() for a in x])
                          for x in (port, ref16, ref32))
    span = np.abs(ref32).max()
    port_gap, ref_gap = np.abs(port - ref16), np.abs(ref16 - ref32)
    assert port_gap.max() <= np.sqrt(2) * ref_gap.max(), \
        (port_gap.max(), ref_gap.max())
    assert np.mean(port_gap > 2e-2 * span) <= np.mean(ref_gap > 2e-2 * span)
    return float(ref_gap.max())


def test_forward_bf16_matches_reference(ref_params):
    """Pooled over 4 prompts, within the reference's own bf16 spread."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    fwd, fwd32 = jax.jit(rb.forward), jax.jit(rb32.forward)
    port, ref16, ref32 = [], [], []
    for seed in range(4):
        toks = np.random.default_rng(seed).integers(0, 256, (2, 40))
        ref16.append(fwd(rp, {"tokens": jnp.asarray(toks)})[0])
        ref32.append(fwd32(rp, {"tokens": jnp.asarray(toks)})[0])
        got, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
        assert got.dtype == torch.float32
        port.append(got)
    _within_own_spread(port, ref16, ref32)


def test_forward_fused_and_grad_on_cpu(ref_params):
    """The train path runs on the CPU (each layer checkpointed) and
    gives the loss of the logits; its gradients are finite."""
    _, _, tb, tp = _models(ref_params, "float32")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 24)))
    labels = torch.from_numpy(rng.integers(0, 256, (2, 24)))
    w = tp["rec"][0]["w_a"].requires_grad_()
    loss, _ = tb.forward_fused(tp, {"tokens": toks, "labels": labels})
    logits, _ = tb.forward(tp, {"tokens": toks})
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 256),
                                             labels.reshape(-1))
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(loss, [w])
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def _prefill_decode(rb, rp, tb, tp, prompts, steps, rb32=None):
    """Prefill both models, then decode greedily, feeding both the
    reference's tokens.  Yields (ref_logits, port_logits) per step, and
    with ``rb32`` the float32 reference's logits on the same tokens as a
    third."""
    refs = [rb] + ([rb32] if rb32 is not None else [])
    rcs = [r.init_cache(2, 64) for r in refs]
    tc = tb.init_cache(2, 64)
    toks = np.asarray(prompts, np.int32)
    rls = []
    for n, r in enumerate(refs):
        rl, rcs[n] = jax.jit(r.prefill)(rp, {"tokens": jnp.asarray(toks)},
                                        rcs[n])
        rls.append(rl)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    yield (rls[0], tl, *rls[1:])
    pos = np.full(2, toks.shape[1], np.int32)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(rls[0])[:, -1], axis=-1).astype(np.int32)
        for n, r in enumerate(refs):
            rls[n], rcs[n] = jax.jit(r.decode)(
                rp, {"token": jnp.asarray(nxt[:, None]),
                     "pos": jnp.asarray(pos)}, rcs[n])
        tl, tc = tb.decode(tp, {"token": torch.from_numpy(nxt[:, None]).long(),
                                "pos": torch.from_numpy(pos.copy())}, tc)
        pos = pos + 1
        assert np.array_equal(tc["pos"].numpy(), pos)
        yield (rls[0], tl, *rls[1:])


@pytest.mark.parametrize("T", [40, 9])
def test_prefill_decode_f32_matches_reference(ref_params, T):
    """Decode steps that wrap the ring of 16: after a 40-token prompt
    that filled it more than twice, and after a 9-token one."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    prompts = np.random.default_rng(T).integers(0, 256, (2, T))
    for rl, tl in _prefill_decode(rb, rp, tb, tp, prompts, 20):
        _close(tl, rl, 1e-4, of_max=2e-4)
        assert np.array_equal(np.argmax(_np(tl), -1), np.argmax(_np(rl), -1))


@pytest.mark.parametrize("T", [40, 9])
def test_prefill_decode_bf16_matches_reference(ref_params, T):
    """Pooled over the prefill and 20 decode steps, within the
    reference's own bf16 spread."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    prompts = np.random.default_rng(T + 1).integers(0, 256, (2, T))
    steps = [tuple(_np(a)[:, -1] for a in step) for step in
             _prefill_decode(rb, rp, tb, tp, prompts, 20, rb32=rb32)]
    ref16, port, ref32 = zip(*steps)
    gap = _within_own_spread(port, ref16, ref32)
    want, got = np.stack(ref16), np.stack(port)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * gap
    assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    assert int(sure.sum()) >= 14         # a third of the 42 tokens decided


def _drive(engine_cls, scfg_cls, bundle, params):
    """Staggered admits, decode steps past the window, finishes, one
    generate.  Returns what the engine reported."""
    rng = np.random.default_rng(13)
    eng = engine_cls(bundle, params, scfg_cls(max_seq=64, slots=2,
                                              prefix_reuse=True))
    pa = rng.integers(0, 256, 20)
    pb = np.concatenate([pa[:9], rng.integers(0, 256, 8)])
    log = [eng.supports_prefix_reuse, eng.add_request(pa)]
    for _ in range(6):
        log.append(eng.step())
    log.append(eng.add_request(pb))
    for _ in range(12):
        log.append(eng.step())
    log += [eng.finish(0), eng.finish(1)]
    log.append((eng.prefill_tokens_computed, eng.prefix_hits))
    return log


def test_engine_streams_equal_reference_engine(ref_params):
    """Fresh slots; prefix reuse asked for but off in both packages,
    since the recurrent state and the ring fold history into state."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _drive(RefEngine, RefServeConfig, rb, rp)
    got = _drive(Engine, ServeConfig, tb, tp)
    assert got == want
    assert got[0] is False and got[-1] == (37, 0)


def _reuse(engine_cls, scfg_cls, bundle, params):
    """Prompt B in a fresh one-slot engine, and again in the same slot
    after prompt A.  Returns both streams of B."""
    rng = np.random.default_rng(17)
    pa, pb = rng.integers(0, 256, 12), rng.integers(0, 256, 10)
    fresh = engine_cls(bundle, params, scfg_cls(max_seq=64, slots=1))
    b_fresh = fresh.generate(pb, 12)
    eng = engine_cls(bundle, params, scfg_cls(max_seq=64, slots=1))
    eng.generate(pa, 12)
    return b_fresh, eng.generate(pb, 12)


def test_reused_slot_keeps_the_reference_engines_streams(ref_params):
    """Both engines reset only ``pos`` when a slot is reused, so B's
    prefill starts from A's recurrent state and conv tail.  The port
    keeps the reference's behaviour (parity, not a fix: ROADMAP Queue
    3 records the fault)."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    assert _reuse(Engine, ServeConfig, tb, tp) == \
        _reuse(RefEngine, RefServeConfig, rb, rp)


def test_cache_is_the_references_and_independent_of_t_max(ref_params):
    rb, _, tb, _ = _models(ref_params, "bfloat16")
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in rb.init_cache(3, 64).items()}
    for T_max in (64, 4096):
        got = tb.init_cache(3, T_max)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == want
        assert bool((got["att_kpos"] == -1).all())
    meta = tb.init_cache(3, 64, "meta")
    assert all(t.device.type == "meta" for t in meta.values())
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: v[0] for k, v in want.items()}


def test_load_engine_serves_recurrentgemma(capsys):
    from repro_torch.launch.serve import load_engine, main

    main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
          "--tokens", "4"])
    assert "1 requests, 4 tokens" in capsys.readouterr().out

    eng = load_engine(ARCH, slots=2, max_seq=48, device="cpu")
    assert eng.supports_prefix_reuse is False
    out = eng.generate(np.arange(20), 24)      # past the window of 16
    assert len(out) == 44 and all(0 <= t < eng.cfg.vocab for t in out)


def test_build_defaults_to_the_card():
    cfg = get_config(ARCH).reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build(cfg)
    assert build(cfg, device="cpu").device == torch.device("cpu")
