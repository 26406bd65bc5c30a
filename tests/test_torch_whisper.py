"""whisper-base in the port against the reference, on
``get_config("whisper-base").reduced()`` (2 encoder and 4 decoder
layers, 16 frames, d_model 64, 4 heads of 16, the plain tanh-gelu MLP)
with the reference's own weights carried across by
``from_jax_params``; tokens and frames from numpy seeds.

Tolerances:

* float32 compute: logits within rtol 1e-4 plus 1e-4 of max|logit|
  (the decoder's self-attention K and V, and decode's cross K/V, pass
  through the bf16 cache, where a value may round to the neighbouring
  bf16 value), greedy tokens identical, every bf16 cache leaf within
  one bf16 ulp of the reference's (a value far below its leaf's scale
  within the gate's absolute part, 1e-4 of the leaf's max|value|);
* bfloat16 compute: the reference's own bf16 spread, the gate of
  ``tests/test_torch_recurrentgemma.py``: pooled, the port's bf16
  logits leave the reference's jitted bf16 logits beyond 2e-2 of the
  range on no larger a share than those leave the reference's float32
  logits; their largest gap is at most sqrt(2) times the reference's
  own; greedy tokens equal where the reference's top-2 margin exceeds
  twice its own largest gap.  One cross-attention layer in bf16: within
  2e-2 of the range.

A forward of 1024 tokens takes the decoder's flash branch
(``layers.FLASH_MIN_T``) without a window; the encoder and both
cross-attentions stay dense, as in the reference.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, layers  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "whisper-base"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_get_config(ARCH).reduced()
    params, _ = ref_build(cfg).init(jax.random.PRNGKey(0))
    # nonzero norm scales, so that a scale read from the wrong layer
    # or norm shows
    rng = np.random.default_rng(0)
    draw = lambda a: jnp.asarray(rng.normal(0, 0.2, a.shape),  # noqa: E731
                                 jnp.float32)
    for group in (params["enc"]["norms"], params["dec"]["norms"]):
        for name in group:
            group[name] = draw(group[name])
    params["enc"]["final_norm"] = draw(params["enc"]["final_norm"])
    return params, jax.tree.map(np.asarray, params)


def _models(ref_params, dtype):
    jdt, tdt = DTYPES[dtype]
    params, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    rb = ref_build(ref_get_config(ARCH).reduced(), jdt)
    tb = build(cfg, tdt, "cpu")
    tp = from_jax_params(params_np, cfg, device="cpu", compute_dtype=tdt)
    return rb, params, tb, tp


def _frames(seed, B=2):
    cfg = get_config(ARCH).reduced()
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel=1e-4):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _within_one_bf16_ulp(got, want):
    """Each element within one bf16 ulp of its magnitude or, for a value
    far below the leaf's scale, within the float32 gate's absolute part
    (1e-4 of the leaf's max|value|): an error of the float32 path that
    large moves a small value by more than its ulp."""
    got, want = _np(got), _np(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    tol = np.maximum(ulp, 1e-4 * np.abs(want).max())
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


def test_reduced_config_is_two_encoder_and_four_decoder_layers():
    cfg = get_config(ARCH).reduced()
    assert (cfg.encdec.n_enc_layers, cfg.n_layers, cfg.encdec.n_frames,
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
        (2, 4, 16, 64, 4, 4, 16)
    tp = build(cfg, torch.float32, "cpu").init(0)
    assert {g: len(v) for g, v in tp["enc"].items() if g != "final_norm"} \
        == {"attn": 2, "mlp": 2, "norms": 2}
    assert {g: len(v) for g, v in tp["dec"].items()} == \
        {"attn": 4, "cross": 4, "mlp": 4, "norms": 4}
    assert set(tp["dec"]["mlp"][0]) == {"w1", "w2"}


def test_from_jax_params_trees_and_dtypes(ref_params):
    _, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    tp = from_jax_params(params_np, cfg, device="cpu",
                         compute_dtype=torch.bfloat16)
    enc, dec = tp["enc"], tp["dec"]
    assert tp["emb"]["in_emb"].dtype == torch.bfloat16
    assert enc["final_norm"].dtype == torch.float32
    assert np.array_equal(enc["final_norm"].numpy(),
                          params_np["enc"]["final_norm"])
    for group, names in ((enc, ("pre_attn", "pre_mlp")),
                         (dec, ("pre_attn", "pre_cross", "pre_mlp"))):
        assert all(set(n) == set(names) and all(
            t.dtype == torch.float32 for t in n.values())
            for n in group["norms"])
    assert np.array_equal(dec["norms"][3]["pre_cross"].numpy(),
                          params_np["dec"]["norms"]["pre_cross"][3])
    cross = dec["cross"][2]
    assert {n: (tuple(t.shape), t.dtype) for n, t in cross.items()} == {
        "wq": ((64, 64), torch.bfloat16), "wk": ((64, 64), torch.bfloat16),
        "wv": ((64, 64), torch.bfloat16), "wo": ((64, 64), torch.bfloat16)}
    want = torch.tensor(params_np["dec"]["cross"]["wk"][2]).bfloat16()
    assert torch.equal(cross["wk"], want)
    assert enc["mlp"][1]["w2"].shape == (cfg.d_ff, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """``layers.cross_attention`` against the reference's function,
    on a source of 12 positions and another width (32)."""
    jdt, tdt = DTYPES[dtype]
    cfg = get_config(ARCH).reduced()
    p, _ = ref_layers.cross_attn_params(jax.random.PRNGKey(3), cfg, 1, 32)
    p = {n: w[0] for n, w in p.items()}
    tp = layers.cross_attn_params(torch.Generator().manual_seed(0), cfg, 32,
                                  device="cpu")
    assert {n: tuple(t.shape) for n, t in tp.items()} == \
        {n: tuple(w.shape) for n, w in p.items()}
    tp = {n: torch.tensor(np.asarray(w)) for n, w in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 12, 32)).astype(np.float32)
    want = ref_layers.cross_attention(p, jnp.asarray(x, jdt),
                                      jnp.asarray(src, jdt), cfg=cfg)
    got = layers.cross_attention(tp, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(src).to(tdt), cfg=cfg)
    assert got.dtype == tdt and got.shape == (2, 7, cfg.d_model)
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T, monkeypatch):
    """Encoder, cross K/V and decoder without a cache; at T = 1024 each
    decoder layer's self-attention goes through flash attention,
    without a window."""
    calls = []
    flash = layers.flash_attention

    def spy(*args, **kw):
        calls.append(kw["window"])
        return flash(*args, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T).integers(0, 256, (2, T))
    frames = _frames(T)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks),
                                       "frames": jnp.asarray(frames)})
    got, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks),
                               "frames": frames})
    _close(got, want)
    assert float(aux["aux_loss"]) == 0.0
    assert calls == ([None] * 4 if T >= layers.FLASH_MIN_T else [])


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


def test_forward_bf16_within_the_references_spread(ref_params):
    """Pooled over 4 prompts and their frames."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    fwd, fwd32 = jax.jit(rb.forward), jax.jit(rb32.forward)
    port, ref16, ref32 = [], [], []
    for seed in range(4):
        toks = np.random.default_rng(seed).integers(0, 256, (2, 40))
        batch = {"tokens": jnp.asarray(toks),
                 "frames": jnp.asarray(_frames(seed + 10))}
        ref16.append(fwd(rp, batch)[0])
        ref32.append(fwd32(rp, batch)[0])
        got, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks),
                                 "frames": _frames(seed + 10)})
        assert got.dtype == torch.float32
        port.append(got)
    _within_own_spread(port, ref16, ref32)


def _prefill_decode(rb, rp, tb, tp, prompts, frames, steps, rb32=None):
    """Prefill both models, then decode greedily, feeding both the
    reference's tokens.  Yields (ref_logits, port_logits, ref_cache,
    port_cache) per step, with ``rb32`` also the float32 reference's
    logits on the same tokens."""
    refs = [rb] + ([rb32] if rb32 is not None else [])
    rcs = [r.init_cache(2, 64) for r in refs]
    tc = tb.init_cache(2, 64)
    toks = np.asarray(prompts, np.int32)
    rls = []
    for n, r in enumerate(refs):
        rl, rcs[n] = jax.jit(r.prefill)(rp, {"tokens": jnp.asarray(toks),
                                             "frames": jnp.asarray(frames)},
                                        rcs[n])
        rls.append(rl)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "frames": frames}, tc)
    yield (rls[0], tl, rcs[0], tc, *rls[1:])
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
        yield (rls[0], tl, rcs[0], tc, *rls[1:])


def test_prefill_decode_f32_matches_reference(ref_params):
    """The prefill's last logits, 8 decode steps' logits and greedy
    tokens, and after each every cache leaf: the bf16 self-attention
    K/V and cross K/V within one bf16 ulp, ``pos`` equal."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    prompts = np.random.default_rng(5).integers(0, 256, (2, 24))
    for rl, tl, rc, tc in _prefill_decode(rb, rp, tb, tp, prompts,
                                          _frames(5), 8):
        _close(tl, rl)
        assert np.array_equal(np.argmax(_np(tl), -1), np.argmax(_np(rl), -1))
        assert set(tc) == set(rc) == {"k", "v", "cross_k", "cross_v", "pos"}
        for name in ("k", "v", "cross_k", "cross_v"):
            assert tc[name].dtype == torch.bfloat16
            _within_one_bf16_ulp(tc[name], rc[name])
        assert np.array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def test_prefill_decode_bf16_within_the_references_spread(ref_params):
    """Pooled over the prefill and 12 decode steps."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    prompts = np.random.default_rng(6).integers(0, 256, (2, 24))
    steps = [(_np(s[0])[:, -1], _np(s[1])[:, -1], _np(s[4])[:, -1])
             for s in _prefill_decode(rb, rp, tb, tp, prompts, _frames(6),
                                      12, rb32=rb32)]
    ref16, port, ref32 = zip(*steps)
    gap = _within_own_spread(port, ref16, ref32)
    want, got = np.stack(ref16), np.stack(port)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * gap
    assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    assert int(sure.sum()) >= 8          # a third of the 26 tokens decided


def _drive(engine_cls, scfg_cls, bundle, params):
    """Staggered admits with the pool's frames, decode steps,
    finishes, a re-admit into a reused slot.  Returns what the engine
    reported."""
    rng = np.random.default_rng(13)
    extra = {"frames": _frames(14)}
    eng = engine_cls(bundle, params, scfg_cls(max_seq=64, slots=2,
                                              prefix_reuse=True))
    pa = rng.integers(0, 256, 20)
    pb = np.concatenate([pa[:9], rng.integers(0, 256, 8)])
    log = [eng.supports_prefix_reuse, eng.add_request(pa, extra)]
    for _ in range(6):
        log.append(eng.step())
    log.append(eng.add_request(pb, extra))
    for _ in range(10):
        log.append(eng.step())
    log += [eng.finish(0), eng.finish(1)]
    log.append(eng.generate(pb, 8, extra_inputs=extra))
    log.append((eng.prefill_tokens_computed, eng.prefix_hits))
    return log


def test_engine_streams_equal_reference_engine(ref_params):
    """Prefix reuse asked for but off in both packages: the cross K/V
    carry a slot and no sequence axis."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _drive(RefEngine, RefServeConfig, rb, rp)
    got = _drive(Engine, ServeConfig, tb, tp)
    assert got == want
    assert got[0] is False and got[-1] == (54, 0)


def test_cache_is_the_references_and_probes_on_meta(ref_params):
    rb, _, tb, _ = _models(ref_params, "bfloat16")
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in rb.init_cache(3, 40).items()}
    got = tb.init_cache(3, 40)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == want
    meta = tb.init_cache(3, 40, "meta")
    assert all(t.device.type == "meta" for t in meta.values())
    eng = Engine(tb, tb.init(0), ServeConfig(max_seq=40, slots=3))
    assert eng._slot_axis == {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1,
                              "pos": 0}
    assert eng._seq_axis == {"k": 2, "v": 2, "cross_k": -1, "cross_v": -1,
                             "pos": -1}
    assert eng.supports_prefix_reuse is False


def test_launch_serve_main_and_load_engine(capsys):
    from repro_torch.launch.serve import extra_inputs, load_engine, main

    main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
          "--tokens", "4"])
    assert "2 requests, 8 tokens" in capsys.readouterr().out

    eng = load_engine(ARCH, slots=2, max_seq=48, device="cpu")
    extra = extra_inputs(eng.cfg, 2, np.random.default_rng(0))
    assert {k: (v.shape, v.dtype) for k, v in extra.items()} == \
        {"frames": ((2, 16, 64), np.float32)}
    out = eng.generate(np.arange(20), 12, extra_inputs=extra)
    assert len(out) == 32 and all(0 <= t < eng.cfg.vocab for t in out)


def test_build_defaults_to_the_card():
    cfg = get_config(ARCH).reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build(cfg)
    assert build(cfg, device="cpu").device == torch.device("cpu")
