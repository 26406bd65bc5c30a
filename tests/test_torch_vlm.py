"""llama-3.2-vision-11b in the port against the reference, on
``get_config("llama-3.2-vision-11b").reduced()`` (4 layers in 2
super-blocks of ``cross_every`` 2, so the cross-attention follows
block 0 of each; 8 image tokens of width 32; 4/1 heads of 16) with the
reference's own weights carried across by ``from_jax_params``; tokens
and image embeddings from numpy seeds.

Tolerances, as ``tests/test_torch_whisper.py`` states them: float32
logits within rtol 1e-4 plus 1e-4 of max|logit|, greedy tokens
identical, every bf16 cache leaf within one bf16 ulp of the
reference's (a value far below its leaf's scale within 1e-4 of the
leaf's max|value|); bfloat16 logits within the reference's own bf16 spread
(``tests/test_torch_recurrentgemma.py``'s gate).

A forward of 1024 tokens takes flash attention in every
self-attention layer with ``BIG_WINDOW``; the cross-attentions stay
dense, as in the reference.
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
from repro_torch.models import build, layers, lm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "llama-3.2-vision-11b"
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
    for group in (params["main"]["norms"], params["cross_norm"]):
        for name in group:
            group[name] = draw(group[name])
    return params, jax.tree.map(np.asarray, params)


def _models(ref_params, dtype):
    jdt, tdt = DTYPES[dtype]
    params, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    rb = ref_build(ref_get_config(ARCH).reduced(), jdt)
    tb = build(cfg, tdt, "cpu")
    tp = from_jax_params(params_np, cfg, device="cpu", compute_dtype=tdt)
    return rb, params, tb, tp


def _images(seed, B=2):
    V = get_config(ARCH).reduced().vision
    return np.random.default_rng(seed).standard_normal(
        (B, V.n_image_tokens, V.d_vision)).astype(np.float32)


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


def test_reduced_config_puts_the_cross_layer_after_block_0(monkeypatch):
    """4 layers, super-blocks of 2: a cross-attention after block 0 of
    each (block ``SB - 2``), read from the order of the calls."""
    cfg = get_config(ARCH).reduced()
    V = cfg.vision
    assert (cfg.n_layers, V.cross_every, V.n_image_tokens, V.d_vision,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
        (4, 2, 8, 32, 4, 1, 16)
    tb = build(cfg, torch.float32, "cpu")
    tp = tb.init(0)
    assert (len(tp["main"]), len(tp["cross"]), len(tp["cross_norm"])) == \
        (4, 2, 2)
    assert tuple(tp["cross"][0]["wk"].shape) == (32, 64)
    order = []
    block, attend = lm._dense_block, layers.attend_source

    def spy_block(cfg_, pl, *args):
        order.append(next(i for i, p in enumerate(tp["main"]) if p is pl))
        return block(cfg_, pl, *args)

    def spy_attend(p, x, k, v, **kw):
        order.append(f"cross over {k.shape[1]}")
        return attend(p, x, k, v, **kw)

    monkeypatch.setattr(lm, "_dense_block", spy_block)
    monkeypatch.setattr(layers, "attend_source", spy_attend)
    with torch.no_grad():
        tb.forward(tp, {"tokens": torch.zeros((1, 5), dtype=torch.long),
                        "image_embeds": _images(0, 1)})
    assert order == [0, "cross over 8", 1, 2, "cross over 8", 3]


def test_full_size_parameter_count():
    cfg = get_config(ARCH)
    assert cfg.param_count() == 10_244_587_520
    meta = build(cfg, torch.bfloat16, "cpu").init_cache(4, 4096, "meta")
    assert tuple(meta["kv"]["k"].shape) == (8, 5, 4, 4096, 8, 128)
    assert tuple(meta["img_k"].shape) == (8, 4, 1601, 32, 128)


def test_from_jax_params_trees_and_dtypes(ref_params):
    _, params_np = ref_params
    cfg = get_config(ARCH).reduced()
    tp = from_jax_params(params_np, cfg, device="cpu",
                         compute_dtype=torch.bfloat16)
    assert set(tp) == {"emb", "main", "cross", "cross_norm"}
    assert len(tp["main"]) == 4 and set(tp["main"][0]) == \
        {"attn", "norms", "ffn"}
    assert all(t.dtype == torch.float32 for n in tp["cross_norm"]
               for t in n.values())
    assert np.array_equal(tp["cross_norm"][1]["pre_cross"].numpy(),
                          params_np["cross_norm"]["pre_cross"][1])
    cross = tp["cross"][1]
    assert {n: (tuple(t.shape), t.dtype) for n, t in cross.items()} == {
        "wq": ((64, 64), torch.bfloat16), "wk": ((32, 64), torch.bfloat16),
        "wv": ((32, 64), torch.bfloat16), "wo": ((64, 64), torch.bfloat16)}
    assert torch.equal(cross["wv"], torch.tensor(
        params_np["cross"]["wv"][1]).bfloat16())
    assert tp["main"][3]["norms"]["pre_mlp"].dtype == torch.float32
    assert tp["main"][3]["ffn"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T, monkeypatch):
    """The whole stack without a cache; at T = 1024 every
    self-attention layer goes through flash attention."""
    calls = []
    flash = layers.flash_attention

    def spy(*args, **kw):
        calls.append(kw["window"])
        return flash(*args, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T).integers(0, 256, (2, T))
    images = _images(T)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks),
                                       "image_embeds": jnp.asarray(images)})
    got, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks),
                               "image_embeds": images})
    _close(got, want)
    assert float(aux["aux_loss"]) == 0.0
    assert calls == ([lm.BIG_WINDOW] * 4 if T >= layers.FLASH_MIN_T else [])


def _within_own_spread(port, ref16, ref32):
    """The bf16 gate of ``tests/test_torch_recurrentgemma.py``, over
    lists of logits pooled together; returns the reference's own
    largest gap."""
    port, ref16, ref32 = (np.concatenate([_np(a).ravel() for a in x])
                          for x in (port, ref16, ref32))
    span = np.abs(ref32).max()
    port_gap, ref_gap = np.abs(port - ref16), np.abs(ref16 - ref32)
    assert port_gap.max() <= np.sqrt(2) * ref_gap.max(), \
        (port_gap.max(), ref_gap.max())
    assert np.mean(port_gap > 2e-2 * span) <= np.mean(ref_gap > 2e-2 * span)
    return float(ref_gap.max())


def test_forward_bf16_within_the_references_spread(ref_params):
    """Pooled over 4 prompts and their image embeddings."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    fwd, fwd32 = jax.jit(rb.forward), jax.jit(rb32.forward)
    port, ref16, ref32 = [], [], []
    for seed in range(4):
        toks = np.random.default_rng(seed).integers(0, 256, (2, 40))
        images = _images(seed + 10)
        batch = {"tokens": jnp.asarray(toks),
                 "image_embeds": jnp.asarray(images)}
        ref16.append(fwd(rp, batch)[0])
        ref32.append(fwd32(rp, batch)[0])
        got, _ = tb.forward(tp, {"tokens": torch.from_numpy(toks),
                                 "image_embeds": images})
        assert got.dtype == torch.float32
        port.append(got)
    _within_own_spread(port, ref16, ref32)


def _prefill_decode(rb, rp, tb, tp, prompts, images, steps, rb32=None):
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
        rl, rcs[n] = jax.jit(r.prefill)(
            rp, {"tokens": jnp.asarray(toks),
                 "image_embeds": jnp.asarray(images)}, rcs[n])
        rls.append(rl)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "image_embeds": images}, tc)
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
    tokens, and after each every cache leaf: the bf16 K/V and image K/V
    within one bf16 ulp, ``pos`` equal."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    prompts = np.random.default_rng(5).integers(0, 256, (2, 24))
    for rl, tl, rc, tc in _prefill_decode(rb, rp, tb, tp, prompts,
                                          _images(5), 8):
        _close(tl, rl)
        assert np.array_equal(np.argmax(_np(tl), -1), np.argmax(_np(rl), -1))
        assert set(tc) == set(rc) == {"kv", "pos", "img_k", "img_v"}
        assert set(tc["kv"]) == set(rc["kv"]) == {"k", "v"}
        for got, want in ((tc["kv"]["k"], rc["kv"]["k"]),
                          (tc["kv"]["v"], rc["kv"]["v"]),
                          (tc["img_k"], rc["img_k"]),
                          (tc["img_v"], rc["img_v"])):
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == tuple(want.shape)
            _within_one_bf16_ulp(got, want)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def test_prefill_decode_bf16_within_the_references_spread(ref_params):
    """Pooled over the prefill and 12 decode steps."""
    rb, rp, tb, tp = _models(ref_params, "bfloat16")
    rb32 = ref_build(ref_get_config(ARCH).reduced(), jnp.float32)
    prompts = np.random.default_rng(6).integers(0, 256, (2, 24))
    steps = [(_np(s[0])[:, -1], _np(s[1])[:, -1], _np(s[4])[:, -1])
             for s in _prefill_decode(rb, rp, tb, tp, prompts, _images(6),
                                      12, rb32=rb32)]
    ref16, port, ref32 = zip(*steps)
    gap = _within_own_spread(port, ref16, ref32)
    want, got = np.stack(ref16), np.stack(port)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * gap
    assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    assert int(sure.sum()) >= 8          # a third of the 26 tokens decided


def _drive(engine_cls, scfg_cls, bundle, params):
    """Staggered admits with the pool's image embeddings, decode steps,
    finishes, a re-admit into a reused slot.  Returns what the engine
    reported."""
    rng = np.random.default_rng(13)
    extra = {"image_embeds": _images(14)}
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
    """Prefix reuse asked for but off in both packages: the image K/V
    carry a slot and no sequence axis."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    want = _drive(RefEngine, RefServeConfig, rb, rp)
    got = _drive(Engine, ServeConfig, tb, tp)
    assert got == want
    assert got[0] is False and got[-1] == (54, 0)


def test_cache_is_the_references_and_probes_on_meta(ref_params):
    rb, _, tb, _ = _models(ref_params, "bfloat16")
    flat = lambda c: {  # noqa: E731
        "k": c["kv"]["k"], "v": c["kv"]["v"],
        **{n: c[n] for n in ("pos", "img_k", "img_v")}}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in flat(rb.init_cache(3, 40)).items()}
    got = flat(tb.init_cache(3, 40))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == want
    assert all(t.device.type == "meta"
               for t in flat(tb.init_cache(3, 40, "meta")).values())
    eng = Engine(tb, tb.init(0), ServeConfig(max_seq=40, slots=3))
    assert eng._slot_axis == {"kv": {"k": 2, "v": 2}, "pos": 0,
                              "img_k": 1, "img_v": 1}
    assert eng._seq_axis == {"kv": {"k": 3, "v": 3}, "pos": -1,
                             "img_k": -1, "img_v": -1}
    assert eng.supports_prefix_reuse is False


def test_launch_serve_main_and_load_engine(capsys):
    from repro_torch.launch.serve import extra_inputs, load_engine, main

    main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
          "--tokens", "4"])
    assert "2 requests, 8 tokens" in capsys.readouterr().out

    eng = load_engine(ARCH, slots=2, max_seq=48, device="cpu")
    extra = extra_inputs(eng.cfg, 2, np.random.default_rng(0))
    assert {k: (v.shape, v.dtype) for k, v in extra.items()} == \
        {"image_embeds": ((2, 8, 32), np.float32)}
    out = eng.generate(np.arange(20), 12, extra_inputs=extra)
    assert len(out) == 32 and all(0 <= t < eng.cfg.vocab for t in out)


def test_build_defaults_to_the_card():
    cfg = get_config(ARCH).reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            build(cfg)
    assert build(cfg, device="cpu").device == torch.device("cpu")
