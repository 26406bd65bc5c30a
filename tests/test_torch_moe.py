"""The port's MoE feed-forward and qwen3-moe-30b-a3b against the
reference, on ``get_config("qwen3-moe-30b-a3b").reduced()`` (4 layers,
d_model 64, 8 experts top-2 of width 32, capacity factor 8: dropless)
with the reference's own weights carried across by ``from_jax_params``.

Tolerances:

* routing in float32: ids equal, weights and aux loss within 1e-6;
* one MoE layer in float32: within 1e-5 (the frameworks sum the expert
  products, and a token's k rows, in other orders), with the same
  tokens dropped on both sides at a capacity that drops;
* one MoE layer in bf16 on the same bf16 input: ids equal, output
  within 2e-2 of max|out|;
* the model in float32: logits within 1e-4 (plus 2e-4 of max|logit|
  where a bf16 KV cache is read), greedy tokens identical, as
  ``tests/test_torch_serve.py`` states for yi-9b;
* the model in bf16: not within 2e-2 of the range, as a dense model
  is.  The reduced router's logits are near ties (scale 0.02 over 64
  inputs), and rounding that moves a hidden state by 1% flips a top-2
  choice for a token now and then: its logits then move by up to half
  the range.  The reference flips so between its own bf16 and float32
  programs (on 15% of the logits at T = 40).  The gate is that the
  port's bf16 logits leave 2e-2 of the reference's bf16 ones less
  often than the reference's bf16 logits leave its float32 ones, and
  on at most 5% of them (the reference's MoE share,
  ``tests/test_models_smoke.py``);
* decode after prefill against the forward over the longer sequence:
  the reference's own outlier budget for MoE
  (``tests/test_models_smoke.py``: at most 5% of the logits beyond
  2e-2, none beyond 0.12), since top-k routing is discontinuous and the
  two programs round differently.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serve import Engine as RefEngine  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel, of_max=None):
    got, want = _np(got), _np(want)
    bound = (rel if of_max is None else of_max) * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=bound)


# ----------------------------------------------------------------------
# one layer
# ----------------------------------------------------------------------
def _layer(cf, n_shared=0, B=2, T=24, seed=0):
    """The reduced config's MoE at capacity factor ``cf``: the
    reference's layer params (jax and torch) and an input x."""
    mo = dataclasses.replace(get_config(ARCH).reduced().moe,
                             capacity_factor=cf, n_shared=n_shared)
    D = get_config(ARCH).reduced().d_model
    p, _ = ref_moe.moe_params(jax.random.PRNGKey(seed), D, mo, n_layers=1)
    rp = jax.tree.map(lambda a: a[0], p)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, D)).astype(np.float32)
    return mo, rp, tp, x


def _bf16_layer(tp):
    """A layer's params as ``from_jax_params`` stores them in a bf16
    model: matrices bf16, the router float32."""
    return {n: w if n == "router" else
            {m: v.to(torch.bfloat16) for m, v in w.items()}
            if isinstance(w, dict) else w.to(torch.bfloat16)
            for n, w in tp.items()}


def test_route_matches_reference():
    mo, rp, tp, x = _layer(1.25)
    xf = x.reshape(-1, x.shape[-1])
    w, ids, aux = ref_moe._route(rp["router"], jnp.asarray(xf), mo.top_k)
    tw, tids, taux = moe._route(tp["router"], torch.from_numpy(xf), mo.top_k)
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert abs(float(taux) - float(aux)) <= 1e-6
    assert tw.dtype == taux.dtype == torch.float32


def _drops(mo, tp, x) -> int:
    """How many (token, choice) pairs the capacity drops."""
    B, T, D = x.shape
    _, ids, _ = moe._route(tp["router"], torch.from_numpy(x).reshape(-1, D),
                           mo.top_k)
    C = max(1, int(mo.capacity_factor * B * T * mo.top_k / mo.num_experts))
    counts = torch.bincount(ids.reshape(-1), minlength=mo.num_experts)
    return int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("cf,n_shared,drops", [
    (1.25, 0, True), (1.25, 1, True), (0.5, 0, True), (8.0, 0, False),
    (8.0, 1, False)])
def test_moe_ffn_matches_reference_sort(cf, n_shared, drops):
    """At cf 1.25 and 0.5 the capacity drops tokens: the same ones must
    drop on both sides for the outputs to agree."""
    mo, rp, tp, x = _layer(cf, n_shared)
    assert (_drops(mo, tp, x) > 0) == drops
    want, aux = ref_moe.moe_ffn(rp, jnp.asarray(x), mo, impl="sort")
    got, taux = moe.moe_ffn(tp, torch.from_numpy(x), mo)
    _close(got, want, 1e-5)
    assert abs(float(taux) - float(aux)) <= 1e-6
    # a dropped pair adds nothing: the output differs from the dropless
    wide = dataclasses.replace(mo, capacity_factor=float(mo.num_experts))
    full, _ = moe.moe_ffn(tp, torch.from_numpy(x), wide)
    assert (not torch.allclose(got, full)) == drops


def test_moe_ffn_bf16_matches_reference():
    """The same bf16 input routes to the same experts (the router is
    float32 on both sides); the bf16 expert products agree to 2e-2."""
    mo, rp, tp, x = _layer(1.25, n_shared=1)
    tp = _bf16_layer(tp)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    D = x.shape[-1]
    _, ids, _ = ref_moe._route(rp["router"], xb.reshape(-1, D), mo.top_k)
    _, tids, _ = moe._route(tp["router"], xt.reshape(-1, D), mo.top_k)
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    want, _ = ref_moe.moe_ffn(rp, xb, mo, impl="sort")
    got, _ = moe.moe_ffn(tp, xt, mo)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


def test_combine_is_deterministic_and_a_scatter_add():
    """Two runs give the same bits, and the gather-and-sum combine is
    the reference's scatter-add up to the order of addition."""
    mo, _, tp, x = _layer(1.25)
    tp = _bf16_layer(tp)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    a, _ = moe.moe_ffn(tp, xb, mo)
    b, _ = moe.moe_ffn(tp, xb, mo)
    assert torch.equal(a, b)
    # the scatter-add form, in float32 on the same rounded operands
    D = x.shape[-1]
    xf = xb.float().reshape(-1, D)
    w, ids, _ = moe._route(tp["router"], xf.to(torch.bfloat16), mo.top_k)
    N, k, E = xf.shape[0], mo.top_k, mo.num_experts
    C = max(1, int(mo.capacity_factor * N * k / E))
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = torch.arange(N * k) - torch.searchsorted(se, se, side="left")
    out = torch.zeros((N, D))
    for pair, e, p in zip(order.tolist(), se.tolist(), pos.tolist()):
        if p < C:
            t = pair // k
            h = xf[t] @ tp["w_gate"][e].float()
            u = xf[t] @ tp["w_up"][e].float()
            y = (torch.nn.functional.silu(h) * u) @ tp["w_down"][e].float()
            out[t] += w.reshape(-1)[pair] * y
    rel = float((a.float().reshape(N, D) - out).norm() / out.norm())
    assert rel <= 2e-2


def test_moe_ffn_without_aux_gives_the_same_output():
    """The cache paths' aux=False leaves the aux loss uncomputed and
    changes no bit of the output."""
    mo, _, tp, x = _layer(1.25, n_shared=1)
    xt = torch.from_numpy(x)
    a, aux = moe.moe_ffn(tp, xt, mo)
    b, none = moe.moe_ffn(tp, xt, mo, aux=False)
    assert none is None and aux.dtype == torch.float32
    assert torch.equal(a, b)
    w, ids, _ = moe._route(tp["router"], xt.reshape(-1, x.shape[-1]),
                           mo.top_k)
    w2, ids2, none = moe._route(tp["router"], xt.reshape(-1, x.shape[-1]),
                                mo.top_k, aux=False)
    assert none is None and torch.equal(w, w2) and torch.equal(ids, ids2)


def test_moe_params_default_to_the_card():
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_params(gen, cfg.d_model, cfg.moe, dtype=torch.bfloat16,
                       device="cpu")
    E, F, D = cfg.moe.num_experts, cfg.moe.d_expert_ff, cfg.d_model
    assert p["router"].dtype == torch.float32
    assert tuple(p["w_gate"].shape) == (E, D, F)
    assert tuple(p["w_down"].shape) == (E, F, D)
    assert p["w_up"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            moe.moe_params(gen, cfg.d_model, cfg.moe)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
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


def test_converter_and_init_keep_the_router_float32(ref_params):
    cfg = get_config(ARCH).reduced()
    _, params_np = ref_params
    E, F, D = cfg.moe.num_experts, cfg.moe.d_expert_ff, cfg.d_model
    for tp in (from_jax_params(params_np, cfg, device="cpu"),
               build(cfg, torch.bfloat16, "cpu").init(0)):
        assert len(tp["main"]) == cfg.n_layers
        for layer in tp["main"]:
            ffn = layer["ffn"]
            assert ffn["router"].dtype == torch.float32
            assert tuple(ffn["router"].shape) == (D, E)
            assert {n: (w.dtype, tuple(w.shape)) for n, w in ffn.items()
                    if n != "router"} == {
                "w_gate": (torch.bfloat16, (E, D, F)),
                "w_up": (torch.bfloat16, (E, D, F)),
                "w_down": (torch.bfloat16, (E, F, D))}
    tp = from_jax_params(params_np, cfg, device="cpu")
    assert np.array_equal(tp["main"][2]["ffn"]["router"].numpy(),
                          params_np["main"]["ffn"]["router"][2])


@pytest.mark.parametrize("T", [40, 1024])
def test_forward_f32_matches_reference(ref_params, T):
    """Every position's logits and the summed aux loss."""
    rb, rp, tb, tp = _models(ref_params, "float32")
    toks = np.random.default_rng(T + 2).integers(0, 256, (2, T))
    want, waux = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)
    assert float(aux["aux_loss"]) > 0
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(waux["aux_loss"]), rtol=1e-5)


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
    for rl, tl in _prefill_decode(rb, rp, tb, tp, prompts, 6, T + 10):
        _close(tl, rl, 1e-4, of_max=2e-4)
        assert np.array_equal(np.argmax(_np(tl), -1), np.argmax(_np(rl), -1))


def test_forward_bf16_within_the_references_own_spread(ref_params):
    """Pooled over 4 prompts: the share of the port's bf16 logits
    beyond 2e-2 of the range from the reference's bf16 logits, against
    the share of the reference's bf16 logits beyond it from its float32
    ones (top-2 near ties flip under rounding; see the module's
    docstring)."""
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
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (B, S)))
    cache = tb.init_cache(B, S + 8)
    pre, cache = tb.prefill(tp, {"tokens": toks}, cache)
    assert tuple(pre.shape) == (B, 1, 256)
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
    """Staggered admits (one sharing a prefix), decode steps, finishes.
    Returns what the engine reported."""
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


def test_load_engine_serves_qwen3(capsys):
    from repro_torch.launch.serve import load_engine, main

    main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
          "--tokens", "4"])
    assert "1 requests, 4 tokens" in capsys.readouterr().out

    eng = load_engine(ARCH, slots=2, max_seq=32, device="cpu")
    out = eng.generate(np.arange(9), 6)
    assert len(out) == 15 and all(0 <= t < eng.cfg.vocab for t in out)
    assert eng.params["main"][0]["ffn"]["router"].dtype == torch.float32


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


@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
def test_dispatch_gradients_are_gathers(monkeypatch, cf):
    """The dispatch's two row gathers take their gradients by gathers
    (``moe._Gather``), not by autograd's accumulating scatter, which on
    CUDA adds each run of equal indices serially (every empty slot reads
    the pad row, every drop the trash slot): no index backward of rows
    in the graph (the routing weights' permutation, one scalar a pair,
    stays), and in float64 the gradients of x, the router and the
    experts equal those through plain indexing, drops or none."""
    mo, _, tp, x = _layer(cf, B=2, T=24)
    tp = {n: v.double().requires_grad_() for n, v in tp.items()}
    xt = torch.from_numpy(x).double().requires_grad_()
    leaves = [xt, *tp.values()]
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        x.shape))

    def grads():
        out, aux = moe.moe_ffn(tp, xt, mo)
        return out, torch.autograd.grad((out * dy).sum() + aux, leaves)

    out, got = grads()
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if "IndexBackward" in type(fn).__name__:
            assert len(fn._saved_self_sym_sizes) == 1, type(fn).__name__
        stack.extend(f for f, _ in fn.next_functions)
    monkeypatch.setattr(moe._Gather, "apply",
                        staticmethod(lambda src, idx, back: src[idx]))
    _, want = grads()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
