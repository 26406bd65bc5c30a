"""The port's recurrent block and sliding-window ring cache against the
reference, on ``get_config("recurrentgemma-2b").reduced()`` (d_model
64, lru_width 64, conv width 4, 4/1 heads of 16, window 16).

Tolerances:

* the plain RG-LRU scan (a float32 loop over T), and an emulation of
  the chunked kernel's decomposition (sub-chunk aggregates composed,
  windows carried, 1 - a**2 for 1 - exp(2 log_a)), against the
  reference's float32 ``associative_scan``: within 1e-5 relative
  (they sum the recurrence in other orders);
* ``_conv1d`` in float32: within 1e-6 (the same taps summed in the
  same order);
* ``rglru_block`` in float32: within 1e-5 relative;
* the ring writes: bit-identical (they only move values);
* one ring attention layer in float32: within 1e-5 relative, its
  bf16 ring within one bf16 ulp of the reference's (2**-7
  relative: the float32 k and v products may round either way).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_ref)
from repro_torch.kernels.rglru_scan.ref import gates  # noqa: E402
from repro_torch.models import layers, rglru  # noqa: E402

ARCH = "recurrentgemma-2b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _scan_inputs(B, T, W, seed, h0):
    """x, gate_a, gate_i, lam, h0 as numpy float32; lam spans decays
    from a near 1 (lam -6) to a near 0 (lam 4, the init)."""
    rng = np.random.default_rng(seed)
    x, ga, gi = (rng.standard_normal((B, T, W)).astype(np.float32)
                 for _ in range(3))
    lam = rng.uniform(-6, 4, W).astype(np.float32)
    h = rng.standard_normal((B, W)).astype(np.float32) if h0 else None
    return x, ga, gi, lam, h


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ----------------------------------------------------------------------
# the scan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 7, 130])
@pytest.mark.parametrize("h0", [False, True])
def test_plain_scan_matches_reference(T, h0):
    args = _scan_inputs(2, T, 48, T, h0)
    want = ref_rglru._rglru_scan(*map(_j, args))
    got = rglru_scan_ref(*map(_t, args))
    assert got.dtype == torch.float32 and got.shape == (2, T, 48)
    _close(got, want, 1e-5)


def test_plain_scan_reads_bf16_inputs_as_the_reference():
    x, ga, gi, lam, h = _scan_inputs(2, 20, 32, 3, True)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, ga, gi)]
    want = ref_rglru._rglru_scan(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (x, ga, gi)),
                                 jnp.asarray(lam), jnp.asarray(h))
    got = rglru_scan_ref(*bf, torch.from_numpy(lam), torch.from_numpy(h))
    _close(got, want, 1e-5)


def test_scan_dispatch_on_cpu_runs_the_plain_version():
    args = [_t(a) for a in _scan_inputs(1, 9, 16, 5, True)]
    before = scan_kernel.rglru_scan_cuda.launches
    assert torch.equal(rglru_scan(*args), rglru_scan_ref(*args))
    assert scan_kernel.rglru_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        scan_kernel.rglru_scan_cuda(*args)


# ----------------------------------------------------------------------
# the chunked kernel's decomposition and the variant choice
# ----------------------------------------------------------------------
def _chunked_scan(x_in, gate_a, gate_i, lam, h0, steps, window):
    """The chunked kernel's arithmetic in float32: windows of ``window``
    steps, each cut into sub-chunks of ``steps``; every sub-chunk's
    aggregate (A = prod a, B = its end state from 0), the aggregates of
    the sub-chunks before it composed into its carry-in, which it
    re-walks; the window's whole aggregate gives the next window's
    carry, h0 (or 0) the first.  b takes 1 - a**2 (rounded once) for
    1 - exp(2 log_a), as the kernel does; steps past T are the
    identity."""
    a, _ = gates(x_in, gate_a, gate_i, lam)
    mult = torch.sqrt(torch.clamp((1 - a.double() ** 2).float(), min=1e-12))
    b = mult * (torch.sigmoid(gate_i.float()) * x_in.float())
    B, T, W = a.shape
    S, nwin = window // steps, -(-T // window)
    pad = nwin * window - T
    a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad), value=0.0)
    a = a.view(B, nwin, S, steps, W)
    b = b.view(B, nwin, S, steps, W)
    agg_a, agg_b = a[:, :, :, 0], b[:, :, :, 0]
    for u in range(1, steps):
        agg_a = agg_a * a[:, :, :, u]
        agg_b = a[:, :, :, u] * agg_b + b[:, :, :, u]
    carry = torch.zeros((B, W)) if h0 is None else h0.float()
    out = torch.empty_like(a)
    for w in range(nwin):
        p, q = torch.ones((B, W)), torch.zeros((B, W))
        for s in range(S):
            h = p * carry + q
            for u in range(steps):
                h = a[:, w, s, u] * h + b[:, w, s, u]
                out[:, w, s, u] = h
            q = agg_a[:, w, s] * q + agg_b[:, w, s]
            p = agg_a[:, w, s] * p
        carry = p * carry + q
    return out.view(B, nwin * window, W)[:, :T]


_WINDOW = scan_kernel.CHUNK_WINDOW


@pytest.mark.parametrize("T", [1, 7, 130, _WINDOW - 1, _WINDOW,
                               _WINDOW + 1])
@pytest.mark.parametrize("h0", [False, True])
def test_chunked_decomposition_matches_reference(T, h0):
    args = _scan_inputs(2, T, 48, T + 100, h0)
    want = ref_rglru._rglru_scan(*map(_j, args))
    got = _chunked_scan(*map(_t, args), scan_kernel.CHUNK_STEPS, _WINDOW)
    assert got.shape == (2, T, 48)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("B, T, W, want", [
    (4, 1, 2560, "sequential"),
    (4, scan_kernel.CHUNKED_MIN_T - 1, 2560, "sequential"),
    (4, scan_kernel.CHUNKED_MIN_T, 2560, "chunked"),
    (4, 2048, 2560, "chunked"),
    (1, 40, 64, "chunked")])
def test_scan_variant_by_shape(B, T, W, want):
    """Decode steps take the sequential variant, every prefill from
    CHUNKED_MIN_T tokens on the chunked one."""
    assert scan_kernel.scan_variant(B, T, W) == want
    assert want in scan_kernel.VARIANTS


def test_chunked_constants_match_the_source():
    """The wrapper's CHUNK_* constants (the emulation above reads them)
    are the kernel's kSteps, kSubChunks * kSteps and kCluster."""
    text = (Path(scan_kernel.__file__).resolve().parents[2] / "csrc"
            / "rglru_scan.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"no constexpr int {name} in rglru_scan.cu"
        return int(m.group(1))
    assert scan_kernel.CHUNK_STEPS == const("kSteps")
    assert scan_kernel.CHUNK_WINDOW == const("kSubChunks") * const("kSteps")
    assert scan_kernel.CHUNK_CLUSTER == const("kCluster")


# ----------------------------------------------------------------------
# conv and block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    st = rng.standard_normal((2, 3, 32)).astype(np.float32) \
        if with_state else None
    want, want_st = ref_rglru._conv1d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), _j(st))
    got, got_st = rglru._conv1d(*map(_t, (x, w, b, st)))
    _close(got, want, 1e-6)
    assert np.array_equal(_np(got_st), _np(want_st))


@pytest.mark.parametrize("T", [1, 12])
def test_rglru_block_with_cache_matches_reference(T):
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    p, _ = ref_rglru.rglru_params(jax.random.PRNGKey(3), rcfg, 1)
    # lam spread over decays near 1 and near 0, so the state carries
    rng = np.random.default_rng(T)
    p["lam"] = jnp.asarray(rng.uniform(-6, 4, p["lam"].shape), jnp.float32)
    rp = jax.tree.map(lambda a: a[0], p)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    W = cfg.rg.lru_width
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    cache = {"h": rng.standard_normal((2, W)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, W)).astype(np.float32)}
    want, want_c = ref_rglru.rglru_block(
        rp, jnp.asarray(x), rcfg, cache=jax.tree.map(jnp.asarray, cache))
    got, got_c = rglru.rglru_block(
        tp, torch.from_numpy(x), cfg,
        cache={k: torch.from_numpy(v) for k, v in cache.items()})
    _close(got, want, 1e-5)
    _close(got_c["h"], want_c["h"], 1e-5)
    _close(got_c["conv"], want_c["conv"], 1e-5)
    none, no_cache = rglru.rglru_block(tp, torch.from_numpy(x), cfg)
    assert no_cache is None and none.shape == got.shape


def test_rglru_params_and_cache_follow_the_reference_shapes():
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    rp, _ = ref_rglru.rglru_params(jax.random.PRNGKey(0), rcfg, 1)
    tp = rglru.rglru_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape[1:]) for k, v in rp.items()}
    assert all(tp[k].dtype == torch.float32 for k in tp)
    assert torch.equal(tp["lam"], torch.full_like(tp["lam"], 4.0))
    rc = ref_rglru.init_rglru_cache(rcfg, 3, 2)
    tc = rglru.init_rglru_cache(cfg, 3, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in rc.items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            rglru.init_rglru_cache(cfg, 3, 2)


# ----------------------------------------------------------------------
# the ring cache
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t", [5, 16, 40])
def test_update_ring_matches_reference(t):
    """t < W, t = W and t > W (the last W tokens survive) from
    per-slot start positions, one of which wraps."""
    rng = np.random.default_rng(t)
    W = 16
    cache = rng.standard_normal((2, W, 1, 8)).astype(np.float32)
    kpos = rng.integers(-1, 30, (2, W)).astype(np.int32)
    new = rng.standard_normal((2, t, 1, 8)).astype(np.float32)
    pos = np.array([0, 13], np.int32)
    want_c, want_k = ref_layers._update_ring(
        jnp.asarray(cache), jnp.asarray(kpos), jnp.asarray(new),
        jnp.asarray(pos))
    tc, tk = torch.from_numpy(cache.copy()), torch.from_numpy(kpos.copy())
    got_c, got_k = layers._update_ring(tc, tk, torch.from_numpy(new),
                                       torch.from_numpy(pos))
    assert got_c is tc and got_k is tk                 # in place
    assert np.array_equal(_np(got_c), _np(want_c))
    assert np.array_equal(got_k.numpy(), np.asarray(want_k))


def _ring_layer():
    rcfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    p, _ = ref_layers.attn_params(jax.random.PRNGKey(7), rcfg, 1)
    rp = jax.tree.map(lambda a: a[0], p)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return rcfg, cfg, rp, tp


@pytest.mark.parametrize("T", [10, 40])
def test_ring_prefill_then_decode_past_the_wrap(T):
    """A prefill of T tokens into an empty ring (T = 40 > W = 16 writes
    the ring more than twice over), then decode steps that wrap it."""
    rcfg, cfg, rp, tp = _ring_layer()
    rng = np.random.default_rng(T)
    ring = ref_layers.init_ring_cache(rcfg, 1, 2)
    rc = {k: v[0] for k, v in ring.items()}
    tring = layers.init_ring_cache(cfg, 1, 2, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tring.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ring.items()}
    assert bool((tring["kpos"] == -1).all())
    tc = {k: v[0] for k, v in tring.items()}
    pos = np.zeros(2, np.int32)
    for step, t in enumerate([T] + [1] * 20):
        x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
        want, new = ref_layers.attention(
            rp, jnp.asarray(x), cfg=rcfg, window=rcfg.window,
            cache={**rc, "pos": jnp.asarray(pos)})
        got, tnew = layers.attention(
            tp, torch.from_numpy(x), cfg=cfg, window=cfg.window,
            cache={**tc, "pos": torch.from_numpy(pos.copy())})
        _close(got, want, 1e-5)
        assert np.array_equal(tnew["kpos"].numpy(), np.asarray(new["kpos"]))
        for k in ("k", "v"):
            # float32 k and v round to the bf16 ring: where the two
            # frameworks' products differ in the last float32 bits, a
            # value may round to the neighbouring bf16 value
            np.testing.assert_allclose(_np(tnew[k]), _np(new[k]),
                                       rtol=2 ** -7, atol=0)
        for k in ("k", "v", "kpos"):
            assert tnew[k] is tc[k]                    # in place
        rc = {k: new[k] for k in ("k", "v", "kpos")}
        pos = pos + t
        assert np.array_equal(tnew["pos"].numpy(), pos)
