"""The sLSTM recurrence's gradient: the port's plain reverse loop
(``slstm_scan_bwd_ref``, the plain version of ``csrc/slstm_scan.cu``'s
backward kernel) against float64 autograd through ``slstm_scan_ref`` and
against ``jax.grad`` of the reference's ``slstm_block``
(``repro/models/xlstm.py:187``, its ``lax.scan`` differentiated by JAX),
with a tie of ``max(f + m, i)`` and a ``max(n, 1e-6)`` that binds; then
the backward kernel's routing of dpre among the cluster's blocks,
emulated from the source's index arithmetic.  Inputs come from numpy
with a seed.

Tolerances, each gradient against its largest magnitude:

* against float64 autograd on the same inputs: 1e-4 (a float32 loop of
  a few steps; measured about 4e-7);
* against ``jax.grad`` of the block: 1e-3 (two float32 programs that
  round the recurrence, the block's matrix products and the feed-forward
  in other orders, carried back through the steps).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import xlstm as ref_xl  # noqa: E402
from repro_torch.kernels.slstm_scan import kernel as slstm_kernel  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import (  # noqa: E402
    slstm_scan_bwd_ref, slstm_scan_ref)

ARCH = "xlstm-125m"
F64_TOL = 1e-4
JAX_TOL = 1e-3


def _state(B, D, rng):
    """A state the recurrence can reach: n > 0, |c| <= n, any m."""
    n = rng.uniform(0.1, 4.0, (B, D))
    c = n * rng.uniform(-1, 1, (B, D))
    h = rng.uniform(-1, 1, (B, D))
    m = 3 * rng.standard_normal((B, D))
    return [x.astype(np.float32) for x in (c, n, h, m)]


def _pre_x(B, T, D, rng, tie=False, clamp=False):
    """pre_x ~ N(0, 1); with ``tie`` the first 4 units' f equal to their
    i at every step (with a zero state, f + m == i exactly at t = 0);
    with ``clamp`` units 4-7 have i 40 below f, so n stays under 1e-6
    from a zero state."""
    px = rng.standard_normal((B, T, 4 * D)).astype(np.float32)
    if tie:
        px[..., D:D + 4] = px[..., 0:4]
    if clamp:
        px[..., 4:8] = px[..., D + 4:D + 8] - 40.0
    return px


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * top, (what, err, top)


# B, T, D, H, with a state, tie, clamp
F64_CASES = [
    (2, 9, 32, 4, True, False, False),
    (2, 9, 32, 4, False, True, True),
    (1, 12, 48, 1, False, False, False),     # one head: 4 Dh columns of 192
    (3, 5, 24, 2, True, False, False),
]


@pytest.mark.parametrize("case", F64_CASES)
def test_bwd_ref_matches_float64_autograd(case):
    """Every gradient, the state's and r's included, and with the final
    state's gradients given, against autograd through the plain loop in
    float64 (whose maxima split a tie as jnp.maximum's)."""
    B, T, D, H, with_state, tie, clamp = case
    rng = np.random.default_rng(T * D)
    px = _pre_x(B, T, D, rng, tie, clamp)
    r = (0.5 / np.sqrt(D // H)
         * rng.standard_normal((H, D // H, 4 * D // H))).astype(np.float32)
    st = _state(B, D, rng) if with_state else None
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    dfin = [rng.standard_normal((B, D)).astype(np.float32) for _ in range(4)]
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
              for x in [px, r] + (st or [])]
    hs, fin = slstm_scan_ref(leaves[0], leaves[1],
                             tuple(leaves[2:]) if with_state else None)
    if clamp:
        assert float(fin[1].detach()[:, 4:8].max()) < 1e-6     # the clamp binds
    loss = (hs * torch.from_numpy(g).double()).sum() + sum(
        (a * torch.from_numpy(b).double()).sum() for a, b in zip(fin, dfin))
    want = torch.autograd.grad(loss, leaves)
    dpre, dr, dst = slstm_scan_bwd_ref(
        torch.from_numpy(g), torch.from_numpy(px), torch.from_numpy(r),
        None if st is None else tuple(map(torch.from_numpy, st)),
        tuple(map(torch.from_numpy, dfin)))
    assert dpre.dtype == dr.dtype == torch.float32
    assert (dst is None) == (st is None)
    got = [dpre, dr] + (list(dst) if dst is not None else [])
    for name, a, w in zip(["pre_x", "r", "c", "n", "h", "m"], got, want):
        _close(a, w.numpy(), F64_TOL, name)


def test_tie_splits_the_gradient_evenly():
    """At f + m == i jnp.maximum passes half the gradient to each side;
    a rule that gave it all to one side would move df and di of the tied
    units at t = 0 by a whole share."""
    B, T, D, H = 1, 3, 16, 4
    rng = np.random.default_rng(5)
    px = torch.from_numpy(_pre_x(B, T, D, rng, tie=True))
    r = torch.from_numpy((0.3 * rng.standard_normal((H, 4, 16)))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    dpre, _, _ = slstm_scan_bwd_ref(g, px, r)
    leaf = px.double().requires_grad_()
    hs, _ = slstm_scan_ref(leaf, r.double())
    (want,) = torch.autograd.grad((hs * g.double()).sum(), leaf)
    # the tied units at t = 0: f + m == i, the stabiliser's gradient split
    np.testing.assert_allclose(dpre[0, 0, :4].numpy(),
                               want[0, 0, :4].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dpre[0, 0, D:D + 4].numpy(),
                               want[0, 0, D:D + 4].numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.fixture(scope="module")
def ref_block():
    cfg = ref_get_config(ARCH).reduced()
    params, _ = ref_build(cfg).init(jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["slstm"])
    return cfg, p


@pytest.mark.parametrize("T, with_cache, tie, clamp", [
    (24, False, False, False), (24, True, False, False),
    (16, False, True, True), (3, True, False, False)])
def test_bwd_ref_matches_jax_grad_of_slstm_block(ref_block, T, with_cache,
                                                 tie, clamp):
    """jax.grad of a loss on the reference's slstm_block (its lax.scan
    differentiated by JAX) with respect to x, w_in, b_in, r_in and the
    cache, against the plain backward: the block's input product and
    feed-forward by torch autograd around it, the recurrence's gradient
    from slstm_scan_bwd_ref.  ``tie`` and ``clamp`` set w_in and b_in so
    that units 0-3 tie f + m == i at t = 0 and units 4-7 keep n under
    1e-6."""
    cfg, p = ref_block
    p = dict(p)
    D = cfg.d_model
    rng = np.random.default_rng(T + 11)
    B = 2
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w_in, b_in = p["w_in"].astype(np.float32), p["b_in"].astype(np.float32)
    if tie:
        w_in[:, D:D + 4] = w_in[:, 0:4]
        b_in[D:D + 4] = b_in[0:4]
    if clamp:
        w_in[:, 4:8] = 0.0
        w_in[:, D + 4:D + 8] = 0.0
        b_in[4:8] = -40.0
        b_in[D + 4:D + 8] = 0.0
    p["w_in"], p["b_in"] = w_in, b_in
    st = _state(B, D, rng) if with_cache else None
    G = rng.standard_normal((B, T, D)).astype(np.float32)

    def loss(w_in, b_in, r_in, x, cache):
        q = dict(p, w_in=w_in, b_in=b_in, r_in=r_in)
        out, _ = ref_xl.slstm_block(q, x, cfg, cache=cache)
        return jnp.sum(out * G)
    cache = None if st is None else dict(zip("cnhm", map(jnp.asarray, st)))
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(w_in), jnp.asarray(b_in), jnp.asarray(p["r_in"]),
        jnp.asarray(x), cache)

    # the port: pre_x and the feed-forward by autograd, the recurrence's
    # gradient by the plain reverse loop
    xt, wt, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, w_in, b_in))
    pre_x = xt @ wt + bt
    r = torch.from_numpy(p["r_in"].astype(np.float32))
    state = None if st is None else tuple(map(torch.from_numpy, st))
    hs, _ = slstm_scan_ref(pre_x.detach(), r, state)
    if clamp:
        _, fin = slstm_scan_ref(pre_x.detach()[:, :1], r, state)
        assert float(fin[1][:, 4:8].max()) < 1e-6
    hs = hs.requires_grad_()
    w1, w2 = (torch.from_numpy(p[k].astype(np.float32))
              for k in ("w_ff1", "w_ff2"))
    out = F.gelu(hs @ w1, approximate="tanh") @ w2
    (dhs,) = torch.autograd.grad((out * torch.from_numpy(G)).sum(), hs)
    dpre, dr, dst = slstm_scan_bwd_ref(dhs, pre_x.detach(), r, state)
    dx, dw, db = torch.autograd.grad(pre_x, (xt, wt, bt), dpre)
    for name, a, w in (("w_in", dw, want[0]), ("b_in", db, want[1]),
                       ("r_in", dr, want[2]), ("x", dx, want[3])):
        _close(a.numpy(), np.asarray(w), JAX_TOL, name)
    if st is not None:
        for k, a in zip("cnhm", dst):
            _close(a.numpy(), np.asarray(want[4][k]), JAX_TOL, "d" + k)


# ----------------------------------------------------------------------
# the backward kernel's exchange, emulated
# ----------------------------------------------------------------------
def _bwd_routing(D, H):
    """From the source's arithmetic: for each block of the cluster the
    bytes its mbarrier expects a step, and the columns of dpre the
    blocks send it (each (column, sender) once)."""
    C, U = slstm_kernel.CLUSTER, -(-D // slstm_kernel.CLUSTER)
    Dh, E = D // H, 4 * D // H
    expect = {}
    for rank in range(C):
        lo, hi = rank * U, min(rank * U + U, D)
        expect[rank] = 4 * E * ((hi - 1) // Dh - lo // Dh + 1) \
            if lo < hi else 0
    got = {rank: [] for rank in range(C)}
    for u in range(D):
        for g in range(4):
            j = g * D + u
            hd = j // E
            first, last = hd * Dh // U, (hd * Dh + Dh - 1) // U
            for peer in range(first, last + 1):
                got[peer].append(j)
    return expect, got, U, Dh, E


@pytest.mark.parametrize("D, H", [(768, 4), (64, 4), (40, 2), (48, 1),
                                  (96, 3), (16, 4)])
def test_bwd_exchange_delivers_each_block_its_heads(D, H):
    """Every block with units receives exactly the 4Dh columns of each
    head its units span, once each, which is what its mbarrier expects;
    with H <= 4 every such block hears from every other, the forward's
    condition for reusing a buffer three steps on."""
    expect, got, U, Dh, E = _bwd_routing(D, H)
    for rank, cols in got.items():
        lo, hi = rank * U, min(rank * U + U, D)
        want = sorted(j for hd in range(lo // Dh, (hi - 1) // Dh + 1)
                      for j in range(hd * E, hd * E + E)) if lo < hi else []
        assert sorted(cols) == want
        assert len(cols) * 4 == expect[rank]
        senders = {j % D // U for j in cols}
        live = [b for b in range(slstm_kernel.CLUSTER) if b * U < D]
        if lo < hi:
            assert senders == set(live)


def test_bwd_constants_match_the_source():
    text = (Path(slstm_kernel.__file__).resolve().parents[2] / "csrc"
            / "slstm_scan.cu").read_text()
    assert "constexpr int kBwdChunks = kMaxDh / 32;" in text
    assert "return cluster_fits(D, H) && H <= 4;" in text
    m = re.search(r"return cluster_fits\(D, H\) && H <= (\d+);", text)
    assert int(m.group(1)) == slstm_kernel.BWD_MAX_HEADS
    assert slstm_kernel.bwd_fits(768, 4) and not slstm_kernel.bwd_fits(768, 8)
    assert not slstm_kernel.bwd_fits(1024, 4)


def test_cuda_entries_refuse_cpu_tensors():
    """The card's forward and backward wrappers take no CPU tensor:
    nothing falls back to the plain version."""
    pre_x = torch.zeros((1, 4, 64), requires_grad=True)
    r = torch.zeros((4, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        slstm_kernel.slstm_scan_cuda(pre_x, r)
    with pytest.raises(ValueError, match="CUDA"):
        slstm_kernel.slstm_scan_bwd_cuda(torch.zeros((1, 4, 16)), r,
                                         (pre_x,) * 4)
