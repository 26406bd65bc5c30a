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


# ----------------------------------------------------------------------
# the backward kernel's step, emulated: its raw loads and the gate step's
# forward half taken off the chain
# ----------------------------------------------------------------------
# the emulated kernel against the plain reverse loop: both float32 with
# the same product; they part only where the kernel multiplies by
# 1 / max(n, 1e-6) instead of dividing, one rounding a step
STEP_TOL = 1e-5


def _saved(px, r, state):
    """What a forward with grad writes for the backward: pre (B, T, 4D)
    and the state c, n, m after each step (B, T, D), float32."""
    from repro_torch.kernels.slstm_scan.ref import _gate_step, _pre

    B, T, D4 = px.shape
    D = D4 // 4
    zero = torch.zeros((B, D))
    c, n, h, m = state if state is not None else (zero,) * 4
    out = [torch.empty((B, T, D4))] + [torch.empty((B, T, D))
                                       for _ in range(3)]
    for t in range(T):
        pre = _pre(px[:, t], r, h)
        c, n, h, m = _gate_step(pre, c, n, m)
        for x, v in zip(out, (pre, c, n, m)):
            x[:, t] = v
    return out


def _gate_fwd(g, i_, f_, z_, o_, cp, np_, mp):
    """The source's gate_fwd: what depends on pre_t and the state before
    the step alone."""
    fm = f_ + mp
    mn = torch.maximum(fm, i_)
    ig, fg, tz = torch.exp(i_ - mn), torch.exp(fm - mn), torch.tanh(z_)
    c = fg * cp + ig * tz
    n = fg * np_ + ig
    nc = torch.clamp(n, min=1e-6)
    so = 1.0 / (1.0 + torch.exp(-o_))
    half = torch.tensor(0.5)
    return dict(g=g, cp=cp, np=np_, ig=ig, fg=fg, tz=tz, so=so, q=c / nc,
                rn=1.0 / nc,
                wn=torch.where(n > 1e-6, 1.0, torch.where(n == 1e-6, half,
                                                          0.0)),
                wf=torch.where(fm > i_, 1.0, torch.where(fm == i_, half,
                                                         0.0)))


def _gate_bwd(a, dh, dc, dn, dm):
    """The source's gate_bwd: the terms in the carried gradients, in
    its order; returns (di, df, dz, do) and the carried dc, dn, dm."""
    dq = dh * a["so"]
    dc = dc + dq * a["rn"]
    dn = dn + -dq * a["q"] * a["rn"] * a["wn"]
    do = dh * a["q"] * a["so"] * (1.0 - a["so"])
    dfg = dc * a["cp"] + dn * a["np"]
    dig = dc * a["tz"] + dn
    dz = dc * a["ig"] * (1.0 - a["tz"] * a["tz"])
    af, ai = dfg * a["fg"], dig * a["ig"]
    dmn = dm - af - ai
    dfm = af + dmn * a["wf"]
    di = ai + dmn * (1.0 - a["wf"])
    return (di, dfm, dz, do), dc * a["fg"], dn * a["fg"], dfm


def _kernel_bwd(dhs, r, saved, state, dfin):
    """slstm_bwd_kernel's step loop in float32, every unit at once: each
    of a unit's 8 lanes loads one raw input two steps ahead, as the
    source's `load` addresses it (g from dhs, i, f, z, o from pre, the
    state before the step from c, n, m one row back, or the state the
    forward started from), and the gate step's forward half for step
    n + 1 runs once step n's dpre is out, off the chain."""
    pre, cs, ns, ms = saved
    B, T, D = dhs.shape
    D4 = 4 * D
    H = r.shape[0]
    u = torch.arange(D)
    flat = [x.reshape(-1) for x in (dhs, pre, cs, ns, ms)]

    def load(n, k8):
        """Lane k8's raw input of step n for every (row, unit)."""
        if n >= T:
            return torch.zeros((B, D))
        src = flat[0] if k8 == 0 else flat[1] if k8 < 5 else flat[k8 - 3]
        lw = D4 if 1 <= k8 <= 4 else D
        loff = (k8 - 1) * D + u if 1 <= k8 <= 4 else u
        t = T - 1 - n - (1 if k8 >= 5 else 0)
        if t >= 0:
            rows = torch.arange(B)[:, None] * T + t
            return src[rows * lw + loff]
        if state is None:
            return torch.zeros((B, D))
        return state[(0, 1, 3)[k8 - 5]].clone()

    def raw_of(n):
        return [load(n, k8) for k8 in range(8)]
    dc, dn, dm = ((torch.zeros((B, D)),) * 3 if dfin is None
                  else (dfin[0], dfin[1], dfin[3]))
    dpre = torch.empty((B, T, D4))
    a, r1 = _gate_fwd(*raw_of(0)), raw_of(1)
    back = torch.zeros((B, D))              # r . dpre_{t+1}
    for n in range(T):
        t = T - 1 - n
        rn = raw_of(n + 2)
        # the final h's gradient joins the last step's, as the wrapper
        # adds it to dhs
        g = a["g"] + (dfin[2] if dfin is not None and n == 0 else 0.0)
        out, dc, dn, dm = _gate_bwd(a, back + g, dc, dn, dm)
        dpre[:, t] = torch.cat(out, -1)
        back = torch.einsum("bhe,hde->bhd", dpre[:, t].reshape(B, H, -1),
                            r).reshape(B, D)
        a, r1 = _gate_fwd(*r1), rn
    return dpre, (dc, dn, back, dm)


# B, T, D, H, with a state, tie, clamp
STEP_CASES = [
    (2, 40, 64, 4, False, True, False),
    (2, 40, 64, 4, True, False, False),
    (1, 9, 32, 4, False, False, True),
    (3, 7, 48, 2, True, False, False),
    (2, 1, 16, 4, True, False, False),
    (1, 2, 48, 1, False, False, False),
]


@pytest.mark.parametrize("case", STEP_CASES)
def test_bwd_kernel_step_with_the_forward_half_off_the_chain(case):
    """The backward kernel's step in its order (raw inputs loaded two
    steps ahead, one a lane; the gate step's forward half for step n + 1
    computed after step n's dpre, with 1 / max(n, 1e-6); the chain's
    terms in the carried gradients) against the plain reverse loop
    slstm_scan_bwd_ref within STEP_TOL of each gradient's largest, ties
    of f + m with i and a clamped n included."""
    B, T, D, H, with_state, tie, clamp = case
    rng = np.random.default_rng(7 * T + D)
    px = torch.from_numpy(_pre_x(B, T, D, rng, tie, clamp))
    r = torch.from_numpy((0.5 / np.sqrt(D // H) * rng.standard_normal(
        (H, D // H, 4 * D // H))).astype(np.float32))
    st = tuple(map(torch.from_numpy, _state(B, D, rng))) if with_state \
        else None
    dhs = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    dfin = [torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
            for _ in range(4)]
    saved = _saved(px, r, st)
    got, gst = _kernel_bwd(dhs, r, saved, st, dfin)
    want, _, wst = slstm_scan_bwd_ref(dhs, px, r, st, dfin)
    _close(got.numpy(), want.numpy(), STEP_TOL, "dpre")
    if st is not None:
        for k, a, w in zip("cnhm", gst, wst):
            _close(a.numpy(), w.numpy(), STEP_TOL, "d" + k)


def test_bwd_kernel_step_matches_the_source():
    """The emulation above reads the source's lane loads, its two
    halves of the gate step and its probes' codes."""
    text = (Path(slstm_kernel.__file__).resolve().parents[2] / "csrc"
            / "slstm_scan.cu").read_text()
    for line in (
            "const float* lsrc = k8 == 0 ? dhs : k8 < 5 ? pre : k8 == 5 ? cs",
            "const long long lw = k8 >= 1 && k8 <= 4 ? D4 : D;",
            "const int loff = k8 >= 1 && k8 <= 4 ? (k8 - 1) * D + u : u;",
            "const int lback = k8 >= 5 ? 1 : 0;",
            "rn = load(n + 2);",
            "a.rn = 1.0f / nc;",
            "dc += dq * a.rn;",
            "dn += -dq * a.q * a.rn * a.wn;",
            "a = prepare(r1);",
            "enum { kBwdFunction = 0, kBwdExchange = 1, kBwdCompute = 2 };"):
        assert line in text, line
    assert slstm_kernel.BWD_PROBES == {"exchange": 1, "compute": 2}
    # the raw input of step n + 1 is first read at step n's end, by the
    # name it was loaded into at step n - 1: two steps an iteration
    assert "step(n, a, ra, rb);" in text
    assert "if (n + 1 < T) step(n + 1, a, rb, ra);" in text


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
