"""The RG-LRU scan's backward against the reference's gradient.

The port's plain backward (``rglru_scan_bwd_ref``, the plain version of
``rglru_scan_bwd_hd`` in ``csrc/rglru_scan.cu``) is held against
``jax.grad`` through the reference's ``_rglru_scan`` (its float32
``associative_scan``) and against float64 autograd through the port's
plain forward; an emulation of the kernel's reversed decomposition
(sub-chunk aggregates of e -> a (g + e), windows walked from the last,
the carry passed back) is held against the plain reverse loop.  Inputs
come from numpy with a seed.  lam spans decays from a = 1 exactly in
float32 (lam -25: 1 - a^2 is 0, the clamp at 1e-12 binds and passes no
gradient, in both packages) through a near 1 (lam -6) to a near 0 (lam
4, the init); no lam sits where 1 - exp(2 log_a) is within an ulp of
the clamp, where the gradient jumps in the reference itself.

Tolerances, each gradient against its own largest magnitude:

* against ``jax.grad``: 1e-4.  Both run in float32, but the reference
  sums the recurrence as a log-depth scan and its gradient as another,
  the port as loops, and XLA's exp and log1p round apart from torch's;
  with decays up to a = 0.998 a gradient carries about 1 / (1 - a) =
  500 roundings of 2**-24, 3e-5 at worst;
* against float64 autograd: 1e-4, for the same float32 roundings;
* the emulation against the plain loop: 1e-5 (the same float32
  arithmetic, composed in another order, and 1 - a**2 rounded once for
  1 - exp(2 log_a), as the kernel computes it).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.kernels.rglru_scan.ref import C  # noqa: E402

REF_TOL = 1e-4
F64_TOL = 1e-4
EMU_TOL = 1e-5
NAMES = ("dx", "dgate_a", "dgate_i", "dlam", "dh0")


def _inputs(B, T, W, seed, h0):
    """x, gate_a, gate_i, lam, h0 and g = dL/dh as numpy float32."""
    rng = np.random.default_rng(seed)
    x, ga, gi, g = (rng.standard_normal((B, T, W)).astype(np.float32)
                    for _ in range(4))
    lam = rng.uniform(-6, 4, W).astype(np.float32)
    lam[:2] = -25.0                        # a = 1: the clamp binds
    h = rng.standard_normal((B, W)).astype(np.float32) if h0 else None
    return x, ga, gi, lam, h, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, rel, what):
    """Every element within ``rel`` of the largest magnitude of want."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * top, what


def _ref_grads(x, ga, gi, lam, h0, g):
    """jax.grad of sum(g * _rglru_scan(...)) in float32."""
    argnums = (0, 1, 2, 3) + ((4,) if h0 is not None else ())

    def loss(x, ga, gi, lam, h0):
        return jnp.sum(jnp.asarray(g) * ref_rglru._rglru_scan(x, ga, gi, lam,
                                                              h0))
    args = [jnp.asarray(a) for a in (x, ga, gi, lam)] + [
        None if h0 is None else jnp.asarray(h0)]
    return jax.grad(loss, argnums=argnums)(*args)


@pytest.mark.parametrize("T", [1, 9, 130])
@pytest.mark.parametrize("h0", [False, True])
def test_plain_backward_matches_reference_grad(T, h0):
    x, ga, gi, lam, h, g = _inputs(2, T, 48, T, h0)
    want = _ref_grads(x, ga, gi, lam, h, g)
    got = rglru_scan_bwd_ref(*map(_t, (g, x, ga, gi, lam, h)))
    assert (got[4] is None) == (h is None)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32, name
        _close(a, w, REF_TOL, name)


@pytest.mark.parametrize("T", [1, 40, 257])
@pytest.mark.parametrize("h0", [False, True])
def test_plain_backward_matches_f64_autograd(T, h0):
    x, ga, gi, lam, h, g = _inputs(3, T, 32, T + 7, h0)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (x, ga, gi, lam) + ((h,) if h0 else ())]
    out = rglru_scan_ref(*leaves[:4], leaves[4] if h0 else None)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g).double())
    got = rglru_scan_bwd_ref(*map(_t, (g, x, ga, gi, lam, h)))
    for name, a, w in zip(NAMES, got, want):
        _close(a, w.numpy(), F64_TOL, name)


def test_plain_backward_keeps_the_inputs_dtypes():
    """bf16 x, gate_a and gate_i get bf16 gradients (the kernel's
    outputs); dlam and dh0 stay float32.  The bf16 gradients are the
    float32 ones rounded once."""
    x, ga, gi, lam, h, g = _inputs(2, 20, 16, 4, True)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, ga, gi)]
    got = rglru_scan_bwd_ref(_t(g), *bf, _t(lam), _t(h))
    f32 = rglru_scan_bwd_ref(_t(g), *(t.float() for t in bf), _t(lam),
                             _t(h))
    for a, w in zip(got[:3], f32[:3]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, w.bfloat16())
    assert got[3].dtype == got[4].dtype == torch.float32
    assert torch.equal(got[3], f32[3]) and torch.equal(got[4], f32[4])


def test_plain_backward_takes_the_forward_h_or_computes_it():
    x, ga, gi, lam, h0, g = map(_t, _inputs(2, 33, 16, 9, True))
    h = rglru_scan_ref(x, ga, gi, lam, h0)
    for a, b in zip(rglru_scan_bwd_ref(g, x, ga, gi, lam, h0, h),
                    rglru_scan_bwd_ref(g, x, ga, gi, lam, h0)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the kernel's reversed decomposition
# ----------------------------------------------------------------------
def _chunked_bwd(g, x_in, gate_a, gate_i, lam, h0, steps, window,
                 cluster=1):
    """The backward kernel's arithmetic in float32: windows of
    ``window`` steps walked from the last, each cut into sub-chunks of
    ``steps``; every sub-chunk's aggregate of e -> a (g + e) from its
    last step to its first (A = prod a, B = the e it sends on from a
    zero carry); the aggregates of the later sub-chunks composed with
    the window's carry-in into each sub-chunk's, which it re-walks
    (dh = g + e, then e = a dh); the window's whole aggregate gives the
    carry of the window before it, 0 the last one's.  mult takes
    1 - a**2 rounded once and the clamp binds where it is under 1e-12,
    as in the kernel; steps past T are the identity (a 1, g 0).
    dlam is summed in the kernel's order: block rank r of a cluster of
    ``cluster`` takes the reversed windows r, r + cluster, ..., each
    thread adds its steps last first, the block's warps are summed in
    order into its partial, and the partials in (batch, rank) order.
    Channels are independent, so a strip of them only decides which
    blocks exist."""
    lam = lam.float()
    sp = torch.nn.functional.softplus(lam)
    sig_a = torch.sigmoid(gate_a.float())
    sig_i = torch.sigmoid(gate_i.float())
    x = x_in.float()
    a = torch.exp(-C * sp * sig_a)
    B, T, W = a.shape
    S, nwin = window // steps, -(-T // window)
    pad = nwin * window - T
    ap = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    gp = torch.nn.functional.pad(g.float(), (0, 0, 0, pad), value=0.0)
    ap = ap.view(B, nwin, S, steps, W)
    gp = gp.view(B, nwin, S, steps, W)
    agg_a = torch.ones((B, nwin, S, W))
    agg_b = torch.zeros((B, nwin, S, W))
    for u in range(steps - 1, -1, -1):
        agg_b = ap[:, :, :, u] * (gp[:, :, :, u] + agg_b)
        agg_a = agg_a * ap[:, :, :, u]
    dh = torch.empty_like(ap)
    carry = torch.zeros((B, W))
    dh0 = None
    for w in range(nwin - 1, -1, -1):
        p, q = torch.ones((B, W)), torch.zeros((B, W))
        for s in range(S - 1, -1, -1):
            e = p * carry + q
            for u in range(steps - 1, -1, -1):
                dh[:, w, s, u] = gp[:, w, s, u] + e
                e = ap[:, w, s, u] * dh[:, w, s, u]
            if w == 0 and s == 0:
                dh0 = e
            q = agg_a[:, w, s] * q + agg_b[:, w, s]
            p = agg_a[:, w, s] * p
        carry = p * carry + q
    dh = dh.view(B, nwin * window, W)[:, :T]
    h = rglru_scan_ref(x_in, gate_a, gate_i, lam, h0)
    first = torch.zeros((B, 1, W)) if h0 is None else h0.float()[:, None]
    h_prev = torch.cat([first, h[:, :-1]], dim=1)
    u2 = (1 - a.double() ** 2).float()
    mult = torch.sqrt(torch.clamp(u2, min=1e-12))
    dm = dh * sig_i * x
    dlog_a = dh * h_prev * a - torch.where(u2 >= 1e-12, dm * a * a / mult,
                                           torch.zeros_like(dm))
    term = torch.nn.functional.pad(dlog_a * sig_a, (0, 0, 0, pad))
    term = term.view(B, nwin, S, steps, W)
    dl = torch.zeros((B, cluster, S, W))          # a thread's terms
    for r in range(nwin):
        for u in range(steps - 1, -1, -1):
            dl[:, r % cluster] += term[:, nwin - 1 - r, :, u]
    part = dl[:, :, 0].clone()                    # the warps in order
    for j in range(1, S):
        part += dl[:, :, j]
    total = part.reshape(B * cluster, W)
    dlam = total[0].clone()
    for i in range(1, B * cluster):
        dlam += total[i]
    return (dh * mult * sig_i,
            dlog_a * (-C * sp) * sig_a * (1 - sig_a),
            dh * mult * x * sig_i * (1 - sig_i),
            dlam * (-C * torch.sigmoid(lam)),
            None if h0 is None else dh0)


_STEPS, _WINDOW = scan_kernel.CHUNK_STEPS, scan_kernel.CHUNK_WINDOW
_STRIP, _CLUSTER = scan_kernel.BWD_STRIP, scan_kernel.BWD_CLUSTER


@pytest.mark.parametrize("T", [1, _STEPS - 1, _STEPS + 1, _WINDOW,
                               _WINDOW + 1, 5 * _WINDOW + 13,
                               (2 * _CLUSTER + 3) * _WINDOW + 5])
@pytest.mark.parametrize("h0", [False, True])
def test_chunked_backward_decomposition_matches_plain_loop(T, h0):
    """The emulation at the kernel's window, cluster and strip (a
    ragged second strip of channels), over several rounds of the
    cluster at the longest T, against the plain reverse loop."""
    x, ga, gi, lam, h, g = map(_t, _inputs(2, T, _STRIP + 8, T + 50, h0))
    want = rglru_scan_bwd_ref(g, x, ga, gi, lam, h)
    got = _chunked_bwd(g, x, ga, gi, lam, h, _STEPS, _WINDOW, _CLUSTER)
    assert (got[4] is None) == (h is None)
    for name, a, w in zip(NAMES, got, want):
        if w is not None:
            _close(a, w.numpy(), EMU_TOL, name)


def test_backward_constants_match_the_source():
    """BWD_STRIP and BWD_CLUSTER (the emulation and the wrapper's dlam
    scratch read them) are the backward kernel's kBwdWc and
    kBwdCluster."""
    text = (Path(scan_kernel.__file__).resolve().parents[2] / "csrc"
            / "rglru_scan.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"no constexpr int {name} in rglru_scan.cu"
        return int(m.group(1))
    assert (_STRIP, _CLUSTER) == (const("kBwdWc"), const("kBwdCluster"))


# ----------------------------------------------------------------------
# the dispatch
# ----------------------------------------------------------------------
def test_scan_grad_on_cpu_is_the_plain_versions():
    """On CPU tensors the scan's gradient is autograd through the plain
    loop, which equals the plain backward; no kernel counter moves, and
    the backward's wrapper refuses CPU tensors."""
    x, ga, gi, lam, h0, g = map(_t, _inputs(2, 30, 16, 11, True))
    leaves = [t.clone().requires_grad_() for t in (x, ga, gi, lam, h0)]
    before = (scan_kernel.rglru_scan_cuda.launches,
              scan_kernel.rglru_scan_bwd_cuda.launches)
    out = rglru_scan(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    want = rglru_scan_bwd_ref(g, x, ga, gi, lam, h0)
    for name, a, w in zip(NAMES, got, want):
        _close(a, w.numpy(), EMU_TOL, name)
    assert (scan_kernel.rglru_scan_cuda.launches,
            scan_kernel.rglru_scan_bwd_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA device"):
        scan_kernel.rglru_scan_bwd_cuda(g, x, ga, gi, lam, h0, out.detach())
