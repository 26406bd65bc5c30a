"""The flash-attention gradient of the port against the reference's.

The port's plain backward (``jnp_impl._BlockwiseAttention``, the plain
version of ``csrc/flash_attn_bwd_hd.cu``) is held against ``jax.grad``
through the reference's ``blockwise_attention`` and its ``custom_vjp``
on the reference's own cases (tests/test_flash_attention.py), at the
reference's tolerance for that test, rtol = atol = 2e-4.  Inputs come
from numpy with a seed.  The backward kernel itself runs only on a card
(tests/test_torch_cuda.py); here its wrapper's contract is checked.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import jnp_impl as ref_jnp  # noqa: E402
from repro_torch.kernels.flash_attention import jnp_impl, ops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

# tests/test_flash_attention.py CASES, the float32 ones:
# B, T, S, Hq, Hkv, Dh, Dv, window, softcap, ragged
CASES = [
    (2, 64, 64, 4, 4, 32, 32, None, 0.0, False),
    (1, 128, 128, 8, 2, 16, 16, None, 0.0, False),
    (2, 96, 96, 4, 1, 32, 32, 24, 0.0, False),     # MQA + window
    (1, 64, 64, 4, 4, 32, 32, None, 30.0, False),  # softcap
    (2, 33, 77, 4, 2, 16, 48, None, 0.0, True),    # ragged, Dv != Dh
    # and the heads of 256 the card's backward takes at gemma2's
    # shape: GQA, a window under T, softcap 50
    (2, 70, 90, 4, 2, 256, 256, 24, 50.0, True),
]


def _mk(B, T, S, Hq, Hkv, Dh, Dv, ragged, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32)
    off = rng.integers(0, S - T + 1, (B,)) if ragged else np.zeros((B,),
                                                                  np.int64)
    qpos = (off[:, None] + np.arange(T)[None, :]).astype(np.int32)
    return q, k, v, qpos


def _ref_grads(q, k, v, qpos, window, softcap, block):
    def loss(q, k, v):
        return jnp.sum(jnp.square(ref_jnp.blockwise_attention(
            q, k, v, qpos=jnp.asarray(qpos), window=window, softcap=softcap,
            block_q=block, block_kv=block)))
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, qpos, window, softcap, block):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = jnp_impl.blockwise_attention(
        *leaves, qpos=torch.from_numpy(qpos), window=window, softcap=softcap,
        block_q=block, block_kv=block)
    out.square().sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("case, block", [(c, 32) for c in CASES] + [
    (CASES[1], 512), (CASES[4], 512)])      # one block of all of T and S
def test_plain_backward_matches_reference_custom_vjp(case, block):
    B, T, S, Hq, Hkv, Dh, Dv, window, softcap, ragged = case
    q, k, v, qpos = _mk(B, T, S, Hq, Hkv, Dh, Dv, ragged)
    want = _ref_grads(q, k, v, qpos, window, softcap, block)
    got = _port_grads(q, k, v, qpos, window, softcap, block)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_plain_backward_fully_masked_rows_have_zero_grad():
    """Padding rows (qpos -1) and rows whose window sees no key carry
    lse = -1e30: their p is 0, not exp of it, so every gradient is
    finite and a masked row's dq is exactly 0, as in the reference."""
    q, k, v, _ = _mk(2, 40, 56, 4, 2, 16, 16, False, seed=4)
    qpos = np.broadcast_to(np.arange(16, 56), (2, 40)).astype(np.int32)
    qpos[:, :7] = -1
    qpos[1, 10:14] = 400
    want = _ref_grads(q, k, v, qpos, 5, 0.0, 16)
    got = _port_grads(q, k, v, qpos, 5, 0.0, 16)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    assert float(got[0][:, :7].abs().sum()) == 0.0
    assert float(got[0][1, 10:14].abs().sum()) == 0.0


def test_plain_forward_saves_lse_not_blocks():
    """The saved tensors are the inputs, the float32 output and one
    log-sum-exp per row: no (T x S) probabilities."""
    q, k, v, qpos = _mk(1, 64, 64, 4, 2, 16, 16, False)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = jnp_impl.blockwise_attention(*leaves, qpos=torch.from_numpy(qpos),
                                       block_q=16, block_kv=16)
    saved = out.grad_fn.saved_tensors
    assert sum(t.numel() for t in saved) < 4 * sum(x.size for x in
                                                   (q, k, v, qpos))
    lse = saved[-1]
    assert lse.shape == (1, 2, 2, 64) and lse.dtype == torch.float32


def test_auto_dispatch_on_cpu_is_differentiable_past_the_dense_limit():
    """impl='auto' on CPU tensors with T·S > 2048² takes the blockwise
    path, whose gradient is the flash-style backward; it matches dense
    autograd."""
    rng = np.random.default_rng(5)
    T = S = 2050
    q, k, v = (torch.tensor(rng.standard_normal((1, T, 1, 8))
                            .astype(np.float32), requires_grad=True)
               for _ in range(3))
    qpos = torch.arange(T, dtype=torch.int32)[None]
    out = ops.flash_attention(q, k, v, qpos=qpos)
    assert type(out.grad_fn).__name__ == "_BlockwiseAttentionBackward"
    do = torch.from_numpy(rng.standard_normal((1, T, 1, 8))
                          .astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), do)
    dense = ops.flash_attention(q, k, v, qpos=qpos, impl="dense")
    want = torch.autograd.grad(dense, (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("dtype, Dh, Dv, want", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.float16, 64, 64, "wgmma"),
    (torch.float32, 128, 128, "ffma"), (torch.float32, 64, 64, "ffma"),
    (torch.bfloat16, 256, 256, "wgmma"), (torch.float32, 256, 256, "ffma"),
    (torch.bfloat16, 192, 128, "wgmma"), (torch.float16, 192, 128, "wgmma")])
def test_backward_variant_by_dtype(dtype, Dh, Dv, want):
    assert kernel.bwd_variant(dtype, Dh, Dv) == want


def test_backward_at_mla_dims_has_no_float32_kernel():
    """float32 at Dh 192 / Dv 128 takes the ffma pair, whose widths are
    the forward's: a float32 deepseek-v3 trains on the card.  (The name
    is kept from when this pair had no float32 kernel and raised; the
    test asserts the opposite now.)"""
    assert kernel.bwd_variant(torch.float32, 192, 128) == "ffma"


@pytest.mark.parametrize("Hq, Hkv, part", [
    (128, 128, None), (8, 2, (2, 1, 4096, 8, 192))])
def test_backward_scratch_at_mla_dims(Hq, Hkv, part):
    """deepseek-v3's training microbatch (128 heads over 128: no GQA
    partials) and a GQA group, whose partials of dk (192) and dv (128)
    share rows of max(Dh, Dv) floats."""
    got = kernel.bwd_scratch("wgmma", 1, 4096, 4096, Hq, Hkv, 192, "cpu",
                             Dv=128)
    assert tuple(got[0].shape) == (1, Hq, 64, 2, 64)
    assert tuple(got[1].shape) == (8448,)
    assert (None if got[2] is None else tuple(got[2].shape)) == part


@pytest.mark.parametrize("variant, B, T, S, Hq, Hkv, D, shapes", [
    ("wgmma", 1, 4096, 4096, 32, 4, 128,
     ((1, 32, 64, 2, 64), (8448,), (2, 1, 4096, 32, 128))),
    ("wgmma", 2, 100, 130, 8, 8, 64, ((2, 8, 2, 2, 64), (528,), None)),
    ("wgmma", 1, 129, 300, 8, 1, 64, ((1, 8, 4, 2, 64), (528,),
                                       (2, 1, 300, 8, 64))),
    ("ffma", 2, 100, 130, 8, 1, 64,
     ((2, 8, 100), None, (2, 2, 130, 8, 64))),
    ("ffma", 1, 7, 9, 2, 2, 128, ((1, 2, 7), None, None)),
    # the Dh-256 training shapes: gemma2 (16 over 8 heads) and
    # recurrentgemma (10 over 1), one microbatch of 4096 tokens
    ("wgmma", 1, 4096, 4096, 16, 8, 256,
     ((1, 16, 64, 2, 64), (8448,), (2, 1, 4096, 16, 256))),
    ("wgmma", 1, 4096, 4096, 10, 1, 256,
     ((1, 10, 64, 2, 64), (8448,), (2, 1, 4096, 10, 256)))])
def test_backward_scratch_by_variant(variant, B, T, S, Hq, Hkv, D, shapes):
    """The scratch each variant's C entry reads: wgmma's per-tile lse
    and delta over 2 * ceil(T / 128) tiles of 64 rows, its row bounds
    and tile ranges, ffma's delta a row, and for both with a GQA group
    the float32 partials of dk and dv per query head (134 MB at the
    training shape)."""
    got = kernel.bwd_scratch(variant, B, T, S, Hq, Hkv, D, "cpu")
    assert tuple(None if t is None else tuple(t.shape) for t in got) == shapes
    assert got[0].dtype == torch.float32
    if got[1] is not None:
        assert got[1].dtype == torch.int32
    if got[2] is not None:
        assert got[2].dtype == torch.float32
        assert got[2].numel() * 4 == 2 * B * S * Hq * D * 4


# pairs wgmma does not take go to the ffma pair; the backward refuses
# only the head dims the forward refuses: not a multiple of 8, or past 256
@pytest.mark.parametrize("Dh, Dv", [(32, 32), (192, 64), (128, 64)])
def test_backward_refuses_other_head_dims(Dh, Dv):
    """Pairs wgmma does not take run on the ffma pair; the head dims
    refused are only the forward's refusals.  (The name is kept from
    when these pairs were refused.)"""
    assert kernel.bwd_variant(torch.bfloat16, Dh, Dv) == "ffma"
    for bad in ((Dh + 4, Dv), (Dh, Dv + 260), (Dh, 0)):
        with pytest.raises(ValueError, match="multiples of 8 up to 256"):
            kernel.bwd_variant(torch.bfloat16, *bad)


def test_cpu_tensors_launch_no_backward_kernel():
    """On CPU tensors the gradient is the plain version's: the kernel
    counters do not move, and impl='cuda' refuses CPU tensors."""
    before = (kernel.flash_attention_bwd_cuda.launches,
              dict(kernel.flash_attention_bwd_cuda.by_variant))
    q, k, v, qpos = _mk(1, 64, 64, 4, 2, 64, 64, False)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ops.flash_attention(*leaves, qpos=torch.from_numpy(qpos),
                        impl="blockwise").sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    assert (kernel.flash_attention_bwd_cuda.launches,
            dict(kernel.flash_attention_bwd_cuda.by_variant)) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*leaves, qpos=torch.from_numpy(qpos),
                            impl="cuda")


# ----------------------------------------------------------------------
# the Dh-256 and Dh 192 / Dv 128 kernels' blocking, emulated in float32
# ----------------------------------------------------------------------
_ROWS = 64          # keys of a dK/dV block, rows of a part and a tile
_DQ_KEYS = 32       # keys of a dQ stage at Dh 256
_DQ_KEYS_MLA = 64   # at Dh 192 / Dv 128
_NO_KEY = 1e30      # lse * log2(e) of a row that sees no key
_LOG2E = 1.4426950408889634


def _row_bounds(qpos, S, window):
    """Each row's visible keys as (lo, hi], as the pre-pass writes them:
    hi = min(qpos, S - 1) or -1, lo = qpos - window (or -1) clamped to
    [-1, hi]."""
    qp = qpos.long()
    hi = torch.where(qp < 0, -1, torch.clamp(qp, max=S - 1))
    lo = qp - window if window is not None else torch.full_like(qp, -1)
    lo = torch.where(qp < 0, -1, lo)
    return torch.minimum(torch.clamp(lo, min=-1), hi), hi


def _tile_ranges(lo, hi):
    """Per 64-row tile (x, y, z, w): every key a row sees lies in [x, y];
    every row sees every key in [z, w]."""
    B, n = lo.shape[0], lo.shape[1] // _ROWS
    lo, hi = lo.view(B, n, _ROWS), hi.view(B, n, _ROWS)
    any_ = lo < hi
    big = torch.iinfo(torch.int64).max
    x = torch.where(any_, lo + 1, big).amin(-1)
    y = torch.where(any_, hi, -1).amax(-1)
    return x, y, (lo + 1).amax(-1), hi.amin(-1)


def _roles_bwd(q, k, v, o, do, qpos, lse, window, softcap, scale,
               dq_keys=_DQ_KEYS):
    """dq, dk, dv of the Dh-256 (and Dh 192 / Dv 128) kernels'
    arithmetic in float32, and the (visited, full) tile counts of the
    dK/dV pass: 64-key blocks per query head stream every 64-row query
    tile whose row hull sees one of their keys, masking only tiles that
    are not full; the S^T side (scores over Dh) hands P^T (times the
    softcap's factor) to the dP^T side (over Dv), which forms dS^T; dK
    and dV are per-query-head partials summed in head order.  dQ blocks
    of 128 rows walk the ``dq_keys``-key stages of their two tiles'
    hull, each tile (a warpgroup's 64 rows) skipping the stages it does
    not see."""
    B, T, Hq, D = q.shape
    Dv = v.shape[-1]
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n = 2 * -(-T // 128)
    qp = torch.full((B, n * _ROWS), -1, dtype=torch.int64)
    qp[:, :T] = qpos.long()
    lo, hi = _row_bounds(qp, S, window)
    tx, ty, tz, tw = _tile_ranges(lo, hi)
    pad = n * _ROWS - T
    Q, dO = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
             for x in (q, do))
    delta = torch.nn.functional.pad((do * o).sum(-1), (0, 0, 0, pad))
    lse2 = torch.where(lse > -0.5e30, lse * _LOG2E, _NO_KEY)
    lse2 = torch.nn.functional.pad(lse2, (0, pad), value=_NO_KEY)
    nk = -(-S // _ROWS)
    K, V = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nk * _ROWS - S))
            for x in (k, v))
    kpos = torch.arange(nk * _ROWS)

    def probs(s, rows, keys, b, h, masked):
        """P and P * the softcap's factor for scores s (rows x keys)."""
        z, fac = s * scale, torch.ones_like(s)
        if softcap:
            th = torch.tanh(z / softcap)
            z, fac = th * softcap, 1 - th * th
        p = torch.exp2(z * _LOG2E - lse2[b, h, rows][:, None])
        if masked:
            seen = (kpos[keys] > lo[b, rows, None]) & \
                   (kpos[keys] <= hi[b, rows, None])
            p = torch.where(seen, p, 0.0)
        return p, p * fac

    part_k = torch.zeros((B, nk * _ROWS, Hq, D))
    part_v = torch.zeros((B, nk * _ROWS, Hq, Dv))
    visited = full = 0
    for b in range(B):
        for h in range(Hq):
            hk = h // G
            for kb in range(nk):
                k0, k1 = kb * _ROWS, kb * _ROWS + _ROWS - 1
                keys = slice(k0, k1 + 1)
                dv = torch.zeros((_ROWS, Dv))
                dk = torch.zeros((_ROWS, D))
                for i in range(n):
                    if not (ty[b, i] >= k0 and tx[b, i] <= k1):
                        continue                  # the hull misses the block
                    masked = not (tz[b, i] <= k0 and k1 <= tw[b, i])
                    visited += 1
                    full += not masked
                    rows = slice(i * _ROWS, (i + 1) * _ROWS)
                    # the S^T side: P^T, handed over with its factor
                    s = Q[b, rows, h] @ K[b, keys, hk].T
                    p, pf = probs(s, rows, keys, b, h, masked)
                    hand = pf.T.clone()
                    dv += p.T @ dO[b, rows, h]
                    # the dP^T side
                    dpt = V[b, keys, hk] @ dO[b, rows, h].T
                    dst = hand * (dpt - delta[b, rows, h][None]) * scale
                    dk += dst @ Q[b, rows, h]
                part_k[b, keys, h] = dk
                part_v[b, keys, h] = dv
    dk = part_k[:, :, 0::G].clone()
    dv = part_v[:, :, 0::G].clone()
    for gi in range(1, G):                        # head order
        dk += part_k[:, :, gi::G]
        dv += part_v[:, :, gi::G]
    dq = torch.zeros((B, n * _ROWS, Hq, D))
    for b in range(B):
        for h in range(Hq):
            hk = h // G
            for i0 in range(0, n, 2):             # a block of 128 rows
                lo_key = min(int(tx[b, i0]), int(tx[b, i0 + 1]))
                hi_key = max(int(ty[b, i0]), int(ty[b, i0 + 1]))
                if hi_key < lo_key:
                    continue                      # no row sees a key
                for st in range(lo_key // dq_keys, hi_key // dq_keys + 1):
                    k0, k1 = st * dq_keys, st * dq_keys + dq_keys - 1
                    keys = slice(k0, k1 + 1)
                    for i in (i0, i0 + 1):        # a warpgroup's 64 rows
                        if not (ty[b, i] >= k0 and tx[b, i] <= k1):
                            continue
                        masked = not (tz[b, i] <= k0 and k1 <= tw[b, i])
                        rows = slice(i * _ROWS, (i + 1) * _ROWS)
                        s = Q[b, rows, h] @ K[b, keys, hk].T
                        _, pf = probs(s, rows, keys, b, h, masked)
                        dp = dO[b, rows, h] @ V[b, keys, hk].T
                        ds = pf * (dp - delta[b, rows, h][:, None]) * scale
                        dq[b, rows, h] += ds @ K[b, keys, hk]
    return ((dq[:, :T], dk[:, :S], dv[:, :S]), (visited, full))


def _dense_forward(q, k, v, qpos, window, softcap, scale):
    """o and lse (B, Hq, T) in float32, -1e30 for a row that sees no
    key."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kk, vv = (x.repeat_interleave(Hq // Hkv, 2) for x in (k, v))
    z = torch.einsum("bthd,bshd->bhts", q, kk) * scale
    if softcap:
        z = torch.tanh(z / softcap) * softcap
    qp = qpos.long()[:, None, :, None]
    kp = torch.arange(S)
    seen = (kp <= qp) & (qp >= 0)
    if window is not None:
        seen &= kp > qp - window
    z = torch.where(seen, z, -torch.inf)
    lse = torch.logsumexp(z, -1)
    p = torch.where(seen, torch.exp(z - lse[..., None]), 0.0)
    lse = torch.where(seen.any(-1), lse, -1e30)
    return torch.einsum("bhts,bshd->bthd", p, vv), lse


# B, T, S, Hq, Hkv, window, softcap, ragged: gemma2's GQA with its
# softcap and a window under a tile, recurrentgemma's MQA causal over
# several blocks (full tiles), and a window over a tile
ROLE_CASES = [
    (2, 70, 90, 4, 2, 24, 50.0, True),
    (1, 200, 230, 5, 1, None, 0.0, False),
    (1, 150, 150, 2, 2, 130, 50.0, False),
]


@pytest.mark.parametrize("case", ROLE_CASES)
def test_dh256_role_split_matches_reference_custom_vjp(case):
    B, T, S, Hq, Hkv, window, softcap, ragged = case
    q, k, v, qpos = _mk(B, T, S, Hq, Hkv, 256, 256, ragged, seed=T)
    if ragged:
        qpos[:, :5] = -1                         # padding rows: no key
    want = _ref_grads(q, k, v, qpos, window, softcap, 32)
    scale = 1.0 / 16.0
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    qp = torch.from_numpy(qpos)
    o, lse = _dense_forward(qt, kt, vt, qp, window, softcap, scale)
    do = 2 * o                                   # d sum(out^2) / d out
    got, (visited, full) = _roles_bwd(qt, kt, vt, o, do, qp, lse, window,
                                      softcap, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    n_tiles, n_blocks = 2 * -(-T // 128), -(-S // _ROWS)
    # under a causal mask from position 0 the first tiles skip the
    # later blocks; full tiles exist where a tile's rows all see a block
    assert 0 < visited <= B * Hq * n_tiles * n_blocks
    assert ragged or visited < B * Hq * n_tiles * n_blocks
    assert (full > 0) == (window != 24)


# B, T, S, Hq, Hkv, window, ragged at Dh 192 / Dv 128: deepseek-v3's
# causal MHA over several blocks (full tiles), ragged rows with padding,
# and a GQA group with a window (the GQA sum over partials of 192 and
# 128)
MLA_ROLE_CASES = [
    (1, 200, 200, 3, 3, None, False),
    (2, 70, 90, 2, 2, None, True),
    (1, 150, 150, 4, 2, 40, False),
]


@pytest.mark.parametrize("case", MLA_ROLE_CASES)
def test_mla_role_split_matches_reference_custom_vjp(case):
    """The Dh 192 / Dv 128 backward's blocking, the Dh-256 one with
    scores over 192 (S^T, S), dP over 128 and 64-key dQ stages, against
    jax.grad of the reference's custom VJP at Dh != Dv, scale
    1/sqrt(192)."""
    B, T, S, Hq, Hkv, window, ragged = case
    q, k, v, qpos = _mk(B, T, S, Hq, Hkv, 192, 128, ragged, seed=T + 1)
    if ragged:
        qpos[:, :5] = -1
    want = _ref_grads(q, k, v, qpos, window, 0.0, 32)
    scale = 1.0 / np.sqrt(192.0)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    qp = torch.from_numpy(qpos)
    o, lse = _dense_forward(qt, kt, vt, qp, window, 0.0, scale)
    do = 2 * o
    got, (visited, full) = _roles_bwd(qt, kt, vt, o, do, qp, lse, window,
                                      0.0, scale, dq_keys=_DQ_KEYS_MLA)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # full tiles (no mask) only where a tile's rows all see a block: not
    # under a window of 40 nor with ragged, padded rows here
    assert visited > 0 and (full > 0) == (window is None and not ragged)


# ----------------------------------------------------------------------
# the dK/dV pass's hand-over of P^T, emulated from the source's rules
# ----------------------------------------------------------------------
def _handover(n_parts, pair, xbufs):
    """Each side's operations on the P^T exchange for a block of
    ``n_parts`` parts, as dkdv_roles_kernel's loops issue them: two
    parts an iteration with ``pair`` (the last of an odd count alone),
    else one; ``xbufs`` exchange buffers, a part's buffer its index
    modulo 2 in a pair loop with two.  The S^T side: (wait for buffer x
    to be read, if ``reuse``), write the part, (arrive full); the dP^T
    side: (wait full), read, (arrive free, if ``later``)."""
    s_ops, p_ops = [], []

    def part(n, x, reuse, later):
        if reuse:
            s_ops.append(("sync", ("free", x)))
        s_ops.extend([("write", (x, n)), ("arrive", ("full", x))])
        p_ops.append(("sync", ("full", x)))
        p_ops.append(("read", (x, n)))
        if later:
            p_ops.append(("arrive", ("free", x)))

    n = 0
    if pair:
        while n + 1 < n_parts:                    # parts n and n + 1
            ic, id_ = n + 2 < n_parts, n + 3 < n_parts
            part(n, 0, n > 0, xbufs == 1 or ic)
            part(n + 1, xbufs - 1, xbufs == 1 or n > 0,
                 ic if xbufs == 1 else id_)
            n += 2
    while n < n_parts:                            # one part an iteration
        part(n, 0, n > 1 if xbufs == 2 else n > 0, n + 1 < n_parts)
        n += 1
    return s_ops, p_ops


def _run_handover(s_ops, p_ops):
    """Runs both sides with named-barrier semantics (a bar.sync of one
    side completes once the other side's matching bar.arrive is in; no
    side arrives again at a barrier whose last phase the other has not
    synced) and checks that a part is written only into a buffer whose
    last part was read and read only once written.  Returns whether both
    sides finish."""
    ops = {"s": list(s_ops), "p": list(p_ops)}
    arrived = {"s": {}, "p": {}}
    synced = {"s": {}, "p": {}}
    held, read = {}, set()
    while ops["s"] or ops["p"]:
        moved = False
        for side, other in (("s", "p"), ("p", "s")):
            if not ops[side]:
                continue
            kind, arg = ops[side][0]
            if kind == "sync":
                if arrived[other].get(arg, 0) <= synced[side].get(arg, 0):
                    continue
                synced[side][arg] = synced[side].get(arg, 0) + 1
            elif kind == "arrive":
                if arrived[side].get(arg, 0) > synced[other].get(arg, 0):
                    continue
                arrived[side][arg] = arrived[side].get(arg, 0) + 1
            elif kind == "write":
                x, n = arg
                assert x not in held or held[x] in read, (x, n)
                held[x] = n
            else:
                x, n = arg
                assert held.get(x) == n, (x, n, held.get(x))
                read.add(n)
            ops[side].pop(0)
            moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("n_parts", range(1, 10))
@pytest.mark.parametrize("pair, xbufs", [(True, 2), (True, 1), (False, 1)])
def test_roles_pass_hands_every_part_over_once(n_parts, pair, xbufs):
    """The S^T side's P^T reaches the dP^T side part by part through the
    exchange buffers: no part overwritten before it is read, none read
    before it is written, every barrier's arrivals matched by its waits,
    and no deadlock, for blocks of 1 to 9 parts: two parts an iteration
    with two buffers (Dh 192 / Dv 128) or one (its four-stage layout),
    and one part an iteration with one (Dh 256)."""
    s_ops, p_ops = _handover(n_parts, pair, xbufs)
    assert _run_handover(s_ops, p_ops)
    writes = [arg[1] for kind, arg in s_ops if kind == "write"]
    assert writes == list(range(n_parts))
    # every free arrival is waited for: the block ends with none pending
    frees = sum(kind == "arrive" and arg[0] == "free" for kind, arg in p_ops)
    assert frees == sum(kind == "sync" for kind, _ in s_ops)


def test_roles_pass_rules_are_the_sources():
    """_handover's rules are dkdv_roles_kernel's math() calls, and the
    192 / 128 layout (three stages beside two exchange buffers, or four
    beside one) fits the 232,448 bytes a block may have, with its 1024
    of alignment."""
    from repro_torch.kernels.flash_attention import kernel as fk

    text = (Path(fk.__file__).resolve().parents[2] / "csrc"
            / "flash_attn_bwd_hd.cu").read_text()
    for line in ("math(sc, sa, i, 0, n > 0, kXB == 1 || ic < p.n_tiles);",
                 "math(sc2, sb, ib, kXB - 1, kXB == 1 || n > 0,",
                 "(kXB == 1 ? ic : id) < p.n_tiles);",
                 "math(sc, s, i, 0, kXB == 2 ? n > 1 : n > 0, "
                 "in < p.n_tiles);",
                 "static constexpr int kXBufs = kPair<DK> ? 2 : 1;",
                 "static constexpr int kS = DK == 256 ? kStages : 5 - kXBufs;",
                 "constexpr bool kPair = DK == 192;",
                 "constexpr bool kHeadMajor = DK == 192;"):
        assert line in text, line

    def smem(DK, DV, stages, xbufs):
        stage = _ROWS * (DK + DV) * 2 + 2 * _ROWS * 4 + _ROWS * 8
        return (_ROWS * (DK + DV) * 2 + stages * stage
                + xbufs * _ROWS * _ROWS * 4 + 8 * (1 + 2 * stages))
    assert smem(192, 128, 3, 2) == 199_736
    assert smem(192, 128, 4, 1) == 225_352
    assert smem(256, 256, 2, 1) == 215_080
    for size in (199_736, 225_352, 215_080):
        assert size + 1024 <= 232_448
    # a fourth stage beside two buffers would not fit
    assert smem(192, 128, 4, 2) + 1024 > 232_448


def test_probe_codes_are_the_sources():
    """The wrapper's probe and part codes are the source's enums, and
    the function's parts launch the function's own dK/dV kernel (no
    probe instantiation of their own)."""
    from repro_torch.kernels.flash_attention import kernel as fk

    text = (Path(fk.__file__).resolve().parents[2] / "csrc"
            / "flash_attn_bwd_hd.cu").read_text()
    for line in ("enum { kNoProbe = 0, kNoMath = 1, kNoCopies = 2 };",
                 "enum { kPrePassAlone = 3, kPassAlone = 4 };",
                 "if (kProbe == wg::kPrePassAlone) return e;",
                 "kProbe == wg::kNoMath || kProbe == wg::kNoCopies ? kProbe",
                 "probe < wg::kNoMath || probe > wg::kPassAlone)"):
        assert line in text, line
    assert fk.BWD_PROBES == {"no math": 1, "no copies": 2}
    assert fk.BWD_PARTS == {"pre-pass": 3, "pre-pass and dK/dV": 4}
    assert not set(fk.BWD_PROBES) & set(fk.BWD_PARTS)
