"""Blockwise online-softmax attention in plain PyTorch.

The module keeps the reference's name (``repro/kernels/flash_attention/
jnp_impl.py``) so the two packages map file to file; here it holds
PyTorch, not jnp.  It is the plain version of the CUDA kernel in
``csrc/flash_attn_hd.cu``: the same block structure and the same math,
O(block_q x block_kv) logits instead of O(T x S).

Two paths:
  * ``blockwise``: outer loop over q blocks, inner loop over kv blocks,
    online-softmax carry (m, l, acc).  Handles causal + window +
    softcap + ragged per-batch q positions.
  * ``banded``: static integer ``window`` -- each q block attends only
    the (window + block_q)-wide kv band that can possibly be visible.
    O(T·W) compute, the sub-quadratic local attention path.

``blockwise`` is differentiable through the port of the reference's
flash-style ``custom_vjp`` (``_BlockwiseAttention``, a
``torch.autograd.Function``): the forward saves the float32 output and
the per-row log-sum-exp, and the backward (``_bw_blocks``) recomputes
each (bq x bk) probability block from them, so autograd never stores
O(T·S) of them.  It is the plain version of the backward kernel in
``csrc/flash_attn_bwd_hd.cu``.  ``banded`` is differentiated by
autograd, as the reference's is by jax.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .ref import join_rope

NEG_INF = -1e30


def _pad_to(x: torch.Tensor, n: int, axis: int, value=0) -> torch.Tensor:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths, value=value)


def _block_mask(qpos_blk, kpos_blk, window):
    """qpos (B,bq), kpos (bk,) or (B,bk) -> (B,bq,bk) bool."""
    if kpos_blk.ndim == 1:
        kpos_blk = kpos_blk[None, :]
    m = kpos_blk[:, None, :] <= qpos_blk[:, :, None]
    if window is not None:
        m &= kpos_blk[:, None, :] > qpos_blk[:, :, None] - window
    m &= qpos_blk[:, :, None] >= 0
    m &= kpos_blk[:, None, :] >= 0
    return m


def _attend_block(qg, k, v, mask, softcap, scale, m, l, acc):
    """One online-softmax update.  qg (B,bq,Hkv,G,Dh); k/v (B,bk,Hkv,*);
    mask (B,bq,bk); carries m,l (B,Hkv,G,bq), acc (B,bq,Hkv,G,Dv)."""
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    # rows with everything masked: m_new stays NEG_INF; exp(0)=1 garbage --
    # zero those probabilities explicitly.
    p = torch.where(mask[:, None, None].any(dim=-1, keepdim=True), p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l, acc


def _finish(acc, l):
    l_t = l.permute(0, 3, 1, 2)[..., None]
    return torch.where(l_t > 0, acc / torch.clamp(l_t, min=1e-30), 0.0)


def _carries(B, Hkv, G, bq, Dv, device):
    m0 = torch.full((B, Hkv, G, bq), NEG_INF, dtype=torch.float32,
                    device=device)
    l0 = torch.zeros((B, Hkv, G, bq), dtype=torch.float32, device=device)
    a0 = torch.zeros((B, bq, Hkv, G, Dv), dtype=torch.float32, device=device)
    return m0, l0, a0


def _logits(qg_i, k_j, softcap, scale):
    """z (f32) of a block pair: q.k times scale, softcapped."""
    s = torch.einsum("btkgd,bskd->bkgts", qg_i.float(), k_j.float()) * scale
    return torch.tanh(s / softcap) * softcap if softcap else s


def _blocks(q, k, v, qpos, block_q, block_kv):
    """The padded operands and block sizes: qg (B, nq*bq, Hkv, G, Dh),
    qp (B, nq*bq) with -1 past T, k and v padded to nk*bk, kpos with -1
    past S, and (bq, bk)."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    bq, bk = min(block_q, T), min(block_kv, S)
    nq, nk = -(-T // bq), -(-S // bk)
    qg = _pad_to(q.reshape(B, T, Hkv, Hq // Hkv, Dh), nq * bq, 1)
    qp = _pad_to(qpos.to(torch.int64), nq * bq, 1, value=-1)
    kp_, vp_ = _pad_to(k, nk * bk, 1), _pad_to(v, nk * bk, 1)
    ar = torch.arange(nk * bk, device=q.device)
    kpos = torch.where(ar < S, ar, -1)
    return qg, qp, kp_, vp_, kpos, bq, bk


def _fwd_blocks(qg, qp, kp_, vp_, kpos, w, softcap, scale, bq, bk):
    """The forward over (q block outer, kv block inner) loops.  Returns
    the float32 output (B, nq*bq, Hkv, G, Dv) and the per-row
    log-sum-exp (B, Hkv, G, nq*bq), which the backward needs to rebuild
    p without storing it."""
    B, Tp, Hkv, G, _ = qg.shape
    Dv = vp_.shape[-1]
    out, lse = [], []
    for i in range(Tp // bq):
        qg_i, qp_i = qg[:, i * bq:(i + 1) * bq], qp[:, i * bq:(i + 1) * bq]
        m, l, acc = _carries(B, Hkv, G, bq, Dv, qg.device)
        for j in range(kp_.shape[1] // bk):
            sl = slice(j * bk, (j + 1) * bk)
            mask = _block_mask(qp_i, kpos[sl], w)
            m, l, acc = _attend_block(qg_i, kp_[:, sl], vp_[:, sl], mask,
                                      softcap, scale, m, l, acc)
        out.append(_finish(acc, l))
        lse.append(torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                               NEG_INF))
    return torch.cat(out, dim=1), torch.cat(lse, dim=-1)


def _bw_blocks(qg, qp, kp_, vp_, kpos, ob, lse, dob, w, softcap, scale,
               bq, bk):
    """Flash backward: recompute p per block pair from lse; never
    materialize more than one (bq x bk) block of probabilities.  The
    reference's loops (kv blocks outer, q blocks inner) and math, all
    in float32.  Returns dq (B, nq*bq, Hkv, G, Dh), dk and dv
    (B, nk*bk, Hkv, Dh|Dv), float32."""
    nq, nk = qg.shape[1] // bq, kp_.shape[1] // bk
    # delta[b,k,g,t] = sum_d do*o  (rows of the softmax jacobian)
    delta = torch.einsum("btkgd,btkgd->bkgt", dob, ob)
    # *_like: a DTensor operand (the dry-run's) keeps its placements
    dq = torch.zeros_like(qg, dtype=torch.float32)
    dks, dvs = [], []
    for j in range(nk):
        sl = slice(j * bk, (j + 1) * bk)
        k_j, v_j, kp_j = kp_[:, sl].float(), vp_[:, sl].float(), kpos[sl]
        dk_j = torch.zeros_like(k_j)
        dv_j = torch.zeros_like(v_j)
        for i in range(nq):
            rows = slice(i * bq, (i + 1) * bq)
            qg_i, do_i = qg[:, rows].float(), dob[:, rows]
            mask = _block_mask(qp[:, rows], kp_j, w)[:, None, None]
            z = _logits(qg_i, k_j, softcap, scale)
            # a fully masked row has lse = NEG_INF: where, not a product
            p = torch.where(mask, torch.exp(z - lse[..., rows, None]), 0.0)
            dv_j += torch.einsum("bkgts,btkgd->bskd", p, do_i)
            dp = torch.einsum("btkgd,bskd->bkgts", do_i, v_j)
            dz = p * (dp - delta[..., rows, None])
            if softcap:
                dz = dz * (1.0 - torch.square(z / softcap))
            dz = dz * scale
            dq[:, rows] += torch.einsum("bkgts,bskd->btkgd", dz, k_j)
            dk_j += torch.einsum("bkgts,btkgd->bskd", dz, qg_i)
        dks.append(dk_j)
        dvs.append(dv_j)
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


class _BlockwiseAttention(torch.autograd.Function):
    """``blockwise_attention`` with the reference's flash-style custom
    VJP (``_blockwise_cvjp_fwd`` / ``_blockwise_cvjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, w, softcap, scale, block_q, block_kv):
        qg, qp, kp_, vp_, kpos, bq, bk = _blocks(q, k, v, qpos, block_q,
                                                 block_kv)
        ob, lse = _fwd_blocks(qg, qp, kp_, vp_, kpos, w, softcap, scale,
                              bq, bk)
        ctx.save_for_backward(q, k, v, qpos, ob, lse)
        ctx.args = (w, softcap, scale, block_q, block_kv)
        B, T, Hq, _ = q.shape
        return ob[:, :T].reshape(B, T, Hq, -1).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, qpos, ob, lse = ctx.saved_tensors
        w, softcap, scale, block_q, block_kv = ctx.args
        B, T, Hq, Dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        qg, qp, kp_, vp_, kpos, bq, bk = _blocks(q, k, v, qpos, block_q,
                                                 block_kv)
        dob = _pad_to(do.float().reshape(B, T, Hkv, Hq // Hkv, -1),
                      qg.shape[1], 1)
        dq, dk, dv = _bw_blocks(qg, qp, kp_, vp_, kpos, ob, lse, dob, w,
                                softcap, scale, bq, bk)
        return (dq[:, :T].reshape(B, T, Hq, Dh).to(q.dtype),
                dk[:, :S].to(k.dtype), dv[:, :S].to(v.dtype),
                None, None, None, None, None, None)


def blockwise_attention(q, k, v, *, qpos, window=None, softcap: float = 0.0,
                        scale: Optional[float] = None,
                        block_q: int = 512, block_kv: int = 1024,
                        q_rope=None, k_rope=None):
    """q (B,T,Hq,Dh); k (B,S,Hkv,Dh); v (B,S,Hkv,Dv); qpos (B,T).
    ``window``: None (causal) or an int (sliding window).  Returns
    (B,T,Hq,Dv) in q.dtype.  ``q_rope`` and ``k_rope``, given together,
    are joined to q and k first (``ref.join_rope``).

    Differentiable via the flash-style backward (``_BlockwiseAttention``):
    it recomputes each (bq x bk) probability block from the saved
    per-row log-sum-exp instead of letting autograd store every block."""
    if q_rope is not None or k_rope is not None:
        q, k = join_rope(q, k, q_rope, k_rope)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    w = window if window is not None else 1 << 30
    return _BlockwiseAttention.apply(q, k, v, qpos, w, float(softcap),
                                     float(scale), int(block_q),
                                     int(block_kv))


def banded_attention(q, k, v, *, qpos, window: int, softcap: float = 0.0,
                     scale: Optional[float] = None, block_q: int = 512):
    """Static sliding-window attention: each q block sees only its
    (window + block_q) kv band.  O(T·window) compute and memory.

    Requires contiguous per-batch positions: qpos[b] = off[b] + arange(T)
    and kv laid out so kv index s has position s (the prefill layout)."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    bq = min(block_q, T)
    nq = -(-T // bq)
    L = min(S, window + bq)                  # static band length

    qg = _pad_to(q, nq * bq, 1).reshape(B, nq * bq, Hkv, G, Dh)
    qpp = _pad_to(qpos.to(torch.int64), nq * bq, 1, value=-1)
    bidx = torch.arange(B, device=q.device)[:, None]
    band = torch.arange(L, device=q.device)[None, :]
    out = []
    for i in range(nq):
        qg_i, qp_i = qg[:, i * bq:(i + 1) * bq], qpp[:, i * bq:(i + 1) * bq]
        # band start: highest kv index visible is max qpos in block; lowest
        # is (min qpos) - window + 1.  Clamp into [0, S-L].
        lo = qp_i.amax(dim=1) - (L - 1)                      # (B,)
        start = torch.clamp(lo, 0, S - L)
        kpos_b = start[:, None] + band                       # (B, L)
        ks, vs = k[bidx, kpos_b], v[bidx, kpos_b]            # (B,L,Hkv,*)
        kpos_b = torch.where(kpos_b < S, kpos_b, -1)
        mask = _block_mask(qp_i, kpos_b, window)
        m, l, acc = _attend_block(qg_i, ks, vs, mask, softcap, scale,
                                  *_carries(B, Hkv, G, bq, Dv, q.device))
        out.append(_finish(acc, l))
    o = torch.cat(out, dim=1).reshape(B, nq * bq, Hq, Dv)
    return o[:, :T].to(q.dtype)
