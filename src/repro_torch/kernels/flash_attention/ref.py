"""Plain PyTorch dense attention: the oracle of every other version.

Materializes the full (B, Hkv, G, T, S) logit tensor, O(T·S) memory,
so it is only usable at small scale; it defines the semantics the
blockwise version and the CUDA kernel reproduce.  The casts are the
reference's: logits in float32 (a product of two bfloat16 values is
exact in float32), ``p`` cast to the input dtype before the PV product,
which accumulates in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window) -> torch.Tensor:
    """qpos (B,T) int, kpos (S,) -> (B,T,S) bool.  window None => causal;
    else causal AND kpos > qpos - window."""
    m = kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        m &= kpos[None, None, :] > qpos[:, :, None] - window
    m &= qpos[:, :, None] >= 0          # padded/query-invalid rows
    return m


def join_rope(q, k, q_rope, k_rope):
    """q and k with their RoPE columns appended, as MLA's naive form
    concatenates them: q_rope (B, T, Hq, Dr) after q's, and k_rope (B, S,
    1, Dr), one RoPE key a position, after every kv head's of k."""
    B, S, Hkv = k.shape[:3]
    return (torch.cat([q, q_rope], -1),
            torch.cat([k, k_rope.expand(B, S, Hkv, k_rope.shape[-1])], -1))


def dense_attention(q, k, v, *, qpos, window=None, softcap: float = 0.0,
                    scale: Optional[float] = None, q_rope=None,
                    k_rope=None) -> torch.Tensor:
    """q (B,T,Hq,Dh); k (B,S,Hkv,Dh); v (B,S,Hkv,Dv); qpos (B,T) absolute
    query positions (kv positions are arange(S)).  Returns (B,T,Hq,Dv).
    ``q_rope`` and ``k_rope``, given together, are joined to q and k
    first (:func:`join_rope`)."""
    if q_rope is not None or k_rope is not None:
        q, k = join_rope(q, k, q_rope, k_rope)
    B, T, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, T, Hkv, G, Dh)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    m = _mask(qpos, torch.arange(S, device=q.device), window)   # (B,T,S)
    s = torch.where(m[:, None, None], s, -torch.inf)
    # fully-masked rows -> zero output (matches blockwise l==0 guard)
    row_any = m.any(dim=-1)                                      # (B,T)
    p = torch.softmax(s, dim=-1)
    p = torch.where(row_any[:, None, None, :, None], p, 0.0)
    o = torch.einsum("bkgts,bskd->btkgd", p.to(q.dtype).float(), v.float())
    return o.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)
