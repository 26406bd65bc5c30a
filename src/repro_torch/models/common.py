"""Shared model components: the part of the reference's
``repro/models/common.py`` that serving and training need.

Every function keeps the reference's casts, because each is a place
where two frameworks could round differently:

  * ``rms_norm`` computes in float32 and scales by ``1 + scale``;
  * ``rope`` is half-split (not interleaved), with float32 angles;
  * ``gqa_attention`` scales q in the compute dtype before q.k, takes
    the logits in the compute dtype, then float32 for the mask
    (-1e30) and the softmax, and casts the probabilities back before
    p.v.

``resolve_device`` turns every entry point's ``device`` (default
"cuda") into a torch.device and raises without a card.

``cross_entropy_loss`` and ``fused_cross_entropy`` are the training
losses, in float32.  The gold logit is a ``gather``; the reference's
iota-compare masked sum, which keeps a vocab-sharded axis local, takes
its place for DTensor logits (the dry-run's); the two give the same
value.  ``fused_cross_entropy`` runs
each sequence chunk under ``torch.utils.checkpoint``, as the reference
runs its ``lax.scan`` body under ``jax.checkpoint``.

``batch_update`` is the per-slot cache write of the reference's
``sharded_batch_update``.  It writes in place (the reference's is
functional) and clamps each start into the cache the way
``lax.dynamic_update_slice`` does; a DTensor cache (the dry-run's) is
written shard by shard, as the reference's ``shard_map`` writes it.

``shardwise`` applies an elementwise function to each shard of a
DTensor (an op DTensor has no sharding strategy for, such as
``log_sigmoid``), its placements kept, or a function along one dim
(``roll``'s shift, xlstm's prefix sum of its log-gates), that dim
gathered first where it is sharded; ``as_dtensor`` takes a plain
tensor as one replicated over a mesh, and ``from_shards`` makes a
DTensor of each rank's shard.  ``add_bias`` sums a DTensor's partial
products before a bias is added, as GSPMD reduces before an add, and
``gather_rows`` gathers an embedding's row gradients along the token
dims before they are scattered.  On plain tensors each runs the op
itself, bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} needs a CUDA device; pass "
                           f"device='cpu' to run on the host")
    return dev


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0,
         scale: float = 1.0) -> torch.Tensor:
    """Rotary embedding over the last dim.  x: (..., T, H, Dh);
    positions (..., T)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = torch.pow(base, -torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = positions[..., None].float() * freq * scale     # (..., T, half)
    ang = ang[..., None, :]                               # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def make_causal_mask(q_len: int, kv_len: int, q_offset,
                     device=None) -> torch.Tensor:
    """(q_len, kv_len) boolean mask.  q_offset = absolute pos of query 0."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return k_pos <= q_pos


def make_local_mask(q_len: int, kv_len: int, q_offset, window: int,
                    device=None) -> torch.Tensor:
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    return (k_pos <= q_pos) & (k_pos > q_pos - window)


def gqa_attention(q, k, v, mask, attn_softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Tq, Hq, Dh); k,v: (B, Tk, Hkv, Dh); mask: (Tq, Tk) or
    (B, Tq, Tk) boolean.  Returns (B, Tq, Hq, Dh).
    """
    B, Tq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Tq, Hkv, groups, Dh)
    logits = torch.einsum("btkgd,bskd->bkgts", qg * scale, k)
    logits = softcap(logits, attn_softcap)
    mask_b = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    logits = torch.where(mask_b, logits.float(), -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(B, Tq, Hq, Dh)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` op by op in x's dtype, rounding after
    each op as ``jax.nn.silu`` does (``F.silu`` rounds once and differs
    in about a third of bfloat16 inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def gated_mlp(x, w_gate, w_up, w_down, act: str = "silu") -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    a = F.gelu(g, approximate="tanh") if act == "gelu" else silu(g)
    return (a * u) @ w_down


def batch_update(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Per-sequence cache write, in place: cache[b, s_b:s_b+t] = new[b]
    with s_b = pos[b] clamped into [0, cache.shape[1] - t], as
    ``dynamic_update_slice`` clamps.  The serving engine prefills the
    whole slot pool, so a slot near the end of its cache writes the
    last t rows instead of past them; the engine then restores every
    slot but the admitted one.  Returns ``cache``."""
    from torch.distributed.tensor import DTensor
    if isinstance(cache, DTensor):
        return _sharded_batch_update(cache, new, pos)
    t = new.shape[1]
    start = torch.clamp(pos.long(), 0, cache.shape[1] - t)
    rows = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[bidx, rows] = new.to(cache.dtype)
    return cache


def _sharded_batch_update(cache, new, pos):
    """:func:`batch_update` of a DTensor cache, each rank writing its
    own rows, as the reference's ``sharded_batch_update`` does under a
    mesh (its ``shard_map``): ``new`` and ``pos`` take the cache's
    placements (pos its batch dim's), then each shard updates its local
    rows in place."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    new = new.redistribute(mesh, cache.placements)
    pos = pos.redistribute(mesh, [Shard(0) if p == Shard(0) else Replicate()
                                  for p in cache.placements])
    batch_update(cache.to_local(), new.to_local(), pos.to_local())
    return cache


def as_dtensor(t: torch.Tensor, mesh):
    """``t`` as a DTensor over ``mesh``: itself if it is one, else a plain
    tensor taken as replicated (every rank holds all of it)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shardwise(fn, x: torch.Tensor, dim: Optional[int] = None
              ) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``, or with ``dim`` for an ``fn``
    that keeps x's shape and mixes elements along ``dim`` alone (a
    shift, a prefix sum); a DTensor ``x`` (the dry-run's) has ``fn``
    applied to each rank's shard, forward and backward, and keeps its
    placements.  A partial sum is summed first (a counted all-reduce):
    ``fn`` of a partial is not the partial of ``fn``.  Where ``dim`` is
    sharded it is gathered first and sharded again after (a counted
    all-gather; the slicing back is local)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    whole = pl if dim is None else [
        Replicate() if p.is_shard(dim % x.ndim) else p for p in pl]
    x = x.redistribute(x.device_mesh, whole)
    y = from_shards(fn(x.to_local()), x.device_mesh, whole, x.shape)
    return y if whole == pl else y.redistribute(y.device_mesh, pl)


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` (which wraps as ``jnp.roll``); on a
    DTensor each rank rolls its shard (:func:`shardwise` along
    ``dim``): torch 2.11's DTensor has no sharding strategy for
    ``roll``."""
    return shardwise(lambda t: torch.roll(t, shift, dim), x, dim=dim)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, the embedding lookup.  On a DTensor that takes a
    gradient, the rows' gradient is gathered along ``idx``'s dims (a
    counted all-gather) before it is scattered into the table's
    (``index_put``): torch 2.11's ``index_put`` strategy cannot place
    values sharded along an indexed dim (it builds a shard of a negative
    dim), and later releases gather them there too."""
    from torch.distributed.tensor import DTensor, Replicate
    rows = table[idx]
    if isinstance(rows, DTensor) and rows.requires_grad:
        k = idx.dim()

        def whole_rows(g):
            pl = [Replicate() if p.is_shard() and p.dim < k else p
                  for p in g.placements]
            return g if pl == list(g.placements) else \
                g.redistribute(g.device_mesh, pl)
        rows.register_hook(whole_rows)
    return rows


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y + b`` for a bias ``b`` broadcast over ``y``'s leading dims.
    Where ``y`` is a DTensor with partial sums (a product contracting a
    sharded dim), they are summed first, as GSPMD reduces before an
    add: a reduce-scatter onto the dim ``b`` is sharded on over that
    mesh dim, else an all-reduce.  Adding ``b`` to a partial would ask
    DTensor to turn ``b``'s shard into a partial, which some torch
    releases cannot, and dividing ``b`` by the rank count would change
    its bits."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(y, DTensor) and any(p.is_partial() for p in y.placements):
        bp = b.placements if isinstance(b, DTensor) else (
            [Replicate()] * y.device_mesh.ndim)
        lead = y.ndim - b.ndim
        y = y.redistribute(y.device_mesh, [
            (Shard(lead + q.dim) if q.is_shard() else Replicate())
            if p.is_partial() else p for p, q in zip(y.placements, bp)])
    return y + b


def from_shards(local: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) whose shard on this
    rank is ``local`` (shards may be uneven), differentiable."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _gold(logits, labels) -> torch.Tensor:
    """The label's logit: a gather, or for a DTensor (the dry-run's,
    its vocab axis sharded) the reference's iota-compare masked sum,
    which keeps the vocab axis local; the two give the same value."""
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        iota = torch.arange(logits.shape[-1], device=logits.device)
        hit = iota == labels[..., None].long()
        return torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    return torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _nll_sum(h_chunk, final_norm, w, labels, mask, final_softcap):
    """Summed masked NLL of one sequence chunk: norm, head, CE."""
    h = rms_norm(h_chunk, final_norm)
    logits = softcap((h @ w).float(), final_softcap or None)
    logz = torch.logsumexp(logits, dim=-1)
    return torch.sum((logz - _gold(logits, labels)) * mask)


def fused_cross_entropy(x, final_norm, out_emb, labels, mask=None,
                        final_softcap: float = 0.0,
                        chunk: int = 512) -> torch.Tensor:
    """Head matmul + CE fused over SEQUENCE CHUNKS, each under
    ``torch.utils.checkpoint``: never materializes the (B, S, V) logits,
    the biggest activation of a high-vocab train step.  The same float32
    math per chunk as ``_head`` + :func:`cross_entropy_loss`."""
    B, S, D = x.shape
    c = min(chunk, S)
    nc = -(-S // c)
    Sp = nc * c
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if Sp != S:
        x = F.pad(x, (0, 0, 0, Sp - S))
        labels = F.pad(labels, (0, Sp - S))
        mask = F.pad(mask, (0, Sp - S))
    w = out_emb.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(
            _nll_sum, x[:, sl], final_norm, w, labels[:, sl], mask[:, sl],
            final_softcap, use_reentrant=False, preserve_rng_state=False)
    return total / torch.clamp(mask.sum(), min=1)


def cross_entropy_loss(logits, labels, mask=None) -> torch.Tensor:
    """Token-level CE in float32; logits (B, S, V), labels (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - _gold(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
