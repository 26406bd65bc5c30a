"""Mixture-of-Experts FFN (qwen3-moe, deepseek-v3): the port of the
reference's ``repro/models/moe.py``, per layer (the reference stacks
the layers with a leading ``L``).

Only the reference's ``"sort"`` dispatch is ported: top-k routing,
grouping of the (token, choice) pairs into (E, C) capacity slots by a
stable sort, batched expert products, and the combine back to the
tokens.  Its capacity semantics are the reference's exactly:

  * ``C = max(1, int(cf * B * T * k / E))`` over the whole batch the
    caller passes (the serving engine's empty slots included);
  * a stable sort of the flattened expert ids in token-major order,
    the position within an expert from ``searchsorted(side="left")``;
  * a pair whose position reaches ``C`` is dropped: it adds nothing to
    its token's output.

The combine is deterministic.  The reference's ``.at[ts].add(yw)`` is
a scatter-add; on CUDA a scatter-add of bf16 rows adds in an order that
changes from run to run.  Here each (token, choice) pair looks up its
slot's weighted row (a zero row for a drop), and a token's k rows are
summed in choice order: the same sum up to its order of addition, and
the same bits on every run.

The router is float32 whatever the compute dtype, as ``_route``
computes it (``moe.py:63`` of the reference): rounding it to bf16 would
change which experts are chosen.  The expert products are batched
matrix products (the reference leaves them to XLA, outside any Pallas
kernel).  The ``"ep"`` dispatch (expert parallelism over a mesh of
cards) is not ported (ROADMAP: training's sharding).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .common import resolve_device, silu
from .layers import _normal

Params = Dict[str, torch.Tensor]


def moe_params(gen: torch.Generator, d_model: int, mo, *,
               dtype=torch.float32, device="cuda") -> Params:
    """One layer's router (float32) and expert stacks ``w_gate``/``w_up``
    (E, D, F) and ``w_down`` (E, F, D) in ``dtype``, with the
    reference's scales; ``shared`` with ``mo.n_shared``."""
    E, F = mo.num_experts, mo.d_expert_ff
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    p = {
        "router": _normal(gen, (d_model, E), 0.02, torch.float32, dev),
        "w_gate": _normal(gen, (E, d_model, F), 1 / math.sqrt(d_model), **kw),
        "w_up": _normal(gen, (E, d_model, F), 1 / math.sqrt(d_model), **kw),
        "w_down": _normal(gen, (E, F, d_model), 1 / math.sqrt(F), **kw),
    }
    if mo.n_shared:
        Fs = mo.d_shared_ff or F
        p["shared"] = {
            "w_gate": _normal(gen, (d_model, mo.n_shared * Fs),
                              1 / math.sqrt(d_model), **kw),
            "w_up": _normal(gen, (d_model, mo.n_shared * Fs),
                            1 / math.sqrt(d_model), **kw),
            "w_down": _normal(gen, (mo.n_shared * Fs, d_model),
                              1 / math.sqrt(Fs), **kw),
        }
    return p


def _route(router_w: torch.Tensor, x: torch.Tensor, top_k: int,
           aux: bool = True):
    """x: (N, D) -> (weights (N, k) float32, ids (N, k), aux_loss).
    ``aux=False`` (the cache paths, which drop it) leaves the aux loss
    uncomputed: None."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    if not aux:
        return w, ids, None
    # load-balance aux loss (Switch-style).  The choices per expert are
    # counted on the card (a float32 sum of ones is exact in any
    # order): bincount would read the ids' range back to the host
    E = logits.shape[-1]
    me = probs.mean(0)
    flat = ids.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    ce = counts / ids.numel()
    return w, ids, E * torch.sum(me * ce)


def _dispatch_compute_combine(xf, w, ids, wg, wu, wd, *,
                              capacity: int) -> torch.Tensor:
    """The sort dispatch over all E = wg.shape[0] experts for tokens xf
    (N, D) routed by ids, w (N, k): the (N, D) output.  A dropped pair
    writes into the trash slot E * C, which no expert reads."""
    N, D = xf.shape
    cdt, dev = xf.dtype, xf.device
    E, C, k = wg.shape[0], capacity, ids.shape[1]
    flat_e = ids.reshape(-1)
    flat_t = torch.arange(N * k, device=dev) // k
    flat_w = w.reshape(-1).to(cdt)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    pos_in_e = (torch.arange(N * k, device=dev)
                - torch.searchsorted(se, se, side="left"))
    keep = pos_in_e < C                                   # capacity drop
    slot = torch.where(keep, se * C + pos_in_e, E * C)
    # each slot's token (N: an empty slot, the zero row) and weight.  A
    # kept pair owns its slot alone; the others all write the same
    # value into the trash slot E * C, so no write order shows
    ts = torch.full((E * C + 1,), N, dtype=torch.long, device=dev)
    ts.scatter_(0, slot, torch.where(keep, st, N))
    ws = torch.zeros((E * C + 1,), dtype=cdt, device=dev)
    ws.scatter_(0, slot, torch.where(keep, sw, 0))
    xpad = torch.cat([xf, xf.new_zeros((1, D))])
    xe = xpad[ts[:-1]].reshape(E, C, D)
    g = torch.bmm(xe, wg.to(cdt))
    u = torch.bmm(xe, wu.to(cdt))
    y = torch.bmm(silu(g) * u, wd.to(cdt))
    yw = torch.cat([y.reshape(E * C, D) * ws[:-1, None],
                    y.new_zeros((1, D))])
    # each (token, choice) pair's row: its slot's, or the zero row
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    rows = yw[pair_slot].reshape(N, k, D)
    out = rows[:, 0]
    for j in range(1, k):                                 # a fixed order
        out = out + rows[:, j]
    return out


def _shared_ffn(p: Params, x: torch.Tensor, cdt) -> torch.Tensor:
    sp = p["shared"]
    g = x @ sp["w_gate"].to(cdt)
    u = x @ sp["w_up"].to(cdt)
    return (silu(g) * u) @ sp["w_down"].to(cdt)


def moe_ffn(p: Params, x: torch.Tensor, mo, *,
            aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux_loss).  One layer's params;
    the sort dispatch over all E experts on one device (the reference's
    ``impl="auto"`` picks it without a mesh).  ``aux=False``: aux_loss
    is None, left uncomputed."""
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    w, ids, aux_loss = _route(p["router"], xf, mo.top_k, aux)
    C = max(1, int(mo.capacity_factor * B * T * mo.top_k / mo.num_experts))
    out = _dispatch_compute_combine(xf, w, ids, p["w_gate"], p["w_up"],
                                    p["w_down"], capacity=C)
    out = out.reshape(B, T, D)
    if "shared" in p:
        out = out + _shared_ffn(p, x, x.dtype)
    return out, aux_loss
