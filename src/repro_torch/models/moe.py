"""Mixture-of-Experts FFN (qwen3-moe, deepseek-v3): the port of the
reference's ``repro/models/moe.py``, per layer (the reference stacks
the layers with a leading ``L``).

``moe_ffn(..., impl=)`` takes the reference's three dispatches:

  * ``"sort"``: top-k routing, grouping of the (token, choice) pairs
    into (E, C) capacity slots by a stable sort, batched expert
    products, and the combine back to the tokens, over all E experts
    on one device.  It books no collective on plain tensors.  Given a
    DTensor ``x`` (the dry-run's, where E does not divide the "model"
    axis: the reduced configs' 8 experts on 16 columns) it does what
    the reference leaves to GSPMD there, on purpose and counted: ``x``
    and every weight are redistributed to ``Replicate`` (all-gathers of
    x over its batch axes, of the router and the expert stacks over
    "model", and under FSDP over "data"), every rank sorts all the
    tokens locally, and the output takes x's placements back (a local
    slice, no collective).  The gradients are whole on every rank.
  * ``"ep"``: expert parallelism, the reference's ``_moe_ffn_ep``.  x
    must be a DTensor whose mesh has a "model" dim that divides E.  x
    goes to ``Shard(0)`` over the batch axes ("pod", "data"; all
    replicated when they do not divide the batch, as a decode batch
    may not) and ``Replicate`` over "model"; the router to
    ``Replicate``; the expert stacks to ``Shard(0)`` over "model"; the
    shared expert's ``w_gate``/``w_up`` to ``Shard(1)`` and ``w_down``
    to ``Shard(0)`` over "model".  Each of these redistributions is a
    counted collective where the placement changes (under the serve
    rules, the router's all-gather alone; under FSDP also each
    stack's all-gather over "data").  On its local shards, each model
    column j routes its rank's tokens, dispatches only to its experts
    ``[j * E_loc, (j + 1) * E_loc)`` at the capacity of the local token
    count, and adds its slice of the shared expert: a partial output,
    made whole by one all-reduce over "model" (a ``Partial``
    redistributed to ``Replicate``, which carries the gradient).  The
    aux loss is averaged over "model" and the batch axes: one more
    all-reduce of a scalar, none on the cache paths (``aux=False``).
    The backward's local gradients are partial sums over the axes a
    weight is replicated on, and DTensor reduces them.
  * ``"auto"`` (the default): ``"ep"`` when x is a DTensor whose mesh
    has a "model" dim that divides E, else ``"sort"``: the port's
    counterpart of the reference's mesh in context.

The sort dispatch's capacity semantics are the reference's exactly:

  * ``C = max(1, int(cf * B * T * k / E))`` over the tokens the caller
    passes (the serving engine's empty slots included), for ep over a
    rank's local tokens;
  * a stable sort of the flattened expert ids in token-major order,
    the position within an expert from ``searchsorted(side="left")``;
  * a pair whose position reaches ``C`` is dropped: it adds nothing to
    its token's output; a pair routed outside the dispatch's expert
    range goes to a trash group past the last expert, never counted
    against a capacity.

The combine is deterministic.  The reference's ``.at[ts].add(yw)`` is
a scatter-add; on CUDA a scatter-add of bf16 rows adds in an order that
changes from run to run.  Here each (token, choice) pair looks up its
slot's weighted row (a zero row for a drop), and a token's k rows are
summed in choice order: the same sum up to its order of addition, and
the same bits on every run.  The two row gathers' gradients are
gathers too (``_Gather``): a token's gradient sums its k slots' rows in
choice order, a slot's is its one pair's row.  Autograd's own backward
of a gather is an accumulating scatter, which on CUDA adds each run of
equal indices serially, and here every empty slot reads the pad row
and every dropped pair the trash slot: at qwen3's width, 4096 tokens
and capacity factor 1.25, those two scatters took 46% of a train
step's device time (NVIDIA H100 80GB HBM3, 700 W).

The router is float32 whatever the compute dtype, as ``_route``
computes it (``moe.py:63`` of the reference): rounding it to bf16 would
change which experts are chosen.  The expert products are batched
matrix products (the reference leaves them to XLA, outside any Pallas
kernel).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .common import as_dtensor, from_shards, resolve_device, silu
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


def moe_specs(mo) -> Dict[str, object]:
    """The logical axes of :func:`moe_params`'s leaves: the reference's
    specs (``repro/models/moe.py:39-57``) without "layers"."""
    s = {"router": ("embed", "experts_r"),
         "w_gate": ("experts", "embed", "expert_mlp"),
         "w_up": ("experts", "embed", "expert_mlp"),
         "w_down": ("experts", "expert_mlp", "embed")}
    if mo.n_shared:
        s["shared"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                       "w_down": ("mlp", "embed")}
    return s


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


class _Gather(torch.autograd.Function):
    """``src[idx]``, rows, whose gradient is gathered: ``back`` (len(src),
    m) names, for each row of ``src``, the rows of the output that read
    it (``len(idx)``: none), and a row's gradient is theirs summed in
    ``back``'s column order."""

    @staticmethod
    def forward(ctx, src, idx, back):
        ctx.save_for_backward(back)
        return src[idx]

    @staticmethod
    def backward(ctx, dout):
        back, = ctx.saved_tensors
        rows = torch.cat([dout, dout.new_zeros((1,) + dout.shape[1:])])[back]
        dsrc = rows[:, 0]
        for j in range(1, rows.shape[1]):                 # a fixed order
            dsrc = dsrc + rows[:, j]
        return dsrc, None, None


def _dispatch_compute_combine(xf, w, ids, wg, wu, wd, *, capacity: int,
                              n_experts: Optional[int] = None,
                              e_base: int = 0) -> torch.Tensor:
    """The sort dispatch for experts ``[e_base, e_base + n_experts)``
    (default: all ``wg.shape[0]`` of them), whose stacks wg, wu, wd
    hold, over tokens xf (N, D) routed by ids, w (N, k): the (N, D)
    output of that expert range.  A pair routed outside it goes to the
    trash group, a dropped pair to the trash slot E * C, which no expert
    reads."""
    N, D = xf.shape
    cdt, dev = xf.dtype, xf.device
    E = wg.shape[0] if n_experts is None else n_experts
    C, k = capacity, ids.shape[1]
    flat_e = ids.reshape(-1) - e_base                     # local expert id
    in_range = (flat_e >= 0) & (flat_e < E)
    flat_e = torch.where(in_range, flat_e, E)             # E: the trash group
    flat_t = torch.arange(N * k, device=dev) // k
    flat_w = w.reshape(-1).to(cdt)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    pos_in_e = (torch.arange(N * k, device=dev)
                - torch.searchsorted(se, se, side="left"))
    keep = (pos_in_e < C) & (se < E)                      # capacity drop
    slot = torch.where(keep, se * C + pos_in_e, E * C)
    # each slot's token (N: an empty slot, the zero row) and weight.  A
    # kept pair owns its slot alone; the others all write the same
    # value into the trash slot E * C, so no write order shows
    ts = torch.full((E * C + 1,), N, dtype=torch.long, device=dev)
    ts.scatter_(0, slot, torch.where(keep, st, N))
    ws = torch.zeros((E * C + 1,), dtype=cdt, device=dev)
    ws.scatter_(0, slot, torch.where(keep, sw, 0))
    # each (token, choice) pair's slot, E * C for a drop; each slot's
    # pair (N * k: none), written as ts is
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    owner = torch.full((E * C + 1,), N * k, dtype=torch.long, device=dev)
    owner.scatter_(0, slot, torch.where(keep, order, N * k))
    xpad = torch.cat([xf, xf.new_zeros((1, D))])
    # a token's gradient: its k slots' rows (none for the pad row)
    back = torch.cat([pair_slot.reshape(N, k),
                      pair_slot.new_full((1, k), E * C)])
    xe = _Gather.apply(xpad, ts[:-1], back).reshape(E, C, D)
    g = torch.bmm(xe, wg.to(cdt))
    u = torch.bmm(xe, wu.to(cdt))
    y = torch.bmm(silu(g) * u, wd.to(cdt))
    yw = torch.cat([y.reshape(E * C, D) * ws[:-1, None],
                    y.new_zeros((1, D))])
    # each (token, choice) pair's row: its slot's, or the zero row
    rows = _Gather.apply(yw, pair_slot, owner[:, None]).reshape(N, k, D)
    out = rows[:, 0]
    for j in range(1, k):                                 # a fixed order
        out = out + rows[:, j]
    return out


def _shared_ffn(p: Params, x: torch.Tensor, cdt) -> torch.Tensor:
    sp = p["shared"]
    g = x @ sp["w_gate"].to(cdt)
    u = x @ sp["w_up"].to(cdt)
    return (silu(g) * u) @ sp["w_down"].to(cdt)


def moe_ffn(p: Params, x: torch.Tensor, mo, *, aux: bool = True,
            impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux_loss).  One layer's params.
    ``impl``: "sort", "ep" or "auto" (the module's docstring).
    ``aux=False``: aux_loss is None, left uncomputed."""
    mesh = _ep_mesh(x, mo)
    if impl == "auto":
        impl = "ep" if mesh is not None else "sort"
    if impl == "ep":
        if mesh is None:
            raise ValueError(
                f"impl='ep' needs x as a DTensor whose mesh has a 'model' "
                f"dim dividing the {mo.num_experts} experts")
        return _moe_ffn_ep(p, x, mo, aux)
    if impl != "sort":
        raise ValueError(f"impl must be 'auto', 'sort' or 'ep', not {impl!r}")
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_ffn_replicated(p, x, mo, aux)
    return _moe_ffn_sort(p, x, mo, aux)


def _moe_ffn_sort(p: Params, x: torch.Tensor, mo, aux: bool):
    """The sort dispatch over all E experts on plain tensors."""
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


def _ep_mesh(x, mo):
    """x's mesh where it is a DTensor whose "model" dim divides E."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names or \
            mo.num_experts % mesh.size(names.index("model")):
        return None
    return mesh


def _summed(placements):
    """x's placements for the output: a partial sum's dim replicated (a
    value's sum is itself on every rank; nothing redistributes to a
    partial)."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial() else p for p in placements]


def _moe_ffn_replicated(p: Params, x, mo, aux: bool):
    """The sort dispatch of a DTensor x on every rank: x and the weights
    gathered whole (counted), the output handed back in x's
    placements."""
    from torch.distributed.tensor import Replicate
    from repro_torch.tree import tree_map
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return as_dtensor(t, mesh).redistribute(mesh, rep).to_local()
    out, aux_loss = _moe_ffn_sort(tree_map(whole, p), whole(x), mo, aux)
    out = from_shards(out, mesh, rep, x.shape).redistribute(
        mesh, _summed(x.placements))
    if aux_loss is not None:
        aux_loss = from_shards(aux_loss, mesh, rep, ())
    return out, aux_loss


def _moe_ffn_ep(p: Params, x, mo, aux: bool):
    """Expert-parallel path (the module's docstring): the reference's
    ``shard_map`` body on each rank's local shards, its ``in_specs`` as
    placements, its ``psum`` a ``Partial`` over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    size = dict(zip(names, mesh.shape))
    nm = size["model"]
    batch_axes = [a for a in ("pod", "data") if a in size]
    nb = math.prod(size[a] for a in batch_axes)
    B, T, D = x.shape
    if nb > 1 and B % nb:                   # a non-divisible decode batch
        batch_axes, nb = [], 1
    E_loc = mo.num_experts // nm
    C = max(1, int(mo.capacity_factor * (B // nb) * T * mo.top_k
                   / mo.num_experts))

    def placed(model, batch):
        """Placements: ``model`` on "model", ``batch`` on the batch
        axes, Replicate on the others."""
        return [model if a == "model" else batch if a in batch_axes
                else Replicate() for a in names]

    def local(t, model, grad_model):
        """t's shard with ``model`` on "model" (replicated over the batch
        axes); its gradient, ``grad_model`` on "model", is a partial sum
        over the batch axes, whose ranks see other tokens."""
        return as_dtensor(t, mesh).redistribute(
            mesh, placed(model, Replicate())).to_local(
            grad_placements=placed(grad_model, Partial()))

    # x replicated over "model": each column's gradient is a partial sum
    xl = x.redistribute(mesh, placed(Replicate(), Shard(0))).to_local(
        grad_placements=placed(Partial(), Shard(0)))
    router = local(p["router"], Replicate(), Partial())
    wg, wu, wd = (local(p[n], Shard(0), Shard(0))
                  for n in ("w_gate", "w_up", "w_down"))
    Bl = xl.shape[0]
    xf = xl.reshape(Bl * T, D)
    w, ids, aux_loss = _route(router, xf, mo.top_k, aux)
    j = mesh.get_local_rank("model")
    out = _dispatch_compute_combine(
        xf, w, ids, wg, wu, wd, capacity=C, n_experts=E_loc,
        e_base=j * E_loc).reshape(Bl, T, D)
    if "shared" in p:
        # the shared expert's F dim is model-sharded: a partial too
        sp = p["shared"]
        out = out + _shared_ffn(
            {"shared": {"w_gate": local(sp["w_gate"], Shard(1), Shard(1)),
                        "w_up": local(sp["w_up"], Shard(1), Shard(1)),
                        "w_down": local(sp["w_down"], Shard(0), Shard(0))}},
            xl, xl.dtype)
    # the reference's psum over "model"
    out = from_shards(out, mesh, placed(Partial(), Shard(0)), x.shape)
    out = out.redistribute(mesh, placed(Replicate(), Shard(0)))
    out = out.redistribute(mesh, _summed(x.placements))
    if aux_loss is not None:
        # the mean over "model" and the batch axes: a sum of shares
        aux_loss = from_shards(aux_loss / (nm * nb), mesh,
                               placed(Partial(), Partial()), ())
        aux_loss = aux_loss.redistribute(mesh, [Replicate()] * mesh.ndim)
    return out, aux_loss
