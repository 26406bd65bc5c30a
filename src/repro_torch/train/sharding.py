"""Sharding layer: logical parameter axes -> mesh axes, the port of the
reference's ``repro/train/sharding.py`` onto DTensor placements.

  * every parameter leaf has logical axis names (each model's
    ``bundle.specs()``); a :class:`Rules` table maps logical -> mesh
    axes (None = replicate).  Changing a rule is an HDArray
    REPARTITION: no model code changes, a new collective schedule;
  * :func:`spec_to_pspec` gives the reference's partition spec (one
    entry a tensor dim: None, a mesh axis or a tuple of them) and
    :func:`spec_to_placements` the same as DTensor placements (one a
    mesh dim, ``Shard(d)`` or ``Replicate()``): a tensor dim split over
    two mesh axes is sharded by both, the earlier mesh axis the outer
    one, as ``P(("pod", "data"))`` splits it;
  * dims that do not divide their mesh axes fall back to replication,
    and no mesh axis shards two dims of one tensor;
  * :func:`predict_collectives` runs the paper's Eqns (1)-(2) at
    mesh-axis granularity with the port's own planner
    (``repro_torch.core``) for the expected per-step communication.

A ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or anything with a ``shape`` dict of axis sizes (the tests' and
the planner's stand-in for a mesh that needs no process group).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.tree import tree_leaves, tree_map


# ----------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axes (string, tuple of strings, or None)."""
    table: Dict[str, Any]
    batch_axes: Tuple[str, ...] = ("data",)       # activation batch dims
    name: str = "baseline"

    def axes_for(self, logical: str):
        return self.table.get(logical)


def baseline_rules(multi_pod: bool = False) -> Rules:
    """The automatic even ROW-style partition: params FSDP over 'data',
    heads/experts/vocab TP over 'model', replicated across pods (grad
    all-reduce over 'pod')."""
    t = {
        "vocab": "model",
        "embed": "data",        # FSDP shard dim
        "embed_head": None,     # head contraction dim: never FSDP-shard
        "embed2": "data",
        "mlp": "model",
        "qheads": "model",
        "kvheads": "model",
        "experts": "model",
        "experts_r": "model",
        "expert_mlp": None,
        "lora": None,
        "layers": None,
        "heads": None,
        "head_dim": None,
        "gates": "model",
        "inner": "model",
        "lru": "model",
        "lru_in": None,
        "conv": None,
        "vision": None,
    }
    batch = ("pod", "data") if multi_pod else ("data",)
    return Rules(t, batch_axes=batch, name="baseline")


def serve_rules(multi_pod: bool = False) -> Rules:
    """Inference rules: pure tensor parallelism.  FSDP-sharding a
    CONTRACTING dim ('embed' over data) makes every serving matmul a
    partial sum and an activation all-reduce, so weights replicate over
    'data'/'pod' and split over 'model' only; the batch still shards
    over data."""
    r = baseline_rules(multi_pod)
    t = dict(r.table)
    for k in ("embed", "embed2", "lru_in"):
        t[k] = None
    return Rules(t, batch_axes=r.batch_axes, name="serve")


def zero3_rules(multi_pod: bool = False) -> Rules:
    """FSDP over pod x data (ZeRO-3 across the whole fleet): less
    memory, more cross-pod gather traffic."""
    r = baseline_rules(multi_pod)
    t = dict(r.table)
    for k in ("embed", "embed2"):
        t[k] = ("pod", "data") if multi_pod else "data"
    return Rules(t, batch_axes=r.batch_axes, name="zero3")


# ----------------------------------------------------------------------
# spec -> placements
# ----------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a stand-in with a
    ``shape`` dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple of logical axis names."""
    return isinstance(x, tuple) and all(isinstance(s, str) for s in x)


def _mesh_axis_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(sizes[a] for a in axes)


def spec_to_pspec(logical: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                  rules: Rules) -> Tuple[Any, ...]:
    """One param's partition spec: per dim None, a mesh axis or a tuple
    of them, falling back to replication when the dim does not divide
    the mesh axes (the reference's ``spec_to_pspec``)."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for name, dim in zip(logical, shape):
        ax = rules.axes_for(name)
        if ax is None:
            out.append(None)
            continue
        axs = (ax,) if isinstance(ax, str) else tuple(ax)
        axs = tuple(a for a in axs if a in sizes and a not in used)
        n = _mesh_axis_size(sizes, axs)
        if axs and dim % n == 0:
            used.update(axs)
            out.append(axs if len(axs) > 1 else axs[0])
        else:
            out.append(None)
    return tuple(out)


def pspec_to_placements(pspec: Tuple[Any, ...], mesh) -> tuple:
    """DTensor placements (one a mesh dim) of a partition spec."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, e in enumerate(pspec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def spec_to_placements(logical: Tuple[str, ...], shape: Tuple[int, ...],
                       mesh, rules: Rules) -> tuple:
    """:func:`spec_to_pspec` as DTensor placements over ``mesh``."""
    return pspec_to_placements(spec_to_pspec(logical, shape, mesh, rules),
                               mesh)


def param_shardings(specs, params_shape, mesh, rules: Rules):
    """specs: tree of logical tuples; params_shape: the matching tree of
    tensors (fake, meta or real).  Returns a tree of placements."""
    return tree_map(lambda spec, leaf: spec_to_placements(
        spec, tuple(leaf.shape), mesh, rules), specs, params_shape,
        is_leaf=is_spec)


def batch_pspecs(batch_like, mesh, rules: Rules):
    """Batch dim 0 over the batch axes, everything else replicated;
    non-divisible batch dims (long_500k's global_batch=1) replicate."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in rules.batch_axes if a in sizes)
    nb = _mesh_axis_size(sizes, axes)
    # one axis by its name, as a PartitionSpec normalises ("data",)
    entry = axes[0] if len(axes) == 1 else axes

    def one(leaf):
        if leaf.dim() == 0 or leaf.shape[0] % max(nb, 1) != 0:
            return ()
        return (entry,) + (None,) * (leaf.dim() - 1)
    return tree_map(one, batch_like)


def batch_shardings(batch_like, mesh, rules: Rules):
    """:func:`batch_pspecs` as placements."""
    return tree_map(lambda leaf, ps: pspec_to_placements(ps, mesh),
                    batch_like, batch_pspecs(batch_like, mesh, rules))


def cache_pspecs(cache_like, mesh, rules: Rules,
                 batch_size: Optional[int] = None):
    """KV/recurrent caches: the batch dim over the batch axes, the last
    dim over 'model' when it divides and is at least 8 a rank.

    ``batch_size`` says WHICH dim is the batch: the first dim of that
    size that divides the batch axes (super-block stacked caches are
    (n_sb, SB, B, ...)); without it, or when none matches, dim 1."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in rules.batch_axes if a in sizes)
    nb = _mesh_axis_size(sizes, axes)

    def one(leaf):
        if leaf.dim() <= 1:
            return ()
        spec = [None] * leaf.dim()
        bdim = None
        if batch_size is not None:
            for d in range(leaf.dim() - 1):
                if leaf.shape[d] == batch_size and \
                        batch_size % max(nb, 1) == 0:
                    bdim = d
                    break
        if bdim is None:
            bdim = 1
            if leaf.shape[bdim] % max(nb, 1) != 0:
                bdim = None
        if bdim is not None and axes:
            spec[bdim] = axes if len(axes) > 1 else axes[0]
        m = sizes.get("model", 1)
        if leaf.dim() >= 3 and leaf.shape[-1] % m == 0 and \
                leaf.shape[-1] >= m * 8:
            spec[-1] = "model"
        return tuple(spec)
    return tree_map(one, cache_like)


def cache_shardings(cache_like, mesh, rules: Rules,
                    batch_size: Optional[int] = None):
    """:func:`cache_pspecs` as placements."""
    return tree_map(lambda leaf, ps: pspec_to_placements(ps, mesh),
                    cache_like, cache_pspecs(cache_like, mesh, rules,
                                             batch_size))


# ----------------------------------------------------------------------
# planner-predicted collective volumes (Eqns 1-2 at mesh granularity)
# ----------------------------------------------------------------------
def predict_collectives(cfg, params_specs, params_shape, mesh, rules: Rules,
                        shape_cell) -> Dict[str, float]:
    """Per-step communication classes and volumes from the HDArray
    planner at mesh-axis granularity, {kind: bytes}:

      * FSDP param all-gather: params sharded over 'data' are USEd with
        ('*',) by every data shard -> ALL_GATHER (Eqn 1 with LUSE=full),
      * gradient reduce-scatter: every shard DEFs a partial of the full
        grad -> reduction (the dual of the all-gather),
      * the cross-pod gradient all-reduce (params replicated over 'pod'),
      * MoE token all-to-all over 'model' when experts are sharded.

    Parameter bytes count 4 an element, as the reference's."""
    import numpy as np

    from repro_torch.core import AccessSpec, HDArrayRuntime

    sizes = axis_sizes(mesh)
    d_axis = sizes.get("data", 1)
    m_axis = sizes.get("model", 1)
    p_axis = sizes.get("pod", 1)
    out = {"fsdp_allgather": 0.0, "grad_reduce": 0.0, "moe_alltoall": 0.0,
           "tp_collectives": 0.0, "pod_allreduce": 0.0}

    leaves = tree_leaves(params_shape)
    specs = tree_leaves(params_specs, is_leaf=is_spec)
    fsdp_bytes = 0
    for spec, leaf in zip(specs, leaves):
        nbytes = math.prod(leaf.shape) * 4
        flat = []
        for e in spec_to_pspec(spec, tuple(leaf.shape), mesh, rules):
            if e is not None:
                flat.extend(e if isinstance(e, tuple) else (e,))
        if "data" in flat or "pod" in flat:
            fsdp_bytes += nbytes

    # FSDP all-gather via the planner: a ROW-partitioned param space
    # used by all -> ALL_GATHER; each shard receives the others' rows
    if fsdp_bytes and d_axis > 1:
        rt = HDArrayRuntime(d_axis, backend="null")
        n = d_axis * 128
        h = rt.create("w", (n, max(1, fsdp_bytes // (4 * n))), np.float32)
        part = rt.partition_row((n, h.shape[1]))
        per = tuple(rt._clip_region_to_array(r, h)
                    for r in rt.parts[part].regions)
        h.record_write(per)
        plan = rt.plan_only("fsdp_gather", part, [h],
                            uses={"w": AccessSpec.of(("*", "*"))}, defs={})
        out["fsdp_allgather"] = float(plan.bytes_total)
        # grads: the reverse direction, the same volume (reduce-scatter)
        out["grad_reduce"] = float(plan.bytes_total)

    if p_axis > 1:
        total = sum(math.prod(leaf.shape) * 4 for leaf in leaves)
        # ring all-reduce moves 2 (p-1)/p bytes per participant
        out["pod_allreduce"] = 2 * (p_axis - 1) / p_axis * total * p_axis

    if cfg.moe is not None and m_axis > 1:
        tokens = shape_cell.global_batch * shape_cell.seq_len
        tok_bytes = tokens * cfg.d_model * 2  # bf16 activations
        # each token goes to top_k experts, (m-1)/m of them remote, and back
        out["moe_alltoall"] = (cfg.moe.top_k * tok_bytes
                               * (m_axis - 1) / m_axis * 2)
    return out
