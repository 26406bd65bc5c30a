"""Symbolic collective lowering for HDArray plans.

:func:`lower_plan` classifies a CommPlan into a list of
:class:`CollectiveOp` descriptors: one op per array, named after the
collective a device mesh would issue for it (the hardware adaptation
of the paper's clEnqueue{Read,Write}BufferRect + MPI p2p/collective
pipeline).  The descriptors are metadata only.  On one card the
executor carries every kind as device-to-device section copies inside
the array's resident tensor (see
:class:`repro_torch.executors.torch_exec.TorchExecutor`), so there is
no collective helper here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .planner import ArrayCommPlan, CommKind, CommPlan
from .sections import SectionSet

__all__ = ["CollectiveOp", "lower_plan", "REDUCE_COLLECTIVES"]


# CommKind.ALL_REDUCE -> the psum-family collective a mesh would issue
REDUCE_COLLECTIVES = {"sum": "psum", "prod": "pprod",
                      "max": "pmax", "min": "pmin"}


@dataclass(frozen=True)
class CollectiveOp:
    """One lowered communication op along a named mesh axis."""
    kind: CommKind
    array: str
    axis: str                      # mesh axis name the ranks map onto
    bytes_total: int
    # HALO: (neg_width, pos_width) halo element widths along `dim`
    halo_widths: Optional[Tuple[int, int]] = None
    dim: Optional[int] = None      # array dim being exchanged / gathered
    reduce_op: Optional[str] = None  # ALL_REDUCE: sum/prod/max/min

    def describe(self) -> str:
        if self.kind == CommKind.ALL_REDUCE:
            coll = REDUCE_COLLECTIVES.get(self.reduce_op, "psum")
            return (f"{coll}[{self.axis}] combine tree op={self.reduce_op} "
                    f"({self.bytes_total} B)")
        if self.kind == CommKind.HALO:
            return (f"ppermute[{self.axis}] halo dim={self.dim} "
                    f"widths={self.halo_widths} ({self.bytes_total} B)")
        if self.kind == CommKind.ALL_GATHER:
            return f"all_gather[{self.axis}] dim={self.dim} ({self.bytes_total} B)"
        if self.kind == CommKind.ALL_TO_ALL:
            return f"all_to_all[{self.axis}] ({self.bytes_total} B)"
        if self.kind == CommKind.NONE:
            return "no-comm"
        return f"p2p[{self.axis}] ({self.bytes_total} B)"


def _halo_1d_structure(ap: ArrayCommPlan
                       ) -> Optional[Tuple[int, Tuple[int, int]]]:
    """``(dim, (backward, forward) widths)`` when the plan's messages
    form the 1-D rank-adjacent halo the single-op descriptor can
    express — every pair |src-dst| == 1 and every box thin in the same
    dim.  Geometry-aware classify() also marks block-grid, diagonal and
    wraparound exchanges as HALO; those cannot be described by one
    (dim, widths) pair and return None, falling through to the
    point-to-point descriptor."""
    dim: Optional[int] = None
    neg = pos = 0
    for (src, dst), secs in ap.messages.items():
        if abs(src - dst) != 1:
            return None
        for box in secs:
            widths = box.shape()
            # the exchanged dim is the one much smaller than the others
            d = int(np.argmin(widths)) if box.ndim > 1 else 0
            if dim is None:
                dim = d
            elif d != dim:
                return None
            w = widths[d]
            if dst == src + 1:
                pos = max(pos, w)
            else:
                neg = max(neg, w)
    if dim is None:
        return None
    return dim, (neg, pos)


def _infer_gather_dim(ap: ArrayCommPlan) -> int:
    """For ALL_GATHER, the dim along which per-src sections differ."""
    per_src: Dict[int, SectionSet] = {}
    for (src, _dst), secs in ap.messages.items():
        per_src.setdefault(src, secs)
    boxes = [next(iter(s)) for s in per_src.values() if not s.is_empty()]
    if len(boxes) < 2:
        return 0
    b0 = boxes[0]
    for d in range(b0.ndim):
        if any(b.bounds[d] != b0.bounds[d] for b in boxes[1:]):
            return d
    return 0


def lower_plan(plan: CommPlan, axis: str = "x") -> List[CollectiveOp]:
    """Classify each array's messages into one collective op."""
    out: List[CollectiveOp] = []
    for ap in plan.arrays:
        if ap.kind == CommKind.ALL_REDUCE:
            # the combine tree moves per-device partials, not sections,
            # so it is described before the empty-messages early-out
            out.append(CollectiveOp(CommKind.ALL_REDUCE, ap.array, axis,
                                    ap.bytes_total, reduce_op=ap.reduce_op))
        elif ap.kind == CommKind.NONE or not ap.messages:
            out.append(CollectiveOp(CommKind.NONE, ap.array, axis, 0))
        elif (ap.kind == CommKind.HALO
                and (halo := _halo_1d_structure(ap)) is not None):
            dim, widths = halo
            out.append(CollectiveOp(CommKind.HALO, ap.array, axis,
                                    ap.bytes_total, halo_widths=widths, dim=dim))
        elif ap.kind == CommKind.ALL_GATHER:
            out.append(CollectiveOp(CommKind.ALL_GATHER, ap.array, axis,
                                    ap.bytes_total, dim=_infer_gather_dim(ap)))
        elif ap.kind == CommKind.ALL_TO_ALL:
            out.append(CollectiveOp(CommKind.ALL_TO_ALL, ap.array, axis,
                                    ap.bytes_total))
        else:
            out.append(CollectiveOp(CommKind.P2P, ap.array, axis,
                                    ap.bytes_total))
    return out
