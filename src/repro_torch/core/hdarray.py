"""The HDArray handle: global array metadata + coherence state (paper §2.1).

Each HDArray tracks, for every ordered process pair (p, q):

  ``sGDEF[p][q]`` — sections p has WRITTEN but NOT yet SENT to q
                    (p holds the coherent copy q may later need).

In the paper every process replicates both sGDEF and rGDEF for all
peers (SPMD).  Under a single controller the two matrices are mirror
images — ``rGDEF[p][q] == sGDEF[q][p]`` (what p has not received from q
is exactly what q has written and not sent to p) — so we store one
matrix and expose the other as a view.  The update equations (3) and
(4) collapse to a single update of the stored matrix; the planner
applies them verbatim.

The stored matrix is a :class:`repro_torch.core.gdef.SparseGDEF`: row-
factored (one default set per row + per-column exceptions) with a
conservative bounding-box index, so the dense-looking updates below
cost O(live entries), not O(P²) — the scaling fix for the paper's
host-side overhead at large P.  ``sgdef[p][q]`` indexing is unchanged.

``valid[p]`` tracks which sections device p currently holds an
up-to-date copy of (for HDArrayRead and reductions).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .gdef import SparseGDEF, TrackedSections
from .sections import Box, SectionSet


class HDArray:
    def __init__(self, name: str, shape: Tuple[int, ...], dtype, nproc: int):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.nproc = nproc
        nd = len(self.shape)
        empty = SectionSet.empty(nd)
        # sgdef[p][q]: written by p, not yet sent to q   (q != p)
        self.sgdef = SparseGDEF(nproc, nd)
        # valid[p]: sections p holds an up-to-date copy of
        self.valid = TrackedSections([empty] * nproc, nd)
        # event log for the planner's history buffers (paper §4.2):
        # one content-hash per write/commit that touched this array
        self.events: list = []

    # -- views ---------------------------------------------------------
    def rgdef(self, p: int, q: int) -> SectionSet:
        """rGDEF[p][q] — what p has not received from q."""
        return self.sgdef[q][p]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def nbytes(self) -> int:
        n = self.itemsize
        for s in self.shape:
            n *= s
        return n

    # -- state transitions ----------------------------------------------
    def _supersede(self, p: int, w: SectionSet) -> None:
        """p's new definition of `w` invalidates every other device's
        pending/valid copies there.  Equivalent to the dense

            for q != p: sgdef[p][q] |= w ; sgdef[q][p] -= w ; valid[q] -= w

        but row-factored + bbox-pruned: O(1 + overlapping devices)."""
        g = self.sgdef
        g.union_into_row(p, w)
        lo, hi = w.bbox_bounds()
        for q in g.rows_overlapping(lo, hi):
            if q != p:
                g.subtract_at(int(q), p, w)
        for q in self.valid.overlapping(lo, hi):
            if q != p:
                self.valid.subtract_at(int(q), w)

    def record_write(self, per_device: Tuple[SectionSet, ...]) -> None:
        """HDArrayWrite: user data distributed so device p's copy of
        per_device[p] becomes the coherent one."""
        for p in range(self.nproc):
            w = per_device[p]
            if w.is_empty():
                continue
            self.valid.union_at(p, w)
            self._supersede(p, w)
        self.events.append(hash(("write", per_device)))

    def record_replicated(self) -> None:
        """A full replicated write: every device now holds the coherent
        copy of the whole array, so every pending send is superseded —
        the entire sGDEF empties (leaving entries behind would replay
        stale pre-replication sections into later plans)."""
        full = SectionSet.full(self.shape)
        for p in range(self.nproc):
            self.valid[p] = full
        self.sgdef.clear()
        self.events.append(hash(("write_replicated", self.name)))

    def apply_messages_and_defs(
        self,
        send: Dict[Tuple[int, int], SectionSet],
        ldef: Tuple[SectionSet, ...],
    ) -> None:
        """Paper Eqns (3)+(4) plus validity bookkeeping, after a kernel.

        ``send[(p, q)]`` is SENDMSG_{p,q}(k); ``ldef[p]`` is LDEF_{p,p}(k).
        """
        # (3): sGDEF[p][q] = (sGDEF[p][q] - SENDMSG[p][q]) U LDEF[p]
        # (4) is the mirrored update of the same stored matrix.
        # Messages are grouped by sender so the dense-looking per-pair
        # sweep costs O(senders + receivers + exceptions), not O(pairs).
        # A *bulk* sender ships ONE value to every peer (an all-gather
        # row; the planner's geometry memo makes those the same object):
        # its row takes the sGDEF row-level subtract, and the validity
        # update collapses to `valid[q] ∪= U` for the union U of all
        # bulk values — exact because every peer of a bulk sender
        # receives its whole value, and a bulk sender p's own value
        # already satisfies sGDEF[p][·] ⊆ valid[p] (pending sends are
        # sections the sender holds up to date).
        by_src: Dict[int, list] = {}
        for (p, q), msg in send.items():
            if not msg.is_empty():
                by_src.setdefault(p, []).append((q, msg))
        bulk_vals: Dict[int, SectionSet] = {}    # id(value) -> value
        by_dst: Dict[int, list] = {}
        for p, out in by_src.items():
            first = out[0][1]
            if (len(out) == self.nproc - 1
                    and all(m is first for _q, m in out[1:])):
                self.sgdef.subtract_into_row(p, first)
                bulk_vals[id(first)] = first
            else:
                for q, msg in out:
                    self.sgdef.subtract_at(p, q, msg)
                    by_dst.setdefault(q, []).append(msg)
        if bulk_vals:
            u = SectionSet.of(
                *(b for v in bulk_vals.values() for b in v))
            for q in range(self.nproc):
                self.valid.union_at(q, u)
        for q, inc in by_dst.items():        # q received a copy
            if len(inc) == 1:
                self.valid.union_at(q, inc[0])
            else:
                self.valid.union_at(
                    q, SectionSet.of(*(b for m in inc for b in m)))
        for p in range(self.nproc):
            d = ldef[p]
            if d.is_empty():
                continue
            self.valid.union_at(p, d)
            self._supersede(p, d)

    # -- introspection ---------------------------------------------------
    def owners_of(self, box: Box) -> list:
        """Devices currently holding an up-to-date copy of `box`."""
        return [p for p in range(self.nproc)
                if self.valid[p].intersect(SectionSet.of(box)) == SectionSet.of(box)
                or self.valid[p].contains_box(box)]

    def coherent_cover(self) -> bool:
        """True if every element has at least one up-to-date copy."""
        full = SectionSet.full(self.shape)
        u = SectionSet.empty(self.ndim)
        for p in range(self.nproc):
            u = u.union(self.valid[p])
        return u == full
