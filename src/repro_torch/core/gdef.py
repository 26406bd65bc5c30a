"""Sparse, row-factored sGDEF storage (paper §2.1 state at scale).

The coherence matrix is semantically dense: after any write, device
p's new sections are pending for *every* peer q, so a literal P×P
matrix costs O(P²) to store and — worse — O(P²) per Eqn (3)-(4)
commit.  Two observations make it sparse in practice:

1. **Row factorization.**  Within row p, almost every column holds the
   SAME SectionSet (everything p has written), because only the few
   peers p actually messaged differ.  Row p is stored as one *default*
   set plus a dict of per-column *exceptions*, so the semantically
   dense Eqn (3) row update ``sGDEF[p][q] ∪= LDEF_p  ∀q`` is O(1 +
   #exceptions) instead of O(P).
2. **Bounding-box pruning.**  The column update ``sGDEF[q][p] −=
   LDEF_p ∀q`` and the Eqn (1) intersection are no-ops unless the
   operands' bounding boxes overlap; per-row conservative bboxes
   (they only grow) let the planner enumerate candidates with the
   :mod:`repro_torch.core.neighbors` index instead of scanning all P.

All updates are *value-stable*: when an operation does not change a
set's value, the stored object is kept, so the §4.2 snapshot compare
hits its identity fast path and the canonical factorization (an
exception equal to the row default is dropped) stays unique.

``SparseGDEF`` keeps the classic ``sgdef[p][q]`` indexing through row
views, so planner internals, tests and benchmarks read it unchanged.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .sections import SectionSet

_I64 = np.int64


class _RowView:
    """``sgdef[p]`` — index by column q like the dense list-of-lists."""

    __slots__ = ("_g", "_p")

    def __init__(self, g: "SparseGDEF", p: int):
        self._g = g
        self._p = p

    def __getitem__(self, q: int) -> SectionSet:
        return self._g.entry(self._p, q)

    def __setitem__(self, q: int, ss: SectionSet) -> None:
        self._g.set_entry(self._p, q, ss)

    def __len__(self) -> int:
        return self._g.nproc

    def __iter__(self) -> Iterator[SectionSet]:
        return (self._g.entry(self._p, q) for q in range(self._g.nproc))


class SparseGDEF:
    __slots__ = ("nproc", "ndim", "_empty", "_default", "_exc",
                 "_lo", "_hi", "_live", "_exc_churn")

    def __init__(self, nproc: int, ndim: int):
        self.nproc = nproc
        self.ndim = ndim
        self._empty = SectionSet.empty(ndim)
        self._default: List[SectionSet] = [self._empty] * nproc
        self._exc: List[Dict[int, SectionSet]] = [dict() for _ in range(nproc)]
        # conservative per-row bounding boxes (grow-only)
        self._lo = np.zeros((nproc, ndim), _I64)
        self._hi = np.zeros((nproc, ndim), _I64)
        self._live = np.zeros(nproc, bool)
        # updates to a fully-excepted row since its last election try
        self._exc_churn: List[int] = [0] * nproc

    # -- dense-compatible indexing -------------------------------------
    def __getitem__(self, p: int) -> _RowView:
        return _RowView(self, p)

    def __len__(self) -> int:
        return self.nproc

    def __iter__(self) -> Iterator[_RowView]:
        return (_RowView(self, p) for p in range(self.nproc))

    def entry(self, p: int, q: int) -> SectionSet:
        if p == q:
            return self._empty
        return self._exc[p].get(q, self._default[p])

    def set_entry(self, p: int, q: int, ss: SectionSet) -> None:
        assert p != q, "diagonal sGDEF entries are identically empty"
        if ss == self._default[p]:
            self._exc[p].pop(q, None)
        else:
            self._exc[p][q] = ss
            self._grow_row(p, ss)

    def live_items(self) -> Iterator[Tuple[int, int, SectionSet]]:
        """(p, q, entry) over structurally-present nonempty entries."""
        for p in range(self.nproc):
            d = self._default[p]
            for q in range(self.nproc):
                if q == p:
                    continue
                e = self._exc[p].get(q, d)
                if not e.is_empty():
                    yield p, q, e

    # -- bbox index ----------------------------------------------------
    def _grow_row(self, p: int, ss: SectionSet) -> None:
        bb = ss.bbox_bounds()
        if bb is None:
            return
        lo, hi = bb
        if self._live[p]:
            np.minimum(self._lo[p], lo, out=self._lo[p])
            np.maximum(self._hi[p], hi, out=self._hi[p])
        else:
            self._lo[p] = lo
            self._hi[p] = hi
            self._live[p] = True

    def row_bounds(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(lo, hi, live) conservative row bboxes for the neighbor index."""
        return self._lo, self._hi, self._live

    def rows_overlapping(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Rows whose conservative bbox overlaps [lo, hi)."""
        m = (self._live
             & (self._lo < hi[None, :]).all(axis=1)
             & (self._hi > lo[None, :]).all(axis=1))
        return np.flatnonzero(m)

    # -- bulk updates (Eqns 3-4 / HDArrayWrite) ------------------------
    def union_into_row(self, p: int, d: SectionSet) -> None:
        """``sGDEF[p][q] ∪= d`` for every q ≠ p, in O(1 + #exceptions)."""
        if d.is_empty():
            return
        base = self._default[p]
        u = base.union(d)
        new_default = base if (u is base or u == base) else u
        self._default[p] = new_default
        exc = self._exc[p]
        for q, e in list(exc.items()):
            ue = e.union(d)
            if ue == new_default:
                del exc[q]          # back in canonical factorization
            elif ue is not e and not (ue == e):
                exc[q] = ue
        self._grow_row(p, d)

    def subtract_at(self, p: int, q: int, d: SectionSet) -> None:
        """``sGDEF[p][q] −= d`` (value-stable; keeps factorization canonical)."""
        if p == q:
            return
        e = self.entry(p, q)
        if e.is_empty():
            return
        ne = e.subtract(d)
        if ne is e or ne == e:
            return
        if ne == self._default[p]:
            self._exc[p].pop(q, None)
        else:
            exc = self._exc[p]
            complete_before = len(exc) == self.nproc - 1
            exc[q] = ne
            # Majority re-election when the row BECOMES fully-excepted;
            # for rows that stay complete (values may converge to a
            # common non-default value later), retry every nproc/2
            # updates so the O(P) scan stays amortized O(1) per update.
            if len(exc) == self.nproc - 1:
                if not complete_before:
                    self._refactor_row(p)
                else:
                    self._exc_churn[p] += 1
                    if self._exc_churn[p] * 2 >= self.nproc:
                        self._refactor_row(p)

    def subtract_into_row(self, p: int, d: SectionSet) -> None:
        """``sGDEF[p][q] −= d`` for every q ≠ p, in O(1 + #exceptions).

        The Eqn (3) bulk path for a sender whose SENDMSG is the same
        set for all peers (an all-gather row): one default update
        instead of P−1 :meth:`subtract_at` calls.  The bbox index stays
        conservative (subtract only shrinks)."""
        if d.is_empty():
            return
        base = self._default[p]
        nb = base.subtract(d)
        new_default = base if (nb is base or nb == base) else nb
        self._default[p] = new_default
        exc = self._exc[p]
        for q, e in list(exc.items()):
            ne = e.subtract(d)
            if ne == new_default:
                del exc[q]          # back in canonical factorization
            elif ne is not e and not (ne == e):
                exc[q] = ne

    def _refactor_row(self, p: int) -> None:
        """Every column of row p is an exception — the default carries
        no entry anymore.  Re-elect the majority value as the default
        (e.g. after an all-gather empties the whole row) so the
        factorization stays O(#distinct values), not O(P)."""
        self._exc_churn[p] = 0
        exc = self._exc[p]
        freq: Dict[SectionSet, int] = {}
        for ss in exc.values():
            freq[ss] = freq.get(ss, 0) + 1
        best = max(freq, key=freq.get)
        if freq[best] <= 1:
            return
        self._default[p] = best
        self._exc[p] = {q: ss for q, ss in exc.items() if not (ss == best)}

    def clear(self) -> None:
        """Empty every entry in place (a full replicated write
        supersedes all pending sends: nothing remains to deliver)."""
        self._default = [self._empty] * self.nproc
        self._exc = [dict() for _ in range(self.nproc)]
        self._lo.fill(0)
        self._hi.fill(0)
        self._live.fill(False)
        self._exc_churn = [0] * self.nproc

    # -- full-state capture (planner commit replay) --------------------
    def capture(self) -> tuple:
        """Immutable capture of the complete store, bbox index included
        — the planner's fixpoint commit replay restores from this."""
        return (tuple(self._default),
                tuple(tuple(sorted(exc.items())) for exc in self._exc),
                self._lo.copy(), self._hi.copy(), self._live.copy())

    def restore(self, state: tuple) -> None:
        defaults, excs, lo, hi, live = state
        self._default = list(defaults)
        self._exc = [dict(items) for items in excs]
        self._lo = lo.copy()
        self._hi = hi.copy()
        self._live = live.copy()
        self._exc_churn = [0] * self.nproc  # heuristic counter, not state

    # -- §4.2 snapshots -------------------------------------------------
    def snapshot(self) -> tuple:
        """Immutable refs to the factored state: O(P + #exceptions)."""
        return (tuple(self._default),
                tuple(tuple(sorted(exc.items())) for exc in self._exc))

    def snapshot_equal(self, snap: tuple) -> bool:
        """Identity-first, then O(n) structural — the paper's linear
        GDEF comparison over the factored representation."""
        defaults, excs = snap
        if len(defaults) != self.nproc:
            return False
        for p in range(self.nproc):
            s, c = defaults[p], self._default[p]
            if s is not c and s != c:
                return False
            se, ce = excs[p], self._exc[p]
            if len(se) != len(ce):
                return False
            for q, ss in se:
                cc = ce.get(q)
                if cc is None or (ss is not cc and ss != cc):
                    return False
        return True


class TrackedSections(list):
    """A list of per-device SectionSets (``HDArray.valid``) with a
    conservative bbox side-index so 'which devices can this box touch'
    is one vectorized query instead of a P-long Python scan."""

    def __init__(self, items: Sequence[SectionSet], ndim: int):
        super().__init__(items)
        n = len(self)
        self._lo = np.zeros((n, ndim), _I64)
        self._hi = np.zeros((n, ndim), _I64)
        self._live = np.zeros(n, bool)
        for i, s in enumerate(self):
            self._reset_bbox(i, s)

    def _reset_bbox(self, i: int, s: SectionSet) -> None:
        bb = s.bbox_bounds()
        if bb is None:
            self._live[i] = False
        else:
            self._lo[i], self._hi[i] = bb
            self._live[i] = True

    def _grow_bbox(self, i: int, s: SectionSet) -> None:
        bb = s.bbox_bounds()
        if bb is None:
            return
        if self._live[i]:
            np.minimum(self._lo[i], bb[0], out=self._lo[i])
            np.maximum(self._hi[i], bb[1], out=self._hi[i])
        else:
            self._lo[i], self._hi[i] = bb
            self._live[i] = True

    def __setitem__(self, i, v) -> None:  # exact rebuild on direct set
        assert isinstance(i, int) and isinstance(v, SectionSet)
        list.__setitem__(self, i, v)
        self._reset_bbox(i, v)

    def union_at(self, i: int, d: SectionSet) -> None:
        cur = list.__getitem__(self, i)
        u = cur.union(d)
        if u is not cur and not (u == cur):
            list.__setitem__(self, i, u)
        self._grow_bbox(i, d)

    def subtract_at(self, i: int, d: SectionSet) -> None:
        cur = list.__getitem__(self, i)
        nv = cur.subtract(d)
        if nv is not cur and not (nv == cur):
            list.__setitem__(self, i, nv)  # bbox stays conservative

    def overlapping(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        m = (self._live
             & (self._lo < hi[None, :]).all(axis=1)
             & (self._hi > lo[None, :]).all(axis=1))
        return np.flatnonzero(m)

    def capture(self) -> tuple:
        """Immutable capture of entries + bbox index (commit replay)."""
        return (tuple(self), self._lo.copy(), self._hi.copy(),
                self._live.copy())

    def restore(self, state: tuple) -> None:
        items, lo, hi, live = state
        for i, v in enumerate(items):
            list.__setitem__(self, i, v)
        self._lo = lo.copy()
        self._hi = hi.copy()
        self._live = live.copy()
