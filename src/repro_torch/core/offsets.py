"""use/def access clauses (paper §3, Table 1).

Offset clauses describe, per array, the elements a *work item* reads or
writes relative to its own index:

    ``use(a, (0, '*'))``     — row `i` of `a`            (GEMM A)
    ``use(b, ('*', 0))``     — column `j` of `b`         (GEMM B)
    ``use(b, (0,-1),(0,1),(-1,0),(1,0))`` — 4-pt stencil (Jacobi)
    ``def(c, (0, 0))``       — the work item's own element

Composed with a work REGION (a Box of work items owned by one device),
an offset clause yields the array SECTIONS that device accesses — the
LUSE / LDEF sets of paper §2.1.  ``'*'`` spans the full array extent in
that dimension.  `work_dims` maps array dims onto work-domain dims when
the array rank differs from the work rank (e.g. the mean vector in
Covariance: array dim 0 follows work dim 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from .sections import Box, SectionSet

OffsetEntry = Union[int, str]          # int offset or '*'
OffsetTuple = Tuple[OffsetEntry, ...]  # one per array dim


@dataclass(frozen=True)
class AccessSpec:
    """A use or def clause: union of offset tuples, optionally with an
    explicit work-dim mapping per array dim."""

    offsets: Tuple[OffsetTuple, ...]
    work_dims: Optional[Tuple[int, ...]] = None

    @staticmethod
    def of(*offsets: OffsetTuple, work_dims: Optional[Tuple[int, ...]] = None
           ) -> "AccessSpec":
        return AccessSpec(tuple(tuple(o) for o in offsets), work_dims)

    def sections(self, work_region: Box, array_shape: Sequence[int]) -> SectionSet:
        """LUSE/LDEF for one device: compose offsets with its work region."""
        array_shape = tuple(int(s) for s in array_shape)
        nd = len(array_shape)
        if work_region.is_empty():
            return SectionSet.empty(nd)
        boxes = []
        for off in self.offsets:
            assert len(off) == nd, (off, array_shape)
            bounds = []
            for d in range(nd):
                o = off[d]
                if o == "*":
                    bounds.append((0, array_shape[d]))
                else:
                    wd = self.work_dims[d] if self.work_dims is not None else d
                    lo, hi = work_region.bounds[wd]
                    bounds.append((lo + int(o), hi + int(o)))
            box = Box(tuple(bounds)).clamp(array_shape)
            if not box.is_empty():
                boxes.append(box)
        # one batched canonicalize instead of a union per offset tuple
        return SectionSet.of(*boxes) if boxes else SectionSet.empty(nd)


# Common clauses ------------------------------------------------------
IDENTITY_1D = AccessSpec.of((0,))
IDENTITY_2D = AccessSpec.of((0, 0))
ROW_ALL = AccessSpec.of((0, "*"))       # GEMM A: my row, all columns
COL_ALL = AccessSpec.of(("*", 0))       # GEMM B: all rows, my column
ALL_2D = AccessSpec.of(("*", "*"))      # fully replicated use


def stencil(ndim: int, radius: int = 1, diagonal: bool = False) -> AccessSpec:
    """N-point stencil clause: +-radius neighbors along each axis
    (Jacobi) or the full (2r+1)^ndim neighborhood (Convolution)."""
    if diagonal:
        import itertools
        offs = [t for t in itertools.product(range(-radius, radius + 1), repeat=ndim)]
        return AccessSpec.of(*offs)
    offs = [tuple(0 for _ in range(ndim))]
    for d in range(ndim):
        for r in range(1, radius + 1):
            for sgn in (-1, 1):
                o = [0] * ndim
                o[d] = sgn * r
                offs.append(tuple(o))
    return AccessSpec.of(*offs)


@dataclass(frozen=True)
class AbsoluteSpec:
    """Paper's absolute-section interface (`use@` / `def@`,
    HDArraySetAbsoluteUse/Def): per-device explicit SectionSets, for
    access patterns not expressible as work-relative offsets
    (triangular Covariance/Correlation accesses)."""

    per_device: Tuple[SectionSet, ...]

    def sections_for(self, p: int) -> SectionSet:
        return self.per_device[p]


def trapezoid(nproc: int, n: int, upper: bool = True) -> Tuple[SectionSet, ...]:
    """Paper's HDArraySetTrapezoidUse/Def helper: device p gets the rows
    of the upper (or lower) triangular region of an n x n array that fall
    in its row block — each row r spans columns [r, n) (upper) or [0, r]
    (lower).  Returned as one SectionSet per device built from row-wise
    trapezoids (merged boxes)."""
    from .partition import _even_splits

    rows = _even_splits(n, nproc)
    out = []
    for (lo, hi) in rows:
        if upper:
            boxes = [Box.make((r, r + 1), (r, n)) for r in range(lo, hi)]
        else:
            boxes = [Box.make((r, r + 1), (0, r + 1)) for r in range(lo, hi)]
        # one batched canonicalize instead of a union per row
        out.append(SectionSet.of(*boxes))
    return tuple(out)


def balanced_triangular_rows(nproc: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """Manual-partition helper (paper Listing 1.1 + §5.1 Correlation):
    split rows of an upper-triangular workload so each device gets
    roughly equal WORK (sum over rows of (n - r)), not equal rows."""
    total = n * (n + 1) // 2
    per = total / nproc
    cuts, acc, lo = [], 0.0, 0
    for r in range(n):
        acc += n - r
        if acc >= per * (len(cuts) + 1) and len(cuts) < nproc - 1:
            cuts.append(r + 1)
    bounds = [0] + cuts + [n]
    return tuple((bounds[i], bounds[i + 1]) for i in range(nproc))
