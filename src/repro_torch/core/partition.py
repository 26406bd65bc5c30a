"""Work-item partitioning (paper §3, `HDArrayPartition` + manual partitions).

A :class:`Partition` assigns each process/device a rectangular *work
region* of an N-d work-item domain.  Work is decoupled from data: a
partition says who COMPUTES which output elements; the planner derives
who must RECEIVE which input elements from the kernel's use/def clauses.

Partitions can be created automatically (ROW / COL / BLOCK — paper's
``HDArrayPartition``) or manually (explicit regions — paper's
``#pragma hdarray partition``).  Automatic partitions split evenly by
default; passing per-device ``weights`` makes the split capability-
proportional (the paper's "automatic distribution" over heterogeneous
devices: a device twice as fast gets a region twice as large).  Uniform
weights reduce bit-identically to the unweighted split.  Repartitioning
at any point is just creating a new Partition and using its id in the
next apply_kernel.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from .sections import Box, SectionSet


class PartType(enum.Enum):
    ROW = "row"
    COL = "col"
    BLOCK = "block"
    MANUAL = "manual"


def _even_splits(extent: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """Split [0, extent) into `parts` contiguous chunks, remainder spread
    over the leading chunks (matches the paper's 'evenly partitions')."""
    base, rem = divmod(extent, parts)
    out, lo = [], 0
    for p in range(parts):
        hi = lo + base + (1 if p < rem else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


def _weighted_splits(extent: int,
                     weights: Sequence[float]) -> Tuple[Tuple[int, int], ...]:
    """Split [0, extent) into contiguous chunks proportional to the
    non-negative `weights` (largest-remainder apportionment; remainder
    units go to the largest fractional shares, ties to the lower rank).
    Uniform weights return exactly :func:`_even_splits` so weighted
    partitions are a pure generalization of the even ones.  A zero
    weight yields an empty chunk — that device gets no work."""
    parts = len(weights)
    w = [float(x) for x in weights]
    if parts == 0:
        raise ValueError("weights must be non-empty")
    if any(x < 0 or not math.isfinite(x) for x in w):
        raise ValueError(f"weights must be finite and >= 0: {weights}")
    total = sum(w)
    if total <= 0:
        raise ValueError(f"weights must not all be zero: {weights}")
    if len(set(w)) == 1:
        return _even_splits(extent, parts)
    ideal = [extent * x / total for x in w]
    chunk = [int(math.floor(v)) for v in ideal]
    leftover = extent - sum(chunk)
    order = sorted(range(parts), key=lambda p: (-(ideal[p] - chunk[p]), p))
    for p in order[:leftover]:
        chunk[p] += 1
    out, lo = [], 0
    for c in chunk:
        out.append((lo, lo + c))
        lo += c
    return tuple(out)


def _norm_weights(weights: Optional[Sequence[float]],
                  nproc: int) -> Optional[Tuple[float, ...]]:
    if weights is None:
        return None
    w = tuple(float(x) for x in weights)
    if len(w) != nproc:
        raise ValueError(f"got {len(w)} weights for {nproc} devices")
    return w


@dataclass(frozen=True)
class Partition:
    """A work distribution: one Box region per process.  ``weights`` is
    the per-device capability vector the regions were derived from
    (None for unweighted / manual partitions) — kept so shrink and
    rebalance paths can re-split proportionally."""

    part_id: int
    ptype: PartType
    domain: Tuple[int, ...]           # global work-item domain shape
    regions: Tuple[Box, ...]          # one per process, indexed by rank
    weights: Optional[Tuple[float, ...]] = None

    @property
    def nproc(self) -> int:
        return len(self.regions)

    def region(self, p: int) -> Box:
        return self.regions[p]

    def region_set(self, p: int) -> SectionSet:
        b = self.regions[p]
        return SectionSet.of(b) if not b.is_empty() else SectionSet.empty(len(self.domain))

    def adjacent(self, p: int, q: int, periodic: bool = True) -> bool:
        """True when p's and q's work regions touch — share a face,
        edge or corner (2-D block-grid neighbors included), optionally
        also across a domain wraparound.  The wrap shift is chosen per
        dimension (torus adjacency), so diagonally-opposite corners of
        a periodic block grid count too.  This is the geometry behind
        HALO classification: a stencil exchange only ever pairs devices
        whose regions abut, whatever the rank numbering."""
        if p == q:
            return False
        a, b = self.regions[p], self.regions[q]
        if a.is_empty() or b.is_empty():
            return False
        for d, ((alo, ahi), (blo, bhi)) in enumerate(zip(a.bounds, b.bounds)):
            if alo <= bhi and blo <= ahi:  # touch or overlap directly
                continue
            if periodic and d < len(self.domain):
                ext = self.domain[d]
                if any(alo <= bhi + s and blo + s <= ahi
                       for s in (-ext, ext)):
                    continue
            return False
        return True

    # ------------------------------------------------------------------
    @staticmethod
    def row(part_id: int, domain: Sequence[int], nproc: int,
            region: Optional[Box] = None,
            weights: Optional[Sequence[float]] = None) -> "Partition":
        return Partition._split(part_id, PartType.ROW, domain, nproc, dim=0,
                                region=region, weights=weights)

    @staticmethod
    def col(part_id: int, domain: Sequence[int], nproc: int,
            region: Optional[Box] = None,
            weights: Optional[Sequence[float]] = None) -> "Partition":
        return Partition._split(part_id, PartType.COL, domain, nproc, dim=1,
                                region=region, weights=weights)

    @staticmethod
    def block(part_id: int, domain: Sequence[int], nproc: int,
              grid: Optional[Tuple[int, int]] = None,
              region: Optional[Box] = None,
              weights: Optional[Sequence[float]] = None) -> "Partition":
        """2-D block grid over dims (0, 1); `grid` defaults to the most
        square factorization of nproc.  With per-device weights the two
        grid axes are split by the per-row / per-column weight sums
        (each grid row's height tracks the total capability of the
        devices in it), the closest separable approximation of a
        per-device proportional 2-D split."""
        domain = tuple(int(d) for d in domain)
        assert len(domain) >= 2, "BLOCK partition needs a >=2-d domain"
        if grid is None:
            g0 = int(math.sqrt(nproc))
            while nproc % g0:
                g0 -= 1
            grid = (g0, nproc // g0)
        assert grid[0] * grid[1] == nproc
        weights = _norm_weights(weights, nproc)
        base = region if region is not None else Box.full(domain)
        if weights is None:
            r0 = _even_splits(base.bounds[0][1] - base.bounds[0][0], grid[0])
            r1 = _even_splits(base.bounds[1][1] - base.bounds[1][0], grid[1])
        else:
            w0 = [sum(weights[i * grid[1] + j] for j in range(grid[1]))
                  for i in range(grid[0])]
            w1 = [sum(weights[i * grid[1] + j] for i in range(grid[0]))
                  for j in range(grid[1])]
            r0 = _weighted_splits(base.bounds[0][1] - base.bounds[0][0], w0)
            r1 = _weighted_splits(base.bounds[1][1] - base.bounds[1][0], w1)
        off0, off1 = base.bounds[0][0], base.bounds[1][0]
        regions = []
        for p in range(nproc):
            i, j = divmod(p, grid[1])
            b = list(base.bounds)
            b[0] = (off0 + r0[i][0], off0 + r0[i][1])
            b[1] = (off1 + r1[j][0], off1 + r1[j][1])
            regions.append(Box(tuple(b)))
        return Partition(part_id, PartType.BLOCK, domain, tuple(regions),
                         weights)

    @staticmethod
    def manual(part_id: int, domain: Sequence[int],
               regions: Sequence[Box],
               weights: Optional[Sequence[float]] = None) -> "Partition":
        """Paper's `#pragma hdarray partition` — explicit per-device regions
        (may be empty boxes for devices with no work).  `weights` is
        accepted as bookkeeping only (regions are taken as given)."""
        regions = tuple(regions)
        return Partition(part_id, PartType.MANUAL, tuple(int(d) for d in domain),
                         regions, _norm_weights(weights, len(regions)))

    @staticmethod
    def _split(part_id: int, ptype: PartType, domain: Sequence[int], nproc: int,
               dim: int, region: Optional[Box],
               weights: Optional[Sequence[float]] = None) -> "Partition":
        domain = tuple(int(d) for d in domain)
        weights = _norm_weights(weights, nproc)
        base = region if region is not None else Box.full(domain)
        lo0, hi0 = base.bounds[dim]
        if weights is None:
            splits = _even_splits(hi0 - lo0, nproc)
        else:
            splits = _weighted_splits(hi0 - lo0, weights)
        regions = []
        for p in range(nproc):
            b = list(base.bounds)
            b[dim] = (lo0 + splits[p][0], lo0 + splits[p][1])
            regions.append(Box(tuple(b)))
        return Partition(part_id, ptype, domain, tuple(regions), weights)


class PartitionTable:
    """Allocates unique partition ids (paper: 'returns a unique partition
    ID ... used throughout the program')."""

    def __init__(self) -> None:
        self._next = 0
        self._parts: dict[int, Partition] = {}

    def _register(self, p: Partition) -> int:
        self._parts[p.part_id] = p
        return p.part_id

    def new_row(self, domain, nproc, region=None, weights=None) -> int:
        pid = self._next; self._next += 1
        return self._register(Partition.row(pid, domain, nproc, region, weights))

    def new_col(self, domain, nproc, region=None, weights=None) -> int:
        pid = self._next; self._next += 1
        return self._register(Partition.col(pid, domain, nproc, region, weights))

    def new_block(self, domain, nproc, grid=None, region=None, weights=None) -> int:
        pid = self._next; self._next += 1
        return self._register(Partition.block(pid, domain, nproc, grid, region,
                                              weights))

    def new_manual(self, domain, regions, weights=None) -> int:
        pid = self._next; self._next += 1
        return self._register(Partition.manual(pid, domain, regions, weights))

    def __getitem__(self, pid: int) -> Partition:
        return self._parts[pid]
