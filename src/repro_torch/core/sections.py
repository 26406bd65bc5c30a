"""N-dimensional array-section algebra for the HDArray runtime.

The paper (HDArray, §2.1) summarizes GDEF/LDEF/LUSE as sets of array
sections ``[LB:UB]``.  We represent a *section* as an N-d box with
half-open per-dimension intervals ``[lo, hi)`` and a *section set* as a
canonicalized list of pairwise-disjoint boxes kept in sorted order —
the sorted order is what enables the paper's linear-time GDEF
comparison (§4.2).

Storage is structure-of-arrays: every :class:`SectionSet` owns one
``(n, ndim, 2)`` int64 bounds matrix, and union/intersect/subtract/
canonicalize run as batched NumPy kernels over that matrix instead of
per-box Python loops.  The canonical form (unique slab decomposition,
lexicographically sorted) is unchanged from the scalar implementation,
so equality is a single ``np.array_equal`` — still the paper's
'sorted GDEFs allow simple and linear-time GDEF comparisons'.

This metadata layer runs at plan time on the host (the paper's
host-side runtime), never on device.  It is a copy of the reference
package's module: the port keeps its own so that it never imports the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

Interval = Tuple[int, int]  # half-open [lo, hi)

_I64 = np.int64


@dataclass(frozen=True, order=True)
class Box:
    """An N-d rectangular array section with half-open bounds."""

    bounds: Tuple[Interval, ...]

    # -- construction ------------------------------------------------
    @staticmethod
    def make(*bounds: Interval) -> "Box":
        return Box(tuple((int(lo), int(hi)) for lo, hi in bounds))

    @staticmethod
    def full(shape: Sequence[int]) -> "Box":
        return Box(tuple((0, int(s)) for s in shape))

    # -- queries -----------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.bounds)

    def is_empty(self) -> bool:
        return any(hi <= lo for lo, hi in self.bounds)

    def volume(self) -> int:
        v = 1
        for lo, hi in self.bounds:
            v *= max(0, hi - lo)
        return v

    def shape(self) -> Tuple[int, ...]:
        return tuple(max(0, hi - lo) for lo, hi in self.bounds)

    def contains(self, other: "Box") -> bool:
        return all(
            slo <= olo and ohi <= shi
            for (slo, shi), (olo, ohi) in zip(self.bounds, other.bounds)
        )

    def intersect(self, other: "Box") -> "Box":
        assert self.ndim == other.ndim, (self, other)
        return Box(
            tuple(
                (max(alo, blo), min(ahi, bhi))
                for (alo, ahi), (blo, bhi) in zip(self.bounds, other.bounds)
            )
        )

    def overlaps(self, other: "Box") -> bool:
        return not self.intersect(other).is_empty()

    def subtract(self, other: "Box") -> Tuple["Box", ...]:
        """``self − other`` as ≤ 2·ndim disjoint boxes (standard slab split)."""
        inter = self.intersect(other)
        if inter.is_empty():
            return (self,)
        out = []
        lo_rest = list(self.bounds)
        for d in range(self.ndim):
            (slo, shi), (ilo, ihi) = lo_rest[d], inter.bounds[d]
            if slo < ilo:  # slab below the intersection in dim d
                b = list(lo_rest)
                b[d] = (slo, ilo)
                out.append(Box(tuple(b)))
            if ihi < shi:  # slab above
                b = list(lo_rest)
                b[d] = (ihi, shi)
                out.append(Box(tuple(b)))
            lo_rest[d] = (ilo, ihi)  # clamp and move to next dim
        return tuple(b for b in out if not b.is_empty())

    def translate(self, offset: Sequence[int]) -> "Box":
        assert len(offset) == self.ndim
        return Box(tuple((lo + o, hi + o) for (lo, hi), o in zip(self.bounds, offset)))

    def clamp(self, shape: Sequence[int]) -> "Box":
        """Clip to the array domain [0, shape)."""
        return self.intersect(Box.full(shape))

    def to_slices(self) -> Tuple[slice, ...]:
        return tuple(slice(lo, hi) for lo, hi in self.bounds)

    def __repr__(self) -> str:  # compact: [0:4,8:16)
        ins = ",".join(f"{lo}:{hi}" for lo, hi in self.bounds)
        return f"[{ins})"


# ----------------------------------------------------------------------
# Vectorized bounds-matrix kernels.  A bounds matrix is an (n, ndim, 2)
# int64 array of half-open per-dimension intervals; "canonical" means
# the unique disjoint slab decomposition in lexicographic box order.
# ----------------------------------------------------------------------
def _bounds_matrix(boxes: Sequence[Box], ndim: Optional[int] = None) -> np.ndarray:
    if not boxes:
        return np.empty((0, 0 if ndim is None else ndim, 2), _I64)
    return np.asarray([b.bounds for b in boxes], _I64)


def _boxes_of(arr: np.ndarray) -> Tuple[Box, ...]:
    return tuple(
        Box(tuple((int(lo), int(hi)) for lo, hi in row)) for row in arr
    )


# Small-set scalar kernels.  NumPy ufunc overhead (~50-150µs/op) dwarfs
# the work for the 1-4 box sets that dominate GDEF traffic, so below
# _SMALL rows the batched kernels dispatch to tuple-based ports of the
# same algorithms (~5-20µs/op); the vectorized paths take over for the
# large sets (mask oracles, trapezoids, merged plans) where they win.
_SMALL = 32

_Row = Tuple[Interval, ...]


def _py_merge_1d(ivs) -> list:
    ivs = sorted(iv for iv in ivs if iv[1] > iv[0])
    out: list = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _py_canon(rows) -> list:
    """Tuple-row port of the canonical slab decomposition."""
    rows = [r for r in rows if all(hi > lo for lo, hi in r)]
    if not rows:
        return []
    nd = len(rows[0])
    if nd == 1:
        return [(iv,) for iv in _py_merge_1d([r[0] for r in rows])]
    cuts = sorted({c for r in rows for c in r[0]})
    slabs: list = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rest = [r[1:] for r in rows if r[0][0] <= lo and hi <= r[0][1]]
        if not rest:
            continue
        crest = _py_canon(rest)
        if not crest:
            continue
        if slabs and slabs[-1][0][1] == lo and slabs[-1][1] == crest:
            slabs[-1] = ((slabs[-1][0][0], hi), crest)
        else:
            slabs.append(((lo, hi), crest))
    out: list = []
    for iv, crest in slabs:
        for r in crest:
            out.append((iv,) + tuple(r))
    return out


def _py_box_subtract(row: _Row, other: _Row):
    """row − other as ≤ 2·ndim disjoint rows (slab split)."""
    inter = tuple((max(alo, blo), min(ahi, bhi))
                  for (alo, ahi), (blo, bhi) in zip(row, other))
    if any(hi <= lo for lo, hi in inter):
        return None  # disjoint: unchanged
    out = []
    cur = list(row)
    for d in range(len(row)):
        (slo, shi), (ilo, ihi) = cur[d], inter[d]
        if slo < ilo:
            piece = list(cur)
            piece[d] = (slo, ilo)
            out.append(tuple(piece))
        if ihi < shi:
            piece = list(cur)
            piece[d] = (ihi, shi)
            out.append(tuple(piece))
        cur[d] = inter[d]
    return out


def _py_subtract(rows_a, rows_b):
    """rows_a − rows_b (non-canonical pieces); returns (pieces, changed)."""
    rem = list(rows_a)
    changed = False
    for b in rows_b:
        if not rem:
            break
        nxt = []
        for r in rem:
            pieces = _py_box_subtract(r, b)
            if pieces is None:
                nxt.append(r)
            else:
                changed = True
                nxt.extend(pieces)
        rem = nxt
    return rem, changed


def _rows_to_arr(rows, nd: int) -> np.ndarray:
    if not rows:
        return np.empty((0, nd, 2), _I64)
    return np.array(rows, _I64)


def _merge_1d_arr(iv: np.ndarray) -> np.ndarray:
    """Sweep-line merge of nonempty 1-D intervals: (n, 2) → (m, 2) sorted."""
    order = np.argsort(iv[:, 0], kind="stable")
    iv = iv[order]
    hi_cum = np.maximum.accumulate(iv[:, 1])
    starts = np.empty(len(iv), bool)
    starts[0] = True
    starts[1:] = iv[1:, 0] > hi_cum[:-1]   # strict gap ⇒ new merged run
    idx = np.flatnonzero(starts)
    return np.stack((iv[idx, 0], np.maximum.reduceat(iv[:, 1], idx)), axis=1)


def _canon_arr(arr: np.ndarray) -> np.ndarray:
    """Unique canonical disjoint decomposition of a union of boxes.

    Recursive slab decomposition: split along dim 0 at every box
    boundary, canonicalize the (ndim-1)-d remainder of each slab, then
    re-merge adjacent slabs with identical remainders.  Emission order
    (slabs by increasing interval, remainders sorted recursively) IS
    lexicographic box order, so no final sort is needed.
    """
    if arr.shape[0]:
        keep = (arr[:, :, 1] > arr[:, :, 0]).all(axis=1)
        if not keep.all():
            arr = arr[keep]
    n, nd = arr.shape[0], arr.shape[1]
    if n <= 1:
        return arr  # a single nonempty box is already canonical
    if n <= _SMALL:  # scalar kernel beats ufunc overhead on tiny sets
        rows = [tuple((int(lo), int(hi)) for lo, hi in row)
                for row in arr.tolist()]
        return _rows_to_arr(_py_canon(rows), nd)
    if nd == 1:
        return _merge_1d_arr(arr[:, 0, :]).reshape(-1, 1, 2)
    cuts = np.unique(arr[:, 0, :])
    los, his = arr[:, 0, 0], arr[:, 0, 1]
    slabs: list = []  # [lo, hi, canonical-rest matrix]
    for i in range(len(cuts) - 1):
        lo, hi = cuts[i], cuts[i + 1]
        mask = (los <= lo) & (his >= hi)
        if not mask.any():
            continue
        crest = _canon_arr(arr[mask][:, 1:, :])
        if crest.shape[0] == 0:
            continue
        if (slabs and slabs[-1][1] == lo and slabs[-1][2].shape == crest.shape
                and (slabs[-1][2] == crest).all()):
            slabs[-1][1] = hi
        else:
            slabs.append([lo, hi, crest])
    if not slabs:
        return np.empty((0, nd, 2), _I64)
    parts = []
    for lo, hi, crest in slabs:
        col = np.empty((crest.shape[0], 1, 2), _I64)
        col[:, 0, 0] = lo
        col[:, 0, 1] = hi
        parts.append(np.concatenate((col, crest), axis=1))
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def _intersect_arrs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All-pairs box intersection of two bounds matrices (batched)."""
    lo = np.maximum(a[:, None, :, 0], b[None, :, :, 0])
    hi = np.minimum(a[:, None, :, 1], b[None, :, :, 1])
    keep = (hi > lo).all(axis=2)
    out = np.stack((lo, hi), axis=-1)  # (n, m, nd, 2)
    return out[keep]


def _subtract_one(rem: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Subtract ONE box from every row of `rem` (vectorized slab split)."""
    ilo = np.maximum(rem[:, :, 0], box[:, 0])
    ihi = np.minimum(rem[:, :, 1], box[:, 1])
    hit = (ihi > ilo).all(axis=1)
    if not hit.any():
        return rem
    pieces = [rem[~hit]]
    r, il, ih = rem[hit], ilo[hit], ihi[hit]
    cur = r.copy()  # dims < d clamped to the intersection, dims ≥ d original
    nd = rem.shape[1]
    for d in range(nd):
        below = r[:, d, 0] < il[:, d]
        if below.any():
            p = cur[below].copy()
            p[:, d, 0] = r[below, d, 0]
            p[:, d, 1] = il[below, d]
            pieces.append(p)
        above = ih[:, d] < r[:, d, 1]
        if above.any():
            p = cur[above].copy()
            p[:, d, 0] = ih[above, d]
            p[:, d, 1] = r[above, d, 1]
            pieces.append(p)
        cur[:, d, 0] = il[:, d]
        cur[:, d, 1] = ih[:, d]
    return np.concatenate(pieces, axis=0)


def _subtract_arrs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    rem = a
    for j in range(b.shape[0]):
        rem = _subtract_one(rem, b[j])
        if rem.shape[0] == 0:
            break
    return rem


def canonicalize(boxes: Sequence[Box]) -> Tuple[Box, ...]:
    """Unique canonical disjoint decomposition of a union of boxes."""
    return _boxes_of(_canon_arr(_bounds_matrix(list(boxes))))


class SectionSet:
    """A canonical set of pairwise-disjoint boxes, sorted (paper §4.2),
    backed by one ``(n, ndim, 2)`` int64 bounds matrix."""

    __slots__ = ("_b", "_boxes", "_t", "_bbox", "_hash")

    def __init__(self, boxes: Sequence[Box] = ()):
        # Same contract as the scalar implementation: the constructor
        # trusts `boxes` to already be canonical (use `of` otherwise).
        bt = tuple(boxes)
        self._b = _bounds_matrix(bt)
        self._boxes: Optional[Tuple[Box, ...]] = bt
        self._t = [b.bounds for b in bt]
        self._bbox = None
        self._hash = None

    @classmethod
    def _wrap(cls, arr: np.ndarray, rows=None) -> "SectionSet":
        s = cls.__new__(cls)
        s._b = arr
        s._boxes = None
        s._t = rows
        s._bbox = None
        s._hash = None
        return s

    def _rows(self) -> list:
        """Cached tuple-row view for the scalar small-set kernels."""
        if self._t is None:
            self._t = [tuple((int(lo), int(hi)) for lo, hi in row)
                       for row in self._b.tolist()]
        return self._t

    # -- construction ------------------------------------------------
    @staticmethod
    def empty(ndim: int) -> "SectionSet":
        try:
            return _EMPTIES[ndim]
        except KeyError:
            s = SectionSet._wrap(np.empty((0, ndim, 2), _I64))
            _EMPTIES[ndim] = s
            return s

    @staticmethod
    def of(*boxes: Box) -> "SectionSet":
        return SectionSet._wrap(_canon_arr(_bounds_matrix(list(boxes))))

    @staticmethod
    def full(shape: Sequence[int]) -> "SectionSet":
        return SectionSet.of(Box.full(shape))

    @staticmethod
    def from_bounds(arr) -> "SectionSet":
        """Build (and canonicalize) from an ``(n, ndim, 2)`` array."""
        return SectionSet._wrap(_canon_arr(np.asarray(arr, _I64)))

    # -- SoA views ---------------------------------------------------
    @property
    def bounds_array(self) -> np.ndarray:
        """The (n, ndim, 2) bounds matrix — do not mutate."""
        return self._b

    @property
    def boxes(self) -> Tuple[Box, ...]:
        if self._boxes is None:
            self._boxes = _boxes_of(self._b)
        return self._boxes

    @property
    def ndim(self) -> int:
        return self._b.shape[1]

    def bbox_bounds(self):
        """Conservative bounding box as ((ndim,) lo, (ndim,) hi) int64
        arrays, or None when empty — the planner's neighbor-index key."""
        if self._b.shape[0] == 0:
            return None
        if self._bbox is None:
            self._bbox = (self._b[:, :, 0].min(axis=0),
                          self._b[:, :, 1].max(axis=0))
        return self._bbox

    # -- queries -----------------------------------------------------
    def is_empty(self) -> bool:
        return self._b.shape[0] == 0

    def __len__(self) -> int:
        return self._b.shape[0]

    def volume(self) -> int:
        if self._b.shape[0] == 0:
            return 0
        return int((self._b[:, :, 1] - self._b[:, :, 0]).prod(axis=1).sum())

    def nbytes(self, itemsize: int) -> int:
        return self.volume() * itemsize

    def contains_box(self, box: Box) -> bool:
        return SectionSet.of(box).subtract(self).is_empty()

    # -- algebra -----------------------------------------------------
    def _covers(self, other: "SectionSet") -> bool:
        """Sufficient (not necessary) superset test: every box of
        `other` lies inside a SINGLE box of self.  One vectorized
        expression — the steady-state fast path that lets union/commit
        skip canonicalization entirely."""
        a, b = self._b, other._b
        ok = ((a[None, :, :, 0] <= b[:, None, :, 0]).all(axis=2)
              & (a[None, :, :, 1] >= b[:, None, :, 1]).all(axis=2))
        return bool(ok.any(axis=1).all())

    def union(self, other: "SectionSet") -> "SectionSet":
        if self.is_empty():
            return other
        if other.is_empty() or other is self:
            return self
        n, m = len(self), len(other)
        if n + m <= _SMALL:
            # value-stable subset fast paths: a union that adds nothing
            # returns the SAME object, preserving §4.2 snapshot
            # identity compares and the canonical GDEF factorization
            rem, _ = _py_subtract(other._rows(), self._rows())
            if not rem:
                return self
            back, _ = _py_subtract(self._rows(), other._rows())
            if not back:
                return other
            rows = _py_canon(self._rows() + rem)
            return SectionSet._wrap(_rows_to_arr(rows, self.ndim), rows)
        if self._covers(other):
            return self
        if other._covers(self):
            return other
        return SectionSet._wrap(
            _canon_arr(np.concatenate((self._b, other._b), axis=0)))

    def intersect(self, other: "SectionSet") -> "SectionSet":
        if self.is_empty() or other.is_empty() or not self._bbox_overlaps(other):
            return SectionSet.empty(self.ndim if not self.is_empty()
                                    else other.ndim)
        n, m = len(self), len(other)
        if n * m <= _SMALL:
            rows = []
            for a in self._rows():
                for b in other._rows():
                    inter = tuple((max(alo, blo), min(ahi, bhi))
                                  for (alo, ahi), (blo, bhi) in zip(a, b))
                    if all(hi > lo for lo, hi in inter):
                        rows.append(inter)
            rows = _py_canon(rows)
            return SectionSet._wrap(_rows_to_arr(rows, self.ndim), rows)
        return SectionSet._wrap(_canon_arr(_intersect_arrs(self._b, other._b)))

    def subtract(self, other: "SectionSet") -> "SectionSet":
        # no-op fast paths return `self` UNCHANGED — identity
        # preservation is what keeps the §4.2 snapshot compare O(1) in
        # the steady state.
        if self.is_empty() or other.is_empty() or not self._bbox_overlaps(other):
            return self
        n, m = len(self), len(other)
        if n <= _SMALL and m <= _SMALL:
            rem, changed = _py_subtract(self._rows(), other._rows())
            if not changed:
                return self
            rows = _py_canon(rem)
            return SectionSet._wrap(_rows_to_arr(rows, self.ndim), rows)
        # exact no-op test (one vectorized expression): if no box pair
        # actually overlaps, the subtraction cannot change anything
        lo = np.maximum(self._b[:, None, :, 0], other._b[None, :, :, 0])
        hi = np.minimum(self._b[:, None, :, 1], other._b[None, :, :, 1])
        if not (hi > lo).all(axis=2).any():
            return self
        rem = _subtract_arrs(self._b, other._b)
        if rem is self._b:
            return self
        return SectionSet._wrap(_canon_arr(rem))

    def translate(self, offset: Sequence[int]) -> "SectionSet":
        if self.is_empty():
            return self
        off = np.asarray(offset, _I64)
        assert off.shape[0] == self.ndim
        return SectionSet._wrap(self._b + off[None, :, None])

    def clamp(self, shape: Sequence[int]) -> "SectionSet":
        if self.is_empty():
            return self
        shp = np.asarray(shape, _I64)
        clipped = np.clip(self._b, 0, shp[None, :, None])
        return SectionSet._wrap(_canon_arr(clipped))

    def _bbox_overlaps(self, other: "SectionSet") -> bool:
        a, b = self.bbox_bounds(), other.bbox_bounds()
        return bool((a[0] < b[1]).all() and (b[0] < a[1]).all())

    # Sorted-order equality is O(n): the canonical form makes == a
    # single np.array_equal — the paper's §4.2 "simple and linear-time
    # GDEF comparison".
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SectionSet):
            return NotImplemented
        a, b = self._b, other._b
        if a.shape[0] == 0 or b.shape[0] == 0:
            return a.shape[0] == b.shape[0]  # empties match regardless of ndim
        return a.shape == b.shape and bool((a == b).all())

    def __hash__(self) -> int:
        if self._hash is None:
            if self._b.shape[0] == 0:
                self._hash = hash(())
            else:
                self._hash = hash((self._b.shape[1], self._b.tobytes()))
        return self._hash

    def __iter__(self) -> Iterator[Box]:
        return iter(self.boxes)

    def iter_slices(self) -> Iterator[Tuple[slice, ...]]:
        """Yield each box as a tuple of slices without building Box
        objects — the executors' message-iteration fast path."""
        for row in self._b:
            yield tuple(slice(int(lo), int(hi)) for lo, hi in row)

    def __repr__(self) -> str:
        return "{" + ", ".join(map(repr, self.boxes)) + "}"


_EMPTIES: Dict[int, SectionSet] = {}


def section_set_from_mask(mask) -> SectionSet:
    """Oracle helper (tests): build a SectionSet from a dense boolean
    mask by run-length encoding each row, then one canonicalize."""
    mask = np.asarray(mask, dtype=bool)
    assert mask.ndim >= 1, "mask must be at least 1-d"
    nd = mask.ndim
    flat = mask.reshape(-1, mask.shape[-1])
    pad = np.zeros((flat.shape[0], 1), bool)
    edges = np.diff(np.concatenate((pad, flat, pad), axis=1).astype(np.int8),
                    axis=1)
    row_s, col_s = np.nonzero(edges == 1)
    _row_e, col_e = np.nonzero(edges == -1)
    out = np.empty((len(row_s), nd, 2), _I64)
    if nd > 1:
        lead = np.unravel_index(row_s, mask.shape[:-1])
        for d, idx in enumerate(lead):
            out[:, d, 0] = idx
            out[:, d, 1] = idx + 1
    out[:, -1, 0] = col_s
    out[:, -1, 1] = col_e
    return SectionSet._wrap(_canon_arr(out))


def mask_from_section_set(s: SectionSet, shape) -> "np.ndarray":  # noqa: F821
    m = np.zeros(shape, dtype=bool)
    for sl in s.iter_slices():
        m[sl] = True
    return m
