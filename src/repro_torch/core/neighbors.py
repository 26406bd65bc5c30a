"""Sparse neighbor enumeration for the planner (§4.2 scaling).

The planner's Eqn (1) loop only has to visit (sender p, receiver q)
pairs whose GDEF-row / LUSE bounding boxes can overlap.  This module
enumerates those pairs from two families of axis-aligned boxes without
the O(P²) all-pairs Python loop:

* **closed-form path** — when the sender intervals along some dimension
  form a *staircase* (sorted by lo with nondecreasing hi — true for
  ROW, COL and BLOCK partitions, whose regions are generated in rank
  order), the senders overlapping a query interval are one contiguous
  range of the sorted order, found with two ``searchsorted`` calls.
  Cost: O((P + k) · ndim) for all P queries together, k = live pairs.
* **dense fallback** — for irregular/manual layouts that defeat the
  staircase test, a blocked vectorized all-pairs interval test (the
  interval-tree equivalent, traded for NumPy's constant factor; blocks
  bound peak memory at ~4M pair-bits).

Both paths return the same pair set; `overlapping_pairs` picks
automatically and returns pairs sorted (sender-major) so downstream
message dicts iterate in the legacy p-then-q order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_I64 = np.int64
_DENSE_BLOCK = 4_000_000  # max pair-bits per fallback block


def _empty_pairs() -> np.ndarray:
    return np.empty((0, 2), _I64)


def _staircase_dim(lo: np.ndarray, hi: np.ndarray) -> Optional[Tuple[int, np.ndarray]]:
    """First dim whose intervals, sorted by lo, have nondecreasing hi.
    Returns (dim, argsort order) or None."""
    for d in range(lo.shape[1]):
        order = np.argsort(lo[:, d], kind="stable")
        h = hi[order, d]
        if h.shape[0] < 2 or (h[1:] >= h[:-1]).all():
            return d, order
    return None


def _pairs_staircase(a_lo, a_hi, b_lo, b_hi, dim, order) -> np.ndarray:
    """Closed-form: per query q, senders overlapping along `dim` are the
    contiguous sorted-order range [start_q, end_q)."""
    los, his = a_lo[order, dim], a_hi[order, dim]
    start = np.searchsorted(his, b_lo[:, dim], side="right")
    end = np.searchsorted(los, b_hi[:, dim], side="left")
    counts = np.maximum(end - start, 0)
    total = int(counts.sum())
    if total == 0:
        return _empty_pairs()
    q_rep = np.repeat(np.arange(len(b_lo)), counts)
    base = np.repeat(start, counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    a_rows = order[base + offs]
    # exact overlap in the remaining dims
    rest = [d for d in range(a_lo.shape[1]) if d != dim]
    if rest:
        ok = ((a_lo[a_rows][:, rest] < b_hi[q_rep][:, rest]).all(axis=1)
              & (a_hi[a_rows][:, rest] > b_lo[q_rep][:, rest]).all(axis=1))
        a_rows, q_rep = a_rows[ok], q_rep[ok]
    return np.stack((a_rows, q_rep), axis=1)


def _pairs_dense(a_lo, a_hi, b_lo, b_hi) -> np.ndarray:
    """Blocked vectorized all-pairs interval test (irregular fallback)."""
    na = len(a_lo)
    step = max(1, _DENSE_BLOCK // max(1, na))
    chunks = []
    for j0 in range(0, len(b_lo), step):
        bl, bh = b_lo[j0:j0 + step], b_hi[j0:j0 + step]
        ov = ((a_lo[:, None, :] < bh[None, :, :]).all(axis=2)
              & (a_hi[:, None, :] > bl[None, :, :]).all(axis=2))
        ii, jj = np.nonzero(ov)
        if ii.size:
            chunks.append(np.stack((ii, jj + j0), axis=1))
    return np.concatenate(chunks, axis=0) if chunks else _empty_pairs()


def overlapping_pairs(a_lo: np.ndarray, a_hi: np.ndarray, a_live: np.ndarray,
                      b_lo: np.ndarray, b_hi: np.ndarray, b_live: np.ndarray,
                      ) -> np.ndarray:
    """All (i, j) with box a_i overlapping box b_j, as a (k, 2) int64
    array sorted lexicographically.  `*_lo`/`*_hi` are (P, ndim) bounds;
    `*_live` masks out absent boxes."""
    ai = np.flatnonzero(a_live)
    bi = np.flatnonzero(b_live)
    if ai.size == 0 or bi.size == 0:
        return _empty_pairs()
    al, ah = a_lo[ai], a_hi[ai]
    bl, bh = b_lo[bi], b_hi[bi]
    sd = _staircase_dim(al, ah)
    if sd is not None:
        pairs = _pairs_staircase(al, ah, bl, bh, *sd)
    else:
        pairs = _pairs_dense(al, ah, bl, bh)
    if pairs.shape[0] == 0:
        return pairs
    pairs = np.stack((ai[pairs[:, 0]], bi[pairs[:, 1]]), axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
