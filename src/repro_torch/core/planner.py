"""Communication planner — paper Eqns (1)-(4) + the §4.2 overhead
optimizations (plan cache, LDEF/LUSE history buffers, linear GDEF
comparison via canonical sorted sections).

Given a kernel's use/def clauses and a work partition, the planner:

  1. derives LUSE_p / LDEF_p for every device p  (offset or absolute),
  2. computes SENDMSG/RECVMSG by intersecting GDEF with LUSE (Eqns 1-2)
     — visiting only (p, q) pairs whose GDEF-row / LUSE bounding boxes
     can overlap, via the :mod:`repro_torch.core.neighbors` index (closed-form
     for ROW/COL/BLOCK layouts, vectorized fallback otherwise),
  3. classifies the message pattern (all-gather / halo / all-to-all /
     point-to-point) so the executor can lower it to the matching copy
     schedule,
  4. commits the GDEF updates (Eqns 3-4) — O(live entries) on the
     sparse row-factored GDEF, not O(P²).

Plan-reuse machinery (paper §4.2), two steps exactly as described:

  * step 1 — history buffers: each HDArray logs an *event id* (a hash of
    (kernel, partition, LUSE-id, LDEF-id)) for every write/commit that
    touched it.  If the event trace since the last plan of this kernel
    equals the previous period's trace — and that period was once
    verified to be a GDEF fixpoint — the cached plan is reused with no
    set algebra at all.
  * step 2 — linear GDEF comparison: otherwise, compare the arrays'
    current GDEF state against the factored snapshot captured when the
    plan was computed.  SectionSets are immutable + canonically sorted,
    so the compare is identity-first then O(n) structural — the paper's
    'sorted GDEFs allow simple and linear-time GDEF comparisons'.

On a cache hit the plan's intersections are skipped but the Eqn (3)-(4)
commit still runs (the paper hides that cost by overlapping it with
communication/compute; we account it separately, mirroring Fig. 7).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .hdarray import HDArray
from .neighbors import overlapping_pairs
from .offsets import AbsoluteSpec, AccessSpec
from .partition import Partition
from .sections import SectionSet

Access = Union[AccessSpec, AbsoluteSpec]


class CommKind(enum.Enum):
    NONE = "none"
    ALL_GATHER = "all_gather"       # every device needs (nearly) every section
    HALO = "halo"                   # neighbor-only exchange (stencils)
    ALL_TO_ALL = "all_to_all"       # balanced permutation
    P2P = "p2p"                     # irregular point-to-point
    ALL_REDUCE = "all_reduce"       # global combine of per-device partials


@dataclass
class ArrayCommPlan:
    array: str
    messages: Dict[Tuple[int, int], SectionSet]  # (src, dst) -> sections
    kind: CommKind
    bytes_total: int
    luse: Tuple[SectionSet, ...]
    ldef: Tuple[SectionSet, ...]
    # ALL_REDUCE only: which combine ("sum"/"prod"/"max"/"min") the
    # global phase applies to the per-device partials.  The combine tree
    # carries no array sections, so `messages` stays empty and
    # `bytes_total` is the partial-value traffic of the tree.
    reduce_op: Optional[str] = None

    @property
    def n_messages(self) -> int:
        return sum(1 for m in self.messages.values() if not m.is_empty())


@dataclass
class CommPlan:
    kernel: str
    part_id: int
    arrays: List[ArrayCommPlan]
    cached: bool = False

    @property
    def bytes_total(self) -> int:
        return sum(a.bytes_total for a in self.arrays)

    def messages_for(self, name: str) -> Dict[Tuple[int, int], SectionSet]:
        for a in self.arrays:
            if a.array == name:
                return a.messages
        return {}

    def plan_for(self, name: str) -> Optional[ArrayCommPlan]:
        for a in self.arrays:
            if a.array == name:
                return a
        return None


@dataclass
class PlannerStats:
    """Instrumentation for the overhead study (paper Fig. 6/7)."""
    plans_computed: int = 0
    hits_history: int = 0       # §4.2 step-1 reuse
    hits_state_compare: int = 0  # §4.2 step-2 reuse
    intersect_ops: int = 0
    gdef_updates: int = 0
    state_compares: int = 0
    candidate_pairs: int = 0    # neighbor-index survivors actually visited
    pairs_pruned: int = 0       # all-pairs count minus survivors
    commit_replays: int = 0     # fixpoint commits replayed as O(P) restores
    fused_steps: int = 0        # steps an executor ran as ONE program
    # executor dispatches the LAST step cost the host: 1 for a fused
    # execute_step, 2 for the classic exchange-then-kernel path
    python_dispatches_per_step: float = 1.0
    # per-rank step-time history [(step, (t_0..t_{P-1})), ...] — newest
    # last, capped at RANK_HISTORY_CAP
    rank_step_times: List[Tuple[int, Tuple[float, ...]]] = field(
        default_factory=list)

    RANK_HISTORY_CAP = 512

    @property
    def plans_cached(self) -> int:
        return self.hits_history + self.hits_state_compare

    def note_rank_times(self, step: int, times: Sequence[float]) -> None:
        """Record one step's per-rank kernel wall times (executor
        ``last_rank_times``), keeping a bounded rolling history."""
        self.rank_step_times.append((int(step), tuple(times)))
        if len(self.rank_step_times) > self.RANK_HISTORY_CAP:
            del self.rank_step_times[:-self.RANK_HISTORY_CAP]

    def reset(self) -> None:
        self.plans_computed = self.hits_history = self.hits_state_compare = 0
        self.intersect_ops = self.gdef_updates = self.state_compares = 0
        self.candidate_pairs = self.pairs_pruned = self.commit_replays = 0
        self.fused_steps = 0
        self.python_dispatches_per_step = 1.0
        self.rank_step_times = []


def _access_id(access: Optional[Access]) -> int:
    return hash(access)


def classify(messages: Dict[Tuple[int, int], SectionSet], nproc: int,
             part: Optional[Partition] = None) -> CommKind:
    """Pattern classification so the executor can pick a copy schedule —
    the paper's 'detects and schedules point-to-point / all-gather
    communication' (§5.1).

    HALO detection is partition-geometry-aware when `part` is given:
    (p, q) count as neighbors when their work regions touch (including
    diagonal corners of a 2-D block grid) or wrap around the domain
    boundary.  Without a partition it falls back to the legacy 1-D
    rank-adjacency test."""
    # single pass over the (possibly P²-sized) message dict: count each
    # sender's fan-out — (p, q) keys are unique, so a count IS the
    # distinct-receiver count — and track per-sender value uniformity
    # with an identity-first compare (the planner's geometry memo makes
    # equal messages the same object).
    nlive = 0
    fanouts: Dict[int, int] = {}
    per_src: Dict[int, SectionSet] = {}
    uniform = True
    for (p, q), m in messages.items():
        if m.is_empty():
            continue
        nlive += 1
        fanouts[p] = fanouts.get(p, 0) + 1
        prev = per_src.get(p)
        if prev is None:
            per_src[p] = m
        elif uniform and prev is not m and prev != m:
            uniform = False
    if not nlive:
        return CommKind.NONE
    if all(v == nproc - 1 for v in fanouts.values()):
        if uniform:
            return CommKind.ALL_GATHER
        if len(fanouts) == nproc:
            return CommKind.ALL_TO_ALL
    if part is not None:
        if all(part.adjacent(p, q) for (p, q), m in messages.items()
               if not m.is_empty()):
            return CommKind.HALO
    elif all(abs(p - q) == 1 for (p, q), m in messages.items()
             if not m.is_empty()):
        return CommKind.HALO
    return CommKind.P2P


def _gdef_snapshot(a: HDArray) -> tuple:
    """Immutable refs to the array's factored sGDEF state."""
    return a.sgdef.snapshot()


def _snapshots_equal(snap: tuple, a: HDArray, stats: PlannerStats) -> bool:
    stats.state_compares += 1
    return a.sgdef.snapshot_equal(snap)


@dataclass
class _CacheEntry:
    plan: CommPlan
    snapshots: Dict[str, tuple]          # array name -> GDEF matrix refs
    access_sig: tuple                    # (name, luse_id, ldef_id) per array
    event_marks: Dict[str, int]          # array name -> len(events) at plan time
    last_period: Optional[Dict[str, tuple]] = None  # trace of previous period
    fixpoint_verified: bool = False      # one step-2 hit observed => step-1 legal
    # commit memo (§4.2 fixpoint replay): the Eqn (3)-(4) transition is a
    # pure function of (pre GDEF/valid state, messages, ldef); once the
    # cached plan's commit has been observed from a given pre-state, a
    # matching pre-state replays the captured post-state in O(P)
    commit_pre: Optional[Dict[str, tuple]] = None
    commit_post: Optional[Dict[str, tuple]] = None


def _commit_fingerprint(a: HDArray) -> tuple:
    """Identity-comparable capture of everything commit() mutates."""
    return (a.sgdef.snapshot(), tuple(a.valid))


def _capture_post(a: HDArray) -> tuple:
    return (a.sgdef.capture(), a.valid.capture())


def _restore_post(a: HDArray, post: tuple) -> None:
    gdef_state, valid_state = post
    a.sgdef.restore(gdef_state)
    a.valid.restore(valid_state)


def _fingerprints_match(a: HDArray, fp: tuple) -> bool:
    snap, valid = fp
    if len(valid) != a.nproc or not a.sgdef.snapshot_equal(snap):
        return False
    for i in range(a.nproc):
        s, c = valid[i], a.valid[i]
        if s is not c and s != c:
            return False
    return True


class Planner:
    def __init__(self) -> None:
        self.stats = PlannerStats()
        self._cache: Dict[tuple, _CacheEntry] = {}

    # ------------------------------------------------------------------
    def _access_sections(
        self, access: Optional[Access], part: Partition, arr: HDArray, p: int
    ) -> SectionSet:
        if access is None:
            return SectionSet.empty(arr.ndim)
        if isinstance(access, AbsoluteSpec):
            return access.sections_for(p)
        return access.sections(part.region(p), arr.shape)

    def _sendmsg_pairs(self, a: HDArray, luse: Tuple[SectionSet, ...]
                       ) -> np.ndarray:
        """Candidate (p, q) pairs for Eqn (1): sender GDEF-row bbox
        overlaps receiver LUSE bbox.  Everything outside is provably an
        empty intersection and is never visited."""
        nproc = a.nproc
        b_lo = np.zeros((nproc, a.ndim), np.int64)
        b_hi = np.zeros((nproc, a.ndim), np.int64)
        b_live = np.zeros(nproc, bool)
        for q in range(nproc):
            bb = luse[q].bbox_bounds()
            if bb is not None:
                b_lo[q], b_hi[q] = bb
                b_live[q] = True
        a_lo, a_hi, a_live = a.sgdef.row_bounds()
        pairs = overlapping_pairs(a_lo, a_hi, a_live, b_lo, b_hi, b_live)
        if pairs.shape[0]:  # the diagonal is identically empty (p == q)
            pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        return pairs

    def plan(
        self,
        kernel: str,
        part: Partition,
        arrays: Sequence[HDArray],
        uses: Dict[str, Access],
        defs: Dict[str, Access],
    ) -> CommPlan:
        """Eqns (1)-(2) with §4.2 two-step reuse."""
        key = (kernel, part.part_id)
        access_sig = tuple(
            (a.name, _access_id(uses.get(a.name)), _access_id(defs.get(a.name)))
            for a in arrays
        )
        entry = self._cache.get(key)
        if entry is not None and entry.access_sig == access_sig:
            period = {a.name: tuple(a.events[entry.event_marks[a.name]:])
                      for a in arrays}
            # step 1: history-buffer trace compare (only after one
            # verified fixpoint period)
            if (entry.fixpoint_verified and entry.last_period is not None
                    and period == entry.last_period):
                self.stats.hits_history += 1
                entry.event_marks = {a.name: len(a.events) for a in arrays}
                entry.last_period = period
                entry.plan.cached = True
                return entry.plan
            # step 2: linear GDEF state compare
            if all(_snapshots_equal(entry.snapshots[a.name], a, self.stats)
                   for a in arrays):
                self.stats.hits_state_compare += 1
                entry.fixpoint_verified = True
                entry.event_marks = {a.name: len(a.events) for a in arrays}
                entry.last_period = period
                entry.plan.cached = True
                return entry.plan

        nproc = part.nproc
        aplans: List[ArrayCommPlan] = []
        for a in arrays:
            use = uses.get(a.name)
            dfn = defs.get(a.name)
            luse = tuple(self._access_sections(use, part, a, p) for p in range(nproc))
            ldef = tuple(self._access_sections(dfn, part, a, p) for p in range(nproc))
            msgs: Dict[Tuple[int, int], SectionSet] = {}
            nbytes = 0
            if use is not None:
                pairs = self._sendmsg_pairs(a, luse)
                self.stats.candidate_pairs += len(pairs)
                self.stats.pairs_pruned += nproc * (nproc - 1) - len(pairs)
                # Dedupe identical pair geometries: the row-factored
                # sGDEF hands back ONE default object per sender row and
                # broadcast-style clauses (GEMM's COL_ALL) give every
                # receiver an equal LUSE, so the P² all-gather sweep has
                # only O(P) distinct (entry, LUSE) geometries.  Map each
                # LUSE to a value-representative, then memoize the
                # intersection (and its byte count) by object identity —
                # cold gemm planning drops from P² set ops to ~P.
                luse_rep: Dict[SectionSet, SectionSet] = {}
                reps = tuple(luse_rep.setdefault(s, s) for s in luse)
                memo: Dict[Tuple[int, int], Tuple[SectionSet, int]] = {}
                itemsize = a.itemsize
                for p, q in pairs:
                    p, q = int(p), int(q)
                    ent = a.sgdef.entry(p, q)
                    if ent.is_empty():
                        continue
                    # (1): SENDMSG[p][q] = sGDEF[p][q] n LUSE_q
                    mk = (id(ent), id(reps[q]))
                    hit = memo.get(mk)
                    if hit is None:
                        m = ent.intersect(reps[q])
                        self.stats.intersect_ops += 1
                        hit = memo[mk] = (m, m.nbytes(itemsize))
                    m, mb = hit
                    if not m.is_empty():
                        msgs[(p, q)] = m
                        nbytes += mb
            kind = classify(msgs, nproc, part)
            aplans.append(ArrayCommPlan(a.name, msgs, kind, nbytes, luse, ldef))
        plan = CommPlan(kernel, part.part_id, aplans)
        self.stats.plans_computed += 1
        self._cache[key] = _CacheEntry(
            plan=plan,
            snapshots={a.name: _gdef_snapshot(a) for a in arrays},
            access_sig=access_sig,
            event_marks={a.name: len(a.events) for a in arrays},
        )
        return plan

    def commit(self, plan: CommPlan, arrays: Sequence[HDArray],
               part: Partition) -> None:
        """Eqns (3)-(4).  Runs for cached plans too — the state must keep
        evolving (the paper instead hides this cost via overlap; we keep
        the accounting separate, as in its Fig. 7 breakdown).

        For a cached plan whose pre-commit state matches the memoized
        one (the §4.2 fixpoint period), the deterministic transition is
        replayed as an O(P) state restore instead of re-running the set
        algebra — the commit-side analogue of plan reuse."""
        byname = {a.name: a for a in arrays}
        entry = self._cache.get((plan.kernel, plan.part_id))
        memo = entry if (entry is not None and entry.plan is plan
                         and plan.cached) else None
        if (memo is not None and memo.commit_pre is not None
                and memo.commit_post is not None
                and all(_fingerprints_match(byname[ap.array],
                                            memo.commit_pre[ap.array])
                        for ap in plan.arrays)):
            for ap in plan.arrays:
                a = byname[ap.array]
                _restore_post(a, memo.commit_post[ap.array])
                a.events.append(hash((plan.kernel, part.part_id, ap.array,
                                      _access_id_of_plan(ap))))
                self.stats.gdef_updates += 1
                self.stats.commit_replays += 1
            return
        pre = ({ap.array: _commit_fingerprint(byname[ap.array])
                for ap in plan.arrays} if memo is not None else None)
        for ap in plan.arrays:
            a = byname[ap.array]
            a.apply_messages_and_defs(ap.messages, ap.ldef)
            a.events.append(hash((plan.kernel, part.part_id, ap.array,
                                  _access_id_of_plan(ap))))
            self.stats.gdef_updates += 1
        if memo is not None:
            memo.commit_pre = pre
            memo.commit_post = {ap.array: _capture_post(byname[ap.array])
                                for ap in plan.arrays}

    def plan_and_commit(self, kernel, part, arrays, uses, defs) -> CommPlan:
        plan = self.plan(kernel, part, arrays, uses, defs)
        self.commit(plan, arrays, part)
        return plan


def _access_id_of_plan(ap: ArrayCommPlan) -> int:
    # stable content hash of the luse/ldef shapes this commit applied
    return hash((ap.array, ap.luse, ap.ldef))
