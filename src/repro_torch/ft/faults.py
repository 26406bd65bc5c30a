"""Fault tolerance: planned recovery for the HDArray runtime.

The paper's unified model plans ALL data movement from def/use
information (Eqns (1)-(4)), which makes a rank loss just another
planned event: restore the owned sections from checkpoint, let the
planner derive the traffic that re-covers the lost regions on the
surviving mesh, and resume.  Runtime systems that manage heterogeneous
device pools for the user (EngineCL, HaoCL) treat device dropout and
rebalancing as a scheduler responsibility, not an application one —
this module is that scheduler layer for ``HDArrayRuntime.run_pipeline``
(see :meth:`repro_torch.core.runtime.HDArrayRuntime.run_pipeline` with a
``recovery=`` policy, and docs/fault-tolerance.md for the state
machine).

Components:
  * FaultSpec / FaultInjector — deterministic fault injection for
    tests/benchmarks: transient faults and permanent rank losses, at
    the ``"step"`` site (before a step executes) or the ``"commit"``
    site (mid-step, while the Eqn (3)-(4) commit runs — under overlap
    that is concurrent with in-flight messages).
  * StepGuard — retry-with-restore wrapper: on a TransientFault it
    backs off (exponential, injectable sleep) and restores the last
    committed checkpoint; deterministic pipelines replay exactly.
  * StragglerMonitor — EWMA of per-step wall time; flags steps slower
    than ``threshold`` x the moving average.  ``run_pipeline`` feeds it
    per-step timings and surfaces crossings in
    ``PlannerStats.straggler_events``.  With per-rank timings
    (executor ``last_rank_times``) it also keeps one baseline per rank
    — stable detection of a persistently slow device, and the speed
    signal :mod:`repro_torch.ft.rebalance` turns into new partition weights.
  * RecoveryPolicy — everything run_pipeline needs to survive faults:
    the CheckpointManager + interval, the injector/monitor hooks, and
    the retry/backoff knobs.  ``register_rank`` queues a recovered or
    newly added rank; the runtime grows the mesh back at the next step
    boundary.
  * RankJoinedEvent — the scale-UP signal, symmetric to RankLostFault:
    a recovered (or brand-new) rank re-enters the mesh mid-pipeline.
    Not a fault — a planned control-flow event the runtime answers
    with ``Executor.add_rank`` + a grow repartition.
  * ElasticPlan / plan_elastic_rescale — given a lost/gained device
    set, the new mesh shape + the HDArray migration volume (planned,
    metadata-only).
  * shrink_partition / inherit_partition / survivor_partition /
    grow_partition — the partition algebra of mesh elasticity:
    redistribute a partition's coverage over the surviving ranks (the
    shrink repartition target), let a successor rank inherit a dead
    rank's region (the restore staging layout, so the follow-up
    repartition is a real planned rebalance), or re-split the coverage
    over a GROWN rank set with the joining rank's capability weight
    restored (the scale-up repartition target).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.partition import _even_splits, _weighted_splits
from repro_torch.core.sections import Box, SectionSet

if TYPE_CHECKING:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.runtime import HDArrayRuntime
    from repro_torch.ft.rebalance import Rebalancer


class TransientFault(RuntimeError):
    """A recoverable failure (preemption, link flap, injected).  The
    device pool is intact: restore + replay suffices."""


class RankLostFault(RuntimeError):
    """A PERMANENT rank loss: the device and every byte it held are
    gone.  Recovery must restore the lost sections from checkpoint and
    repartition onto the surviving mesh (not a TransientFault — retry
    cannot bring the rank back)."""

    def __init__(self, rank: int, msg: Optional[str] = None):
        super().__init__(msg or f"rank {rank} lost")
        self.rank = rank


class RankJoinedEvent(Exception):
    """A rank (re)joined the device pool: a recovered rank re-registers
    or a new device is added mid-run.  NOT a fault — a planned
    control-flow signal, raised through the same injection sites as
    faults so elasticity tests can place a join at a step boundary
    (``site="step"``) or mid-commit (``site="commit"``, where the torn
    step must first be discarded via checkpoint restore).  The runtime
    answers with the grow path: ``Executor.add_rank`` allocates the
    shard, :func:`grow_partition` re-splits every layout over the grown
    mesh, and a planned ``repartition`` migrates the bytes."""

    def __init__(self, rank: int, site: str = "step",
                 msg: Optional[str] = None):
        super().__init__(msg or f"rank {rank} joined ({site})")
        self.rank = rank
        self.site = site


# -- deterministic fault injection --------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault (or elasticity event): fire `times` times when
    execution reaches pipeline step `step` at injection site `site`."""
    step: int
    site: str = "step"          # "step" (before execution) | "commit"
    kind: str = "transient"     # "transient" | "rank" | "join"
    rank: int = 0               # the rank that dies/joins (kind="rank"/"join")
    times: int = 1


class FaultInjector:
    """Deterministic fault injection for tests/benchmarks.

    ``fail_at`` accepts bare step numbers (one transient fault each,
    the seed-era behavior) or :class:`FaultSpec` entries for full
    control over site / kind / repetition.  ``log`` records every
    fault actually fired as ``(step, site, kind)``.
    """

    def __init__(self, fail_at: Sequence = (), site: str = "step",
                 kind: str = "transient", rank: int = 0, times: int = 1):
        self.specs: Tuple[FaultSpec, ...] = tuple(
            sp if isinstance(sp, FaultSpec)
            else FaultSpec(int(sp), site, kind, rank, times)
            for sp in fail_at)
        self._count = [0] * len(self.specs)
        self.fired: set = set()
        self.log: List[Tuple[int, str, str]] = []

    @property
    def fail_at(self) -> set:
        return {sp.step for sp in self.specs}

    def maybe_fail(self, step: int, site: str = "step") -> None:
        for j, sp in enumerate(self.specs):
            if sp.step == step and sp.site == site and self._count[j] < sp.times:
                self._count[j] += 1
                self.fired.add(step)
                self.log.append((step, site, sp.kind))
                if sp.kind == "rank":
                    raise RankLostFault(
                        sp.rank, f"injected loss of rank {sp.rank} at step "
                                 f"{step} ({site})")
                if sp.kind == "join":
                    raise RankJoinedEvent(
                        sp.rank, site, f"injected join of rank {sp.rank} "
                                       f"at step {step} ({site})")
                raise TransientFault(f"injected fault at step {step} ({site})")


# -- straggler detection ------------------------------------------------
@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float                  # the baseline the duration was judged against
    rank: Optional[int] = None   # None: whole-step (scalar) detection


class StragglerMonitor:
    """EWMA straggler detection, scalar and per-rank.

    The scalar path (``observe(step, duration)``) flags whole steps
    slower than ``threshold`` x the step-time EWMA, as before.  When
    the executor can attribute time per rank (``last_rank_times``),
    ``observe(..., rank_times=...)`` additionally keeps ONE baseline
    PER RANK and flags rank p against the median of the OTHER ranks'
    baselines.  A persistently slow rank therefore never raises the
    bar it is judged against — the scalar EWMA alone absorbs a
    persistent straggler into the average until it stops being flagged
    — and ``rank_ewma`` doubles as the per-device speed signal the ft
    Rebalancer consumes.  ``min_duration`` floors per-rank detection so
    microsecond-scale timing noise on tiny test kernels cannot flag."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup: int = 3, min_duration: float = 1e-3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.min_duration = min_duration
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self._n = 0
        # per-rank EWMA of kernel wall time + bounded raw history
        self.rank_ewma: Dict[int, float] = {}
        self.rank_history: List[Tuple[int, Tuple[float, ...]]] = []
        self._rank_n = 0

    HISTORY_CAP = 512

    def observe(self, step: int, duration: float,
                rank_times: Optional[Sequence[float]] = None) -> bool:
        """Returns True if this step (or any rank in it) is a straggler."""
        flagged = self._observe_scalar(step, duration)
        if rank_times is not None:
            flagged = self._observe_ranks(step, rank_times) or flagged
        return flagged

    def _observe_scalar(self, step: int, duration: float) -> bool:
        self._n += 1
        if self.ewma is None:
            self.ewma = duration
            return False
        is_straggler = (self._n > self.warmup
                        and duration > self.threshold * self.ewma)
        if is_straggler:
            self.events.append(StragglerEvent(step, duration, self.ewma))
        else:
            # stragglers don't poison the average
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return is_straggler

    def _observe_ranks(self, step: int,
                       rank_times: Sequence[float]) -> bool:
        self._rank_n += 1
        self.rank_history.append((step, tuple(float(t) for t in rank_times)))
        if len(self.rank_history) > self.HISTORY_CAP:
            del self.rank_history[:-self.HISTORY_CAP]
        work = [(p, float(t)) for p, t in enumerate(rank_times) if t > 0]
        flagged = False
        # judge against the baselines BEFORE folding this step in
        if self._rank_n > self.warmup and len(work) >= 2:
            for p, t in work:
                others = [self.rank_ewma[q] for q, _t in work
                          if q != p and q in self.rank_ewma]
                if not others:
                    continue
                baseline = statistics.median(others)
                if t >= self.min_duration and t > self.threshold * baseline:
                    self.events.append(
                        StragglerEvent(step, t, baseline, rank=p))
                    flagged = True
        for p, t in work:
            e = self.rank_ewma.get(p)
            self.rank_ewma[p] = (t if e is None
                                 else (1 - self.alpha) * e + self.alpha * t)
        return flagged


# -- retry/backoff ------------------------------------------------------
class StepGuard:
    """Retry-with-restore wrapper around a step.

    On a TransientFault: back off (exponential in the consecutive-retry
    count, ``sleep`` injectable for tests), call ``restore_fn`` (which
    returns ``(restored_step, state)``), and signal replay-from.  More
    than ``max_retries`` consecutive faults re-raise — the fault is not
    transient after all."""

    def __init__(self, restore_fn: Callable[[], Tuple[int, object]],
                 max_retries: int = 3, backoff: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.restore_fn = restore_fn
        self.max_retries = max_retries
        self.backoff = backoff
        self.sleep = sleep
        self.retries = 0
        self.recoveries: List[int] = []

    def run(self, step: int, fn: Callable[[], object]):
        """Run fn(); on TransientFault restore and signal replay-from."""
        try:
            out = fn()
            self.retries = 0
            return out, None
        except TransientFault:
            self.retries += 1
            if self.retries > self.max_retries:
                raise
            if self.backoff:
                self.sleep(self.backoff * (2 ** (self.retries - 1)))
            restored_step, state = self.restore_fn()
            self.recoveries.append(step)
            return None, (restored_step, state)


# -- the recovery policy -------------------------------------------------
@dataclasses.dataclass
class RecoveryPolicy:
    """What ``run_pipeline(steps, recovery=...)`` needs to survive
    faults.  ``checkpoint`` + ``interval`` bound the replay window;
    ``data_parts`` (array name -> partition id) names each array's
    canonical data layout so a mesh shrink can stage restores on the
    inherit layout and rebalance with a planned repartition; ``clock``
    and ``sleep`` are injectable for deterministic tests.

    Elasticity: ``initial_live`` names the ranks that actually carry
    data/work at pipeline start (default: all of them) — a mesh born
    smaller than ``nproc`` can later GROW onto the idle ranks.
    :meth:`register_rank` is the scale-up entry point: a recovered
    rank re-registering (or a fresh rank being added) lands in
    ``pending_joins`` and the runtime grows the mesh back at the next
    step boundary, automatically."""
    checkpoint: Optional["CheckpointManager"] = None
    interval: int = 1
    injector: Optional[FaultInjector] = None
    monitor: Optional[StragglerMonitor] = None
    max_retries: int = 3
    backoff: float = 0.0
    data_parts: Optional[Dict[str, int]] = None
    clock: Callable[[], float] = time.perf_counter
    sleep: Callable[[float], None] = time.sleep
    # optional measurement-driven weight rebalancing (ft.rebalance):
    # consumes the same per-rank timings the monitor sees and triggers
    # a mid-pipeline repartition when they diverge persistently
    rebalancer: Optional["Rebalancer"] = None
    # ranks that hold data/work at pipeline start (None: all ranks)
    initial_live: Optional[Sequence[int]] = None
    # ranks queued for a grow at the next step boundary (register_rank)
    pending_joins: List[int] = dataclasses.field(default_factory=list)

    def register_rank(self, rank: int) -> None:
        """A recovered/added rank announces itself.  The runtime drains
        ``pending_joins`` at the next step boundary and grows the mesh
        (Executor.add_rank + grow_partition + planned repartition) —
        no caller-side orchestration needed."""
        if rank not in self.pending_joins:
            self.pending_joins.append(rank)


# -- partition algebra of a mesh shrink ----------------------------------
def _empty_box(ndim: int) -> Box:
    return Box(tuple((0, 0) for _ in range(ndim)))


def coverage_box(regions: Sequence[Box]) -> Box:
    """The single Box the non-empty regions tile exactly.  Raises when
    the union is not a box (a shrink of non-convex coverage would
    either drop or invent work items)."""
    live = [r for r in regions if not r.is_empty()]
    if not live:
        raise ValueError("partition has no non-empty regions")
    union = SectionSet.of(*live)
    lo, hi = union.bbox_bounds()
    bbox = Box(tuple((int(a), int(b)) for a, b in zip(lo, hi)))
    if union.volume() != bbox.volume():
        raise ValueError(
            f"partition coverage {union} does not tile a box; cannot "
            "shrink it automatically — pass explicit survivor regions")
    return bbox


def shrink_partition(rt: "HDArrayRuntime", part_id: int,
                     live: Sequence[int]) -> int:
    """The repartition TARGET of a mesh shrink: re-split the
    partition's coverage box over the surviving ranks (dim-0
    contiguous chunks, like the paper's ``HDArrayPartition``); dead
    ranks get empty regions.  A weighted partition keeps the
    survivors' capability proportions (their weights, renormalized);
    unweighted partitions split evenly as before.  Returns the new
    partition id."""
    part = rt.parts[part_id]
    live = sorted(live)
    bbox = coverage_box(part.regions)
    nd = len(bbox.bounds)
    lo0, hi0 = bbox.bounds[0]
    w = None
    if part.weights is not None:
        w = [part.weights[p] for p in live]
        if sum(w) <= 0:
            w = None               # all weight died with the lost ranks
    splits = (_weighted_splits(hi0 - lo0, w) if w is not None
              else _even_splits(hi0 - lo0, len(live)))
    regions = [_empty_box(nd)] * part.nproc
    for j, p in enumerate(live):
        b = list(bbox.bounds)
        b[0] = (lo0 + splits[j][0], lo0 + splits[j][1])
        regions[p] = Box(tuple(b))
    weights = None
    if w is not None:
        weights = [0.0] * part.nproc
        for p in live:
            weights[p] = part.weights[p]
    return rt.partition_manual(part.domain, regions, weights=weights)


def inherit_partition(rt: "HDArrayRuntime", part_id: int,
                      live: Sequence[int]) -> Optional[int]:
    """The restore STAGING layout of a mesh shrink: each dead rank's
    region is absorbed by a surviving rank whose region merges with it
    into an exact box (nearest live rank first), so survivors keep
    their old sections and only the lost sections are re-homed.  The
    follow-up ``repartition`` to :func:`shrink_partition`'s even
    layout is then a genuine planned rebalance.  Returns None when no
    exact-box merge exists (caller falls back to the even layout)."""
    part = rt.parts[part_id]
    live_set = sorted(live)
    dead = [p for p in range(part.nproc) if p not in set(live_set)]
    regions = list(part.regions)
    nd = len(part.domain)
    for r in dead:
        box = regions[r]
        regions[r] = _empty_box(nd)
        if box.is_empty():
            continue
        placed = False
        for p in sorted(live_set, key=lambda q: (abs(q - r), q)):
            pr = regions[p]
            if pr.is_empty():
                regions[p] = box
                placed = True
                break
            merged = Box(tuple((min(alo, blo), max(ahi, bhi))
                               for (alo, ahi), (blo, bhi)
                               in zip(pr.bounds, box.bounds)))
            if merged.volume() == pr.volume() + box.volume():
                regions[p] = merged
                placed = True
                break
        if not placed:
            return None
    return rt.partition_manual(part.domain, regions)


def survivor_partition(rt: "HDArrayRuntime", shape: Sequence[int],
                       live: Sequence[int]) -> int:
    """An even dim-0 split of the FULL array domain over the surviving
    ranks — the default checkpoint-restore layout (always covers the
    array, so the coherence gate passes whenever live is non-empty)."""
    shape = tuple(int(s) for s in shape)
    live = sorted(live)
    nd = len(shape)
    splits = _even_splits(shape[0], len(live))
    regions = [_empty_box(nd)] * rt.nproc
    for j, p in enumerate(live):
        b = [(0, s) for s in shape]
        b[0] = splits[j]
        regions[p] = Box(tuple(b))
    return rt.partition_manual(shape, regions)


def grow_partition(rt: "HDArrayRuntime", part_id: int,
                   live: Sequence[int], rank: int,
                   weight: Optional[float] = None) -> int:
    """The repartition TARGET of a mesh grow — the inverse of
    :func:`shrink_partition`: re-split partition ``part_id``'s coverage
    over ``live`` ∪ {``rank``}, restoring the joining rank's capability
    weight (0 → ``weight``).  The runtime resolves ``weight`` from the
    pre-loss record or the :class:`DeviceProfileRegistry`; when neither
    knows the rank (a brand-new device), the mean of the live weights
    is used — neutral, like ``Rebalancer.target_weights`` for
    never-measured ranks.

    Factory-typed partitions (ROW/COL/BLOCK — e.g. the plain scale-up
    of a rank that was never lost, still sitting on its zero-weight
    factory layout) re-run their own factory via
    :func:`repro_torch.ft.rebalance.reweighted_partition`; MANUAL layouts
    (the post-shrink state) re-split their coverage box along dim 0,
    symmetric to the shrink.  Returns the new partition id."""
    from repro_torch.core.partition import PartType
    from repro_torch.ft.rebalance import reweighted_partition

    part = rt.parts[part_id]
    live = sorted(set(live) | {rank})
    wvec = None
    if part.weights is not None:
        wvec = list(part.weights)
        if not wvec[rank] > 0:
            if weight is None:
                alive = [wvec[p] for p in live if wvec[p] > 0]
                weight = (sum(alive) / len(alive)) if alive else 1.0
            wvec[rank] = float(weight)
        live_set = set(live)
        wvec = [wvec[p] if p in live_set else 0.0
                for p in range(part.nproc)]
    if part.ptype is not PartType.MANUAL and wvec is not None:
        return reweighted_partition(rt, part_id, wvec)
    bbox = coverage_box(part.regions)
    nd = len(bbox.bounds)
    lo0, hi0 = bbox.bounds[0]
    w = [wvec[p] for p in live] if wvec is not None else None
    splits = (_weighted_splits(hi0 - lo0, w) if w is not None
              else _even_splits(hi0 - lo0, len(live)))
    regions = [_empty_box(nd)] * part.nproc
    for j, p in enumerate(live):
        b = list(bbox.bounds)
        b[0] = (lo0 + splits[j][0], lo0 + splits[j][1])
        regions[p] = Box(tuple(b))
    return rt.partition_manual(part.domain, regions, weights=wvec)


# -- elasticity accounting ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Re-shape plan after node loss/gain: new mesh + data migration."""
    old_devices: int
    new_devices: int
    new_mesh_shape: Tuple[int, ...]
    migration_bytes: int


def plan_elastic_rescale(n_params: int, itemsize: int, old_devices: int,
                         new_devices: int, model_axis: int) -> ElasticPlan:
    """Pick the new mesh and estimate the migration volume via the
    HDArray repartition planner (ROW repartition of the flattened param
    space from `old` to `new` shards).  Metadata-only: the plan runs on
    the ``null`` backend, no parameter bytes are materialized."""
    from repro_torch.core import HDArrayRuntime
    rows = max(old_devices, new_devices)
    rt = HDArrayRuntime(rows, backend="null")
    h = rt.create("params", (rows, max(1, n_params // rows)),
                  dtype=np.float32 if itemsize == 4 else np.float16)

    def manual(n_live):
        splits = _even_splits(rows, n_live)
        regions = [Box.make((lo, hi), (0, h.shape[1])) for lo, hi in splits]
        regions += [Box.make((0, 0), (0, h.shape[1]))] * (rows - n_live)
        return rt.partition_manual((rows, h.shape[1]), regions)

    p_old, p_new = manual(old_devices), manual(new_devices)
    rt.write(h, None, p_old)
    plan = rt.repartition(h, p_old, p_new)
    data_axis = new_devices // model_axis
    return ElasticPlan(old_devices, new_devices,
                       (data_axis, model_axis), plan.bytes_total)
