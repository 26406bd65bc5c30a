"""Measurement-driven weight rebalancing (EngineCL/HaoCL-style loop).

The weighted ``Partition`` factories let callers DECLARE device
capabilities; this module CLOSES THE LOOP from measurements instead:
``run_pipeline`` feeds a :class:`Rebalancer` each step's per-rank
kernel wall times (executor ``last_rank_times``), the rebalancer keeps
an EWMA of every rank's observed *speed* (work items per second —
volume-normalized, so the estimate survives repartitions), and when
the per-rank step times diverge past ``threshold`` for ``patience``
consecutive steps it computes new capability-proportional weights.
The runtime then reacts with the ordinary planned machinery: a
``repartition`` of every data array onto the reweighted layout (the
migration bytes land in ``comm_log`` like any other plan) and a
part-id remap of the remaining steps.  New part ids mean the §4.2
plan caches go cold exactly once and re-warm on the new geometry, and
steady-state scan capture — gated on :meth:`Rebalancer.allow_capture`
while times are still diverging — re-arms on the rebalanced layout.

:func:`reweighted_partition` is the partition algebra: the same
ROW/COL/BLOCK factory that built a partition, re-run with new weights
over the same coverage (the rebalance analogue of
``ft.faults.shrink_partition``).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.partition import PartType
from repro_torch.ft.faults import coverage_box

if TYPE_CHECKING:
    from repro_torch.core.runtime import HDArrayRuntime


@dataclasses.dataclass
class Rebalancer:
    """Decides WHEN to repartition and onto WHICH weights.

    ``observe`` returns True when the runtime should rebalance now:
    the max/min ratio of the current step's per-rank kernel times
    exceeded ``threshold`` for ``patience`` consecutive measured steps,
    at least ``min_duration`` of slowest-rank time (so timing noise on
    tiny kernels cannot trigger), outside the post-rebalance
    ``cooldown``, and under ``max_rebalances``.

    ``data_parts`` (array name -> partition id) names the arrays whose
    data layout should migrate with the work layout — same contract as
    ``RecoveryPolicy.data_parts``.  The runtime updates the mapping in
    place as it repartitions.
    """

    threshold: float = 1.5       # divergence ratio that arms the trigger
    patience: int = 3            # consecutive diverged steps before firing
    alpha: float = 0.5           # EWMA smoothing of per-rank speeds
    cooldown: int = 3            # measured steps to ignore after firing
    max_rebalances: int = 4
    min_weight: float = 0.05     # weight floor: no rank starves to zero
    min_duration: float = 1e-3   # slowest rank must exceed this to count
    min_delta: float = 0.05      # L-inf weight change below which firing
    #                              is pointless (already at the optimum
    #                              the floor permits) — counts as balanced
    data_parts: Optional[Dict[str, int]] = None

    def __post_init__(self) -> None:
        self.speed_ewma: Dict[int, float] = {}
        self.history: List[Tuple[int, Tuple[float, ...]]] = []
        self.rebalances: int = 0
        self._diverged = 0
        self._balanced = 0
        self._cooldown_left = 0

    # -- observation ---------------------------------------------------
    def observe(self, step: int, rank_times: Optional[Sequence[float]],
                volumes: Sequence[int],
                weights: Optional[Sequence[float]] = None) -> bool:
        """Feed one step's per-rank kernel times (+ the per-rank work
        volumes of the step's partition, and its current weights if
        any).  Returns True when the runtime should rebalance before
        the next step."""
        if rank_times is None:
            # unmeasurable step (fused device program, kernel-less
            # plan): no signal — don't hold capture hostage
            self._balanced += 1
            return False
        times = tuple(float(t) for t in rank_times)
        self.history.append((int(step), times))
        if len(self.history) > 512:
            del self.history[:-512]
        work = [(p, t) for p, t in enumerate(times)
                if t > 0 and p < len(volumes) and volumes[p] > 0]
        for p, t in work:
            speed = volumes[p] / t
            e = self.speed_ewma.get(p)
            self.speed_ewma[p] = (speed if e is None
                                  else (1 - self.alpha) * e + self.alpha * speed)
        if len(work) < 2:
            self._balanced += 1
            self._diverged = 0
            return False
        tmax = max(t for _p, t in work)
        tmin = min(t for _p, t in work)
        diverged = tmax >= self.min_duration and tmax > self.threshold * tmin
        if not diverged:
            self._diverged = 0
            self._balanced += 1
            return False
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return False
        # actionability: when the measured target is already (within
        # min_delta, L-inf) the layout we run on — e.g. pinned at the
        # min_weight floor — the divergence is not actionable.  Firing
        # would churn the mesh for an identical layout, so the step
        # counts as balanced (and capture may resume on it).
        nproc = len(times)
        target = self.target_weights(nproc)
        cur = (tuple(weights) if weights is not None
               else tuple(1.0 / nproc for _ in range(nproc)))
        total = sum(cur)
        cur = tuple(w / total for w in cur)
        if max(abs(t - c) for t, c in zip(target, cur)) <= self.min_delta:
            self._diverged = 0
            self._balanced += 1
            return False
        self._diverged += 1
        self._balanced = 0
        return (self._diverged >= self.patience
                and self.rebalances < self.max_rebalances)

    def allow_capture(self) -> bool:
        """Gate for steady-state scan capture: only once the mesh has
        looked balanced (or unmeasurable) for `patience` consecutive
        steps — capturing a diverging pipeline would freeze the very
        layout the rebalancer is about to replace."""
        return self._balanced >= self.patience

    # -- the new weights -----------------------------------------------
    def target_weights(self, nproc: int) -> Tuple[float, ...]:
        """Capability weights ∝ observed per-rank speed, floored at
        ``min_weight`` (renormalized).  Ranks never measured (no work
        yet) get the mean observed speed — neutral, not starved."""
        speeds = [self.speed_ewma.get(p) for p in range(nproc)]
        seen = [s for s in speeds if s is not None]
        if not seen:
            raise RuntimeError("rebalance requested with no measurements")
        fill = sum(seen) / len(seen)
        w = [s if s is not None else fill for s in speeds]
        total = sum(w)
        w = [x / total for x in w]
        if self.min_weight * nproc >= 1.0:
            return tuple(1.0 / nproc for _ in range(nproc))
        # water-fill the floor: clamp starved ranks AT min_weight and
        # renormalize only the unclamped mass, so the floor still holds
        # after normalization (a single clamp-then-renormalize can dip
        # back under it)
        clamped: set = set()
        while True:
            newly = {i for i, x in enumerate(w)
                     if i not in clamped and x < self.min_weight}
            if not newly:
                break
            clamped |= newly
            free = 1.0 - self.min_weight * len(clamped)
            free_total = sum(x for i, x in enumerate(w) if i not in clamped)
            w = [self.min_weight if i in clamped else x * free / free_total
                 for i, x in enumerate(w)]
        return tuple(w)

    def note_rebalanced(self, step: int) -> None:
        """The runtime applied a rebalance at `step`: reset the trigger
        and start the cooldown (the next few measured steps reflect
        migration + cold plan caches, not steady kernel time)."""
        self.rebalances += 1
        self._diverged = 0
        self._balanced = 0
        self._cooldown_left = self.cooldown

    def note_mesh_changed(self) -> None:
        """The mesh shrank or grew (elastic shrink / scale-up): the
        per-rank speed estimates describe the OLD device set — a rank
        that just joined has none, a rank that died must not keep one
        (``target_weights`` would hand a dead rank the mean speed), and
        survivors' speeds shift with the migrated working set.  Start
        the grown/shrunk mesh as a fresh EWMA baseline, under the usual
        post-change cooldown."""
        self.speed_ewma.clear()
        self._diverged = 0
        self._balanced = 0
        self._cooldown_left = self.cooldown


def reweighted_partition(rt: "HDArrayRuntime", part_id: int,
                         weights: Sequence[float]) -> int:
    """Rebuild partition `part_id` with new per-device `weights` over
    the SAME coverage box and register it; returns the new partition
    id.  ROW/COL re-split their axis; BLOCK re-splits both grid axes
    from the per-device weights; MANUAL partitions carry no generative
    rule to re-run and raise."""
    part = rt.parts[part_id]
    base = coverage_box(part.regions)
    if part.ptype is PartType.ROW:
        return rt.parts.new_row(part.domain, part.nproc, region=base,
                                weights=weights)
    if part.ptype is PartType.COL:
        return rt.parts.new_col(part.domain, part.nproc, region=base,
                                weights=weights)
    if part.ptype is PartType.BLOCK:
        grid = _infer_grid(part)
        return rt.parts.new_block(part.domain, part.nproc, grid=grid,
                                  region=base, weights=weights)
    raise ValueError(
        f"cannot reweight a {part.ptype.value} partition automatically — "
        "rebuild it manually with the new regions")


def _infer_grid(part) -> Tuple[int, int]:
    """Recover a BLOCK partition's (g0, g1) grid from its regions: the
    count of distinct dim-0 / dim-1 interval positions in rank order
    (regions are laid out row-major by construction)."""
    g1 = len({r.bounds[1] for r in part.regions if not r.is_empty()})
    g0 = len({r.bounds[0] for r in part.regions if not r.is_empty()})
    if g0 * g1 != part.nproc:
        raise ValueError(
            f"BLOCK grid inference failed: {g0}x{g1} != nproc={part.nproc}")
    return (g0, g1)
