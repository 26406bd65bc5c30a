"""HDArrayRuntime — the user-facing facade (paper Table 2 APIs).

Mirrors the paper's library:

  HDArrayInit              -> HDArrayRuntime(nproc, backend=...)
  HDArrayCreate            -> rt.create(name, shape, dtype)
  HDArrayPartition         -> rt.partition_row/col/block/manual(...)
  HDArrayWrite / Read      -> rt.write / rt.read
  HDArrayApplyKernel       -> rt.apply_kernel(...)
  HDArrayReduce            -> rt.reduce(...)  (a planned kernel:
                              coherence messages via Eqns (1)-(2),
                              executor local fold, ALL_REDUCE combine)
  HDArraySetAbsoluteUse/Def-> AbsoluteSpec arguments to apply_kernel
  HDArraySetTrapezoidUse/..-> offsets.trapezoid(...) helper
  (repartition at any point: just pass a different partition id)

Backend selection: ``backend=`` picks the executor that carries the
classified plans —

  * ``"torch"`` (default) resident tensors on ``device`` (``"cuda"``
    unless the caller asks for ``"cpu"``), see
    :mod:`repro_torch.executors.torch_exec`;
  * ``"sim"``  host-numpy buffers, the validation oracle;
  * ``"null"`` metadata-only (plan + byte accounting, no data).

The reference's legacy ``materialize=False`` flag is not carried over:
pass ``backend="null"``.

Overlap semantics (paper §4.2 / Fig. 7): with ``overlap=True`` every
``apply_kernel`` runs the message execution on a comm thread (on a
card, its copies on a CUDA stream of their own) while the Eqn (3)-(4)
commit proceeds on the host, and HALO-classified plans additionally
overlap the interior kernel sweep with the ghost-cell exchange
(double-buffered halo).  ``run_pipeline`` extends this to a program:
step i+1's planning overlaps step i's communication.  Overlap mode
assumes the paper's work-item model — a kernel must be able to compute
any sub-region of its assigned region independently.  Results are
bit-identical to the serial schedule (tests enforce it).

Without overlap, each ``apply_kernel`` is one executor call, which the
torch backend runs as one program (a CUDA graph on a card), and
``run_pipeline`` runs the steady state of a periodic program as one
captured cycle (``Executor.capture_cycle``).

Fault recovery and measured rebalancing (``run_pipeline(recovery=,
rebalance=)``, with :mod:`repro_torch.ft` and :mod:`repro_torch.ckpt`):
checkpoint restore and replay, a planned shrink after a rank loss, a
planned grow when a rank joins, and a repartition onto measured
capability weights.  While a consumer of per-rank times is attached (a
``Rebalancer``, a policy's ``StragglerMonitor``) the runtime asks the
executor to time each rank (``Executor.time_ranks``, where the
executor has it): on the torch backend such steps run unfused, each
rank's sweep between two CUDA events.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.executors import (DeviceProfileRegistry, OverlapScheduler,
                                   make_executor)

from .comm import lower_plan
from .hdarray import HDArray
from .offsets import AccessSpec
from .partition import Box, PartitionTable
from .planner import Access, ArrayCommPlan, CommKind, CommPlan, Planner
from .sections import SectionSet

# identity elements for reductions over an empty domain (max/min have
# none — an empty max/min is a caller error, not a value)
_REDUCE_IDENTITY = {"sum": 0, "prod": 1}
REDUCE_OPS = ("sum", "prod", "max", "min")


class HDArrayRuntime:
    def __init__(self, nproc: int, backend: str = "torch",
                 overlap: bool = False, executor=None, profiles=None,
                 device: str = "cuda"):
        """``backend`` selects the executor ("torch" / "sim" / "null");
        ``device`` is where the "torch" backend keeps its tensors.
        An explicit ``executor`` instance overrides both.  ``profiles``
        (a :class:`~repro_torch.executors.profiles.DeviceProfileRegistry`
        or a sequence of ``DeviceProfile``) declares per-rank device
        capabilities; when given, every partition this runtime creates
        defaults to the registry's capability-proportional weights.
        ``overlap=True`` enables the §4.2 comm/compute-overlap
        schedule."""
        self.nproc = nproc
        self.backend = backend
        if profiles is not None and not hasattr(profiles, "weights"):
            reg = DeviceProfileRegistry(nproc)
            for prof in profiles:
                reg.declare(prof.rank, prof.device_class, prof.flops,
                            prof.bandwidth)
            profiles = reg
        self.profiles = profiles
        self.parts = PartitionTable()
        self.planner = Planner()
        if executor is None:
            kw = {"device": device} if backend == "torch" else {}
            executor = make_executor(backend, nproc=nproc, **kw)
        self.executor = executor
        self._scheduler = OverlapScheduler(self.executor) if overlap else None
        self.arrays: Dict[str, HDArray] = {}
        self.comm_log: list = []     # [(kernel, CommPlan bytes, kinds)]
        # fault-recovery audit trail: one record per recovery cycle,
        # rebalance, or mesh grow (run_pipeline's recovery= path)
        self.recovery_log: list = []
        # capability weights ranks held before being lost — a rejoin
        # restores them (0 -> w) instead of guessing
        self._lost_weights: Dict[int, float] = {}

    # -- lifecycle ------------------------------------------------------
    def create(self, name: str, shape, dtype=np.float32) -> HDArray:
        arr = HDArray(name, tuple(shape), dtype, self.nproc)
        self.arrays[name] = arr
        self.executor.allocate(arr)
        return arr

    def close(self) -> None:
        for a in self.arrays.values():
            self.executor.free(a)
        self.arrays.clear()
        if self._scheduler is not None:
            self._scheduler.shutdown()

    # -- partitions -------------------------------------------------------
    # Each factory takes optional per-device `weights` (capability-
    # proportional split; uniform == even, bit-identically).  With no
    # explicit weights the runtime's device profiles, when declared,
    # supply the default.
    def _default_weights(self, weights):
        if weights is not None or self.profiles is None:
            return weights
        return self.profiles.weights()

    def partition_row(self, domain, region: Optional[Box] = None,
                      weights=None) -> int:
        return self.parts.new_row(domain, self.nproc, region,
                                  self._default_weights(weights))

    def partition_col(self, domain, region: Optional[Box] = None,
                      weights=None) -> int:
        return self.parts.new_col(domain, self.nproc, region,
                                  self._default_weights(weights))

    def partition_block(self, domain, grid=None, region: Optional[Box] = None,
                        weights=None) -> int:
        return self.parts.new_block(domain, self.nproc, grid, region,
                                    self._default_weights(weights))

    def partition_manual(self, domain, regions: Sequence[Box],
                         weights=None) -> int:
        # manual regions are explicit: weights are bookkeeping, never a
        # profile default
        return self.parts.new_manual(domain, regions, weights)

    # -- I/O ---------------------------------------------------------------
    def write(self, arr: HDArray, data: np.ndarray, part_id: int) -> None:
        """Distribute `data` onto devices per the partition (paper
        HDArrayWrite): device p receives + becomes owner of its region."""
        part = self.parts[part_id]
        per_device = tuple(
            self._clip_region_to_array(part.region(p), arr) for p in range(self.nproc)
        )
        self.executor.write(arr, data, per_device)
        arr.record_write(per_device)

    def write_replicated(self, arr: HDArray, data: np.ndarray) -> None:
        """Give every device a full coherent copy (no comm ever needed
        until someone redefines a section).  Supersedes every pending
        send: the whole sGDEF empties (see `HDArray.record_replicated`)."""
        full = SectionSet.full(arr.shape)
        self.executor.write(arr, data, tuple(full for _ in range(self.nproc)))
        arr.record_replicated()

    def read(self, arr: HDArray, part_id: int) -> np.ndarray:
        part = self.parts[part_id]
        per_device = tuple(
            self._clip_region_to_array(part.region(p), arr) for p in range(self.nproc)
        )
        return self.executor.read(arr, per_device)

    def read_coherent(self, arr: HDArray) -> np.ndarray:
        """Assemble the globally coherent view from each device's valid
        sections (controller-side gather)."""
        return self.executor.read(arr, tuple(arr.valid))

    # -- the core call -----------------------------------------------------
    def apply_kernel(
        self,
        kernel_name: str,
        part_id: int,
        kernel: Optional[Callable],
        arrays: Sequence[HDArray],
        uses: Dict[str, Access],
        defs: Dict[str, Access],
        _fault_hook: Optional[Callable[[str], None]] = None,
        **kw,
    ) -> CommPlan:
        """Paper Fig. 3: plan comm (Eqns 1-2) -> move data -> run kernel
        -> commit GDEF updates (Eqns 3-4).  Under ``overlap=True`` the
        move/commit (and, for halos, part of the kernel) run
        concurrently — see the module docstring.

        ``_fault_hook`` (recovery-path internal) is called with site
        ``"commit"`` immediately before the Eqn (3)-(4) commit — under
        overlap that is on the host thread while messages are still in
        flight, and the scheduler joins the comm thread (on a card, the
        host stream waits for the copies) before the fault leaves the
        step — so fault injection can tear a step mid-commit."""
        part = self.parts[part_id]
        plan = self.planner.plan(kernel_name, part, arrays, uses, defs)

        def _commit() -> None:
            if _fault_hook is not None:
                _fault_hook("commit")
            self.planner.commit(plan, arrays, part)

        stats = self.planner.stats
        if self._scheduler is not None:
            self._scheduler.step(
                plan, part, kernel, arrays, self.arrays, uses, defs, kw,
                commit=_commit)
            # messages ∥ commit, then the kernel: two host dispatches
            stats.python_dispatches_per_step = 2.0
        else:
            # ONE runtime->executor call for the whole step: a fusing
            # backend runs exchange + kernel as a single device program
            # (True); the classic two-phase path returns False
            fused = self.executor.execute_step(
                plan, self.arrays, kernel, part.regions, arrays,
                uses=uses, defs=defs, kw=kw)
            _commit()
            if fused:
                stats.fused_steps += 1
                stats.python_dispatches_per_step = 1.0
            else:
                stats.python_dispatches_per_step = \
                    2.0 if kernel is not None else 1.0
        self.log_plan(kernel_name, plan)
        return plan

    def run_pipeline(self, steps: Sequence[Dict],
                     recovery=None, rebalance=None) -> list:
        """Run a program of apply_kernel steps.  Each step:
        dict(kernel_name=, part_id=, kernel=, arrays=, uses=, defs=,
        kw={}).

        With ``overlap=True`` it runs the Fig. 7 schedule: step i+1's
        planning overlaps step i's message execution.

        With ``recovery`` (a :class:`repro_torch.ft.faults.
        RecoveryPolicy`) the pipeline survives faults: state checkpoints
        every ``interval`` steps, a ``TransientFault`` restores the last
        checkpoint and replays (retry/backoff via StepGuard), a
        ``RankLostFault`` additionally shrinks every partition onto the
        surviving ranks through coherence-gated ``repartition`` before
        resuming, and a joining rank (``RankJoinedEvent`` or
        ``RecoveryPolicy.register_rank``) grows them back.
        Deterministic kernels replay bit-identically.  Recovery mode
        steps serially, one ``apply_kernel`` per step (per-step §4.2
        overlap still applies when ``overlap=True``; the cross-step
        plan-ahead and the cycle capture of the fault-free paths would
        run past a checkpoint boundary).

        Without overlap, the serial path watches for a *steady-state
        cycle*: a repeating step sequence whose every step replayed
        both its plan (§4.2 cache hit) and its commit (fingerprint
        replay) for two consecutive periods.  Such a cycle is provably
        periodic, so the remaining repetitions are offered to the
        executor as ONE captured program (``Executor.capture_cycle`` —
        the torch backend replays a CUDA graph of one period on a card);
        the planner then fast-replays each covered step's metadata so
        ``comm_log`` and the GDEF state evolve exactly as the unfused
        schedule.  Host backends decline and nothing changes.  Per-rank
        kernel times, where the executor measures them, land in
        ``PlannerStats.rank_step_times``.

        With ``rebalance`` (a :class:`repro_torch.ft.rebalance.
        Rebalancer`, or ``RecoveryPolicy.rebalancer`` on the recovery
        path) the pipeline watches the executor's per-rank kernel times
        and, when they diverge persistently, repartitions mid-flight
        onto measured capability-proportional weights: the rebalancer's
        ``data_parts`` arrays migrate through the ordinary planned
        ``repartition`` (bytes in ``comm_log``), the remaining steps'
        work partitions are rewritten, and a ``"rebalance"`` record
        lands in ``recovery_log``.  Cycle capture is gated on the mesh
        looking balanced (``Rebalancer.allow_capture``), so captures
        re-arm on the new layout."""
        if recovery is not None:
            reb = rebalance if rebalance is not None \
                else getattr(recovery, "rebalancer", None)
            timed = reb is not None \
                or getattr(recovery, "monitor", None) is not None
            with self._rank_timing(timed):
                return self._run_pipeline_recoverable(list(steps), recovery,
                                                      rebalance)
        if self._scheduler is None:
            if rebalance is None:
                return self._run_pipeline_serial(list(steps))
            # rebalancing rewrites the remaining steps' part ids: work
            # on copies so the caller's dicts survive
            with self._rank_timing(True):
                return self._run_pipeline_serial(
                    [dict(st) for st in steps], rebalance)
        if rebalance is not None:
            raise ValueError(
                "rebalance requires the serial or recovery pipeline "
                "path (overlap=False, or a RecoveryPolicy)")
        return self._scheduler.pipeline(self, list(steps))

    @contextlib.contextmanager
    def _rank_timing(self, on: bool):
        """Ask the executor for per-rank kernel times while a consumer
        reads them (executors without the switch measure what they
        measure, the Sim oracle always)."""
        ex = self.executor
        if not on or not hasattr(ex, "time_ranks"):
            yield
            return
        ex.time_ranks = True
        try:
            yield
        finally:
            ex.time_ranks = False

    # -- steady-state capture (one dispatch for K steps) -----------------
    #: longest cycle period the serial pipeline looks for
    _MAX_CYCLE_PERIOD = 4

    def _run_pipeline_serial(self, steps: list, rebalance=None) -> list:
        stats = self.planner.stats
        n = len(steps)
        plans: list = [None] * n
        steady = [False] * n
        try_capture = True
        i = 0
        while i < n:
            if try_capture and (rebalance is None
                                or rebalance.allow_capture()):
                d = self._cycle_period(steps, steady, i)
                if d:
                    # only the upcoming steps that literally repeat the
                    # detected cycle are capturable
                    match = 0
                    while (i + match < n and self._steps_equal(
                            steps[i + match], steps[i - d + match % d])):
                        match += 1
                    reps = match // d
                    if reps >= 1:
                        cycle = [dict(
                            plan=plans[i - d + j],
                            kernel=steps[i - d + j]["kernel"],
                            regions=self.parts[
                                steps[i - d + j]["part_id"]].regions,
                            arrays=steps[i - d + j]["arrays"],
                            uses=steps[i - d + j]["uses"],
                            defs=steps[i - d + j]["defs"],
                            kw=steps[i - d + j].get("kw", {}),
                        ) for j in range(d)]
                        runner = self.executor.capture_cycle(cycle, reps)
                        if runner is None:
                            try_capture = False
                        else:
                            runner()          # reps*d steps, ONE dispatch
                            stats.scan_captures += 1
                            for k in range(reps * d):
                                plans[i + k] = self._replay_step_metadata(
                                    steps[i + k])
                                steady[i + k] = True
                            stats.python_dispatches_per_step = 0.0
                            i += reps * d
                            continue
            before = stats.commit_replays
            st = steps[i]
            plans[i] = self.apply_kernel(
                st["kernel_name"], st["part_id"], st["kernel"],
                st["arrays"], st["uses"], st["defs"], **st.get("kw", {}))
            # steady := the §4.2 machinery replayed BOTH the plan and
            # the commit — the step touched no set algebra at all
            steady[i] = (plans[i].cached and stats.commit_replays - before
                         == len(plans[i].arrays))
            rank_times = getattr(self.executor, "last_rank_times", None)
            if rank_times is not None:
                stats.note_rank_times(i, rank_times)
            if rebalance is not None:
                part = self.parts[st["part_id"]]
                volumes = tuple(r.volume() for r in part.regions)
                if rebalance.observe(i, rank_times, volumes,
                                     weights=part.weights):
                    # steps[i+1:] move to the reweighted partitions;
                    # their steady-state witness rebuilds on the new
                    # geometry before capture is offered again
                    self._apply_rebalance(rebalance, steps, i + 1)
            i += 1
        return plans

    def _cycle_period(self, steps: list, steady: list, i: int) -> int:
        """Smallest period d such that the last 2d steps were all steady
        and the two periods are the same step sequence — the witness
        that makes capture sound (see capture_cycle in base.py)."""
        for d in range(1, min(self._MAX_CYCLE_PERIOD, i // 2) + 1):
            if (all(steady[i - k] for k in range(1, 2 * d + 1))
                    and all(self._steps_equal(steps[i - 2 * d + j],
                                              steps[i - d + j])
                            for j in range(d))):
                return d
        return 0

    @staticmethod
    def _steps_equal(a: Dict, b: Dict) -> bool:
        return (a["kernel_name"] == b["kernel_name"]
                and a["part_id"] == b["part_id"]
                and a["kernel"] is b["kernel"]
                and len(a["arrays"]) == len(b["arrays"])
                and all(x is y for x, y in zip(a["arrays"], b["arrays"]))
                and a["uses"] == b["uses"] and a["defs"] == b["defs"]
                and a.get("kw", {}) == b.get("kw", {}))

    def _replay_step_metadata(self, st: Dict) -> CommPlan:
        """Advance the planner state for a step whose DATA movement ran
        inside a captured program.  The periodicity witness guarantees
        both replays hit; the RuntimeErrors are tripwires, not paths."""
        part = self.parts[st["part_id"]]
        arrays = st["arrays"]
        stats = self.planner.stats
        before = stats.commit_replays
        plan = self.planner.plan(st["kernel_name"], part, arrays,
                                 st["uses"], st["defs"])
        if not plan.cached:
            raise RuntimeError(
                f"captured step {st['kernel_name']!r} fell out of the "
                f"§4.2 plan cache — the steady-state witness was wrong")
        self.planner.commit(plan, arrays, part)
        if stats.commit_replays - before != len(plan.arrays):
            raise RuntimeError(
                f"captured step {st['kernel_name']!r} commit was not a "
                f"fingerprint replay — the steady-state witness was "
                f"wrong")
        self.log_plan(st["kernel_name"], plan)
        return plan

    # -- fault-tolerant pipeline (docs/fault-tolerance.md) ---------------
    def _run_pipeline_recoverable(self, steps: list, policy,
                                  rebalance=None) -> list:
        # ft imports stay function-local: repro_torch.ft imports repro_torch.core
        from repro_torch.ft.faults import (RankJoinedEvent, RankLostFault,
                                     StepGuard)

        if policy.checkpoint is None:
            raise ValueError("RecoveryPolicy.checkpoint is required: "
                             "recovery without a restore point cannot "
                             "replay")
        cm = policy.checkpoint
        stats = self.planner.stats
        n = len(steps)
        steps = [dict(st) for st in steps]   # part_ids rewritten on shrink
        plans: list = [None] * n
        initial_live = getattr(policy, "initial_live", None)
        live = (sorted(int(p) for p in initial_live)
                if initial_live is not None else sorted(range(self.nproc)))
        saved: set = set()
        reb = rebalance if rebalance is not None \
            else getattr(policy, "rebalancer", None)
        if reb is not None and reb.data_parts is None:
            # share the policy's canonical-layout mapping so a shrink
            # and a rebalance keep updating the same dict
            reb.data_parts = policy.data_parts

        def restore_fn():
            k = cm.restore_runtime(self, parts=policy.data_parts,
                                   live=live)
            return k, None

        guard = StepGuard(restore_fn, max_retries=policy.max_retries,
                          backoff=policy.backoff, sleep=policy.sleep)
        i = 0
        while i < n:
            # drain out-of-band joins (RecoveryPolicy.register_rank):
            # a recovered rank re-registering grows the mesh back at
            # the very next step boundary, automatically
            pending = getattr(policy, "pending_joins", None)
            if pending:
                for r in list(pending):
                    self._recover_rank_join(r, policy, steps, live,
                                            rebalancer=reb, step=i)
                pending.clear()
            if (policy.interval and i % policy.interval == 0
                    and i not in saved):
                cm.save_runtime(i, self)
                saved.add(i)
            t0 = policy.clock()
            try:
                out, replay = guard.run(
                    i, lambda st=steps[i], k=i: self._guarded_step(
                        st, policy.injector, k))
            except RankLostFault as e:
                restored = self._recover_rank_loss(e.rank, policy, steps,
                                                   live, rebalancer=reb)
                stats.recoveries += 1
                stats.steps_replayed += i - restored
                i = restored
                continue
            except RankJoinedEvent as e:
                resume = i
                if e.site == "commit":
                    # the step tore mid-commit: discard it via the last
                    # checkpoint first, then grow, then replay — values
                    # stay bit-identical (partition-independent)
                    restored, _state = restore_fn()
                    stats.recoveries += 1
                    stats.steps_replayed += i - restored
                    resume = restored
                self._recover_rank_join(e.rank, policy, steps, live,
                                        rebalancer=reb, step=i)
                i = resume
                continue
            if replay is not None:
                restored, _state = replay
                stats.recoveries += 1
                stats.steps_replayed += i - restored
                i = restored
                continue
            dt = policy.clock() - t0
            rank_times = getattr(self.executor, "last_rank_times", None)
            if rank_times is not None:
                stats.note_rank_times(i, rank_times)
            if (policy.monitor is not None
                    and policy.monitor.observe(i, dt,
                                               rank_times=rank_times)):
                stats.straggler_events += 1
            if reb is not None:
                part = self.parts[steps[i]["part_id"]]
                volumes = tuple(r.volume() for r in part.regions)
                if reb.observe(i, rank_times, volumes,
                               weights=part.weights):
                    self._apply_rebalance(reb, steps, i + 1, live=live)
            plans[i] = out
            i += 1
        return plans

    def _guarded_step(self, st: Dict, injector, i: int) -> CommPlan:
        if injector is not None:
            injector.maybe_fail(i, site="step")
            hook = lambda site: injector.maybe_fail(i, site=site)  # noqa: E731
        else:
            hook = None
        return self.apply_kernel(
            st["kernel_name"], st["part_id"], st["kernel"], st["arrays"],
            st["uses"], st["defs"], _fault_hook=hook, **st.get("kw", {}))

    def _recover_rank_loss(self, rank: int, policy, steps: list,
                           live: list, rebalancer=None) -> int:
        """The planned-shrink path: mark the rank dead (coherence
        metadata + executor buffers), restore the checkpoint onto a
        staging layout over the survivors, repartition every array onto
        its shrunken canonical layout (a PLANNED migration, coherence-
        gated, visible in comm_log), and rewrite the remaining steps'
        work partitions onto the surviving ranks.  Returns the step to
        resume from."""
        from repro_torch.ft.faults import (ElasticPlan, inherit_partition,
                                     shrink_partition, survivor_partition)

        if rank in live:
            live.remove(rank)
        if not live:
            raise RuntimeError(f"rank {rank} lost and no survivors remain")
        # remember the capability weight the rank carried so a later
        # rejoin restores it (0 -> w) instead of guessing
        for pid in (list((policy.data_parts or {}).values())
                    + [st["part_id"] for st in steps]):
            wts = self.parts[pid].weights
            if wts is not None and wts[rank] > 0:
                self._lost_weights[rank] = float(wts[rank])
                break
        for arr in self.arrays.values():
            arr.mark_rank_lost(rank)
            self.executor.drop_rank(arr, rank)
        # restore staging: survivors keep their checkpointed sections
        # where the old data layout permits (inherit), else an even
        # survivor split; then rebalance with a planned repartition
        data_parts = dict(policy.data_parts or {})
        staging: Dict[str, int] = {}
        targets: Dict[str, int] = {}
        for name, arr in self.arrays.items():
            if name in data_parts:
                pid = inherit_partition(self, data_parts[name], live)
                if pid is None:
                    pid = survivor_partition(self, arr.shape, live)
                staging[name] = pid
                targets[name] = shrink_partition(self, data_parts[name],
                                                 live)
            else:
                pid = survivor_partition(self, arr.shape, live)
                staging[name] = pid
                targets[name] = pid
        restored = cm_step = policy.checkpoint.restore_runtime(
            self, parts=staging, live=live)
        migration = 0
        for name, arr in self.arrays.items():
            if targets[name] != staging[name]:
                plan = self.repartition(arr, staging[name], targets[name])
                migration += plan.bytes_total
        if policy.data_parts is not None:
            policy.data_parts.update(targets)
        # remaining steps' WORK partitions shrink onto the survivors too
        remap: Dict[int, int] = {}
        for st in steps:
            pid = st["part_id"]
            if pid not in remap:
                remap[pid] = shrink_partition(self, pid, live)
            st["part_id"] = remap[pid]
        if rebalancer is not None:
            rebalancer.note_mesh_changed()
        self.planner.stats.elastic_shrinks += 1
        self.recovery_log.append({
            "kind": "rank_loss", "rank": rank,
            "restored_step": restored, "live": list(live),
            "migration_bytes": migration,
            "plan": ElasticPlan(len(live) + 1, len(live),
                                (len(live),), migration)})
        return cm_step

    def _restored_weight(self, rank: int) -> Optional[float]:
        """The capability weight a (re)joining rank comes back with:
        the weight it carried before being lost, else the declared
        DeviceProfileRegistry weight for a rank that was never lost
        (genuine scale-up of a known device), else None —
        ``grow_partition`` then defaults to the mean of the live
        weights (neutral, like an unmeasured rank)."""
        if rank in self._lost_weights:
            return self._lost_weights[rank]
        if self.profiles is not None:
            try:
                return float(self.profiles.weights()[rank])
            except Exception:
                return None
        return None

    def _recover_rank_join(self, rank: int, policy, steps: list,
                           live: list, rebalancer=None,
                           step: Optional[int] = None) -> None:
        """The planned-GROW path, inverse of :meth:`_recover_rank_loss`:
        a recovered (or newly added) rank enters the mesh mid-pipeline.
        No checkpoint restore is needed — the survivors hold every
        coherent byte — so the grow is pure planned migration: clear
        the joiner's coherence metadata (its buffer is untrusted),
        ``Executor.add_rank`` allocates the shard, ``grow_partition``
        re-splits every canonical data layout with the rank's
        capability weight restored (0 -> w), and a real ``repartition``
        carries the migration bytes into ``comm_log``.  Remaining
        steps' work partitions grow onto the joined mesh the same way."""
        from repro_torch.ft.faults import ElasticPlan, grow_partition

        if rank in live:
            # idempotent: a rank re-registering while already live is
            # an audit event, not a mesh change
            self.recovery_log.append({
                "kind": "rank_join", "rank": rank, "step": step,
                "live": list(live), "migration_bytes": 0, "noop": True,
                "plan": None})
            return
        if not 0 <= rank < self.nproc:
            raise ValueError(
                f"rank {rank} cannot join a mesh of nproc={self.nproc} "
                f"(the executor allocation is fixed at nproc; grow "
                f"beyond it is not supported)")
        t_grow = policy.clock() if hasattr(policy, "clock") else None
        live.append(rank)
        live.sort()
        for arr in self.arrays.values():
            arr.mark_rank_joined(rank)
            self.executor.add_rank(arr, rank)
        w = self._restored_weight(rank)
        remap: Dict[int, int] = {}

        def grown(pid: int) -> int:
            if pid not in remap:
                remap[pid] = grow_partition(self, pid, live, rank,
                                            weight=w)
            return remap[pid]

        migration = 0
        data_parts = dict(policy.data_parts or {})
        for name, pid in data_parts.items():
            tgt = grown(pid)
            plan = self.repartition(self.arrays[name], pid, tgt)
            migration += plan.bytes_total
        if policy.data_parts is not None:
            policy.data_parts.update(
                {name: remap[pid] for name, pid in data_parts.items()})
        for st in steps:
            st["part_id"] = grown(st["part_id"])
        if rebalancer is not None:
            rebalancer.note_mesh_changed()
        self._lost_weights.pop(rank, None)
        self.planner.stats.elastic_grows += 1
        self.recovery_log.append({
            "kind": "rank_join", "rank": rank, "step": step,
            "live": list(live), "migration_bytes": migration,
            "latency_s": ((policy.clock() - t_grow)
                          if t_grow is not None else None),
            "plan": ElasticPlan(len(live) - 1, len(live),
                                (len(live),), migration)})

    # -- measurement-driven rebalancing (ft/rebalance.py) -----------------
    def _apply_rebalance(self, reb, steps: list, next_i: int,
                         live=None) -> None:
        """React to a Rebalancer trigger: rebuild every partition the
        remaining steps (and the rebalancer's ``data_parts`` arrays)
        use with the measured capability weights, migrate the data
        arrays through the ordinary planned ``repartition`` (coherence-
        gated, bytes in ``comm_log``), rewrite the remaining steps'
        part ids, and append the audit record — per-rank timing history
        included — to ``recovery_log``.  ``live`` masks the target
        weights to the current mesh: after an elastic shrink a dead
        rank must get zero weight even though ``target_weights`` hands
        never-measured ranks the mean speed."""
        from repro_torch.ft.rebalance import reweighted_partition

        stats = self.planner.stats
        weights = reb.target_weights(self.nproc)
        if live is not None:
            mask = set(live)
            weights = tuple(w if p in mask else 0.0
                            for p, w in enumerate(weights))
        remap: Dict[int, int] = {}

        def new_pid(old: int) -> int:
            if old not in remap:
                remap[old] = reweighted_partition(self, old, weights)
            return remap[old]

        migration = 0
        if reb.data_parts:
            for name, pid in list(reb.data_parts.items()):
                tgt = new_pid(pid)
                plan = self.repartition(self.arrays[name], pid, tgt)
                migration += plan.bytes_total
                reb.data_parts[name] = tgt
        for st in steps[next_i:]:
            st["part_id"] = new_pid(st["part_id"])
        stats.rebalances += 1
        self.recovery_log.append({
            "kind": "rebalance", "step": next_i - 1,
            "weights": tuple(weights),
            # the per-rank divergence that triggered this decision
            "rank_times": list(reb.history[-reb.patience:]),
            "migration_bytes": migration,
            "parts": dict(remap)})
        reb.note_rebalanced(next_i - 1)

    def log_plan(self, kernel_name: str, plan: CommPlan) -> None:
        self.comm_log.append(
            (kernel_name, plan.bytes_total,
             tuple((ap.array, ap.kind.value, ap.bytes_total)
                   for ap in plan.arrays))
        )

    def plan_only(self, kernel_name, part_id, arrays, uses, defs) -> CommPlan:
        """Plan + commit WITHOUT executing (metadata-only mode — used for
        comm-volume studies at paper scale, where running the kernels is
        unnecessary)."""
        return self.apply_kernel(kernel_name, part_id, kernel=None,
                                 arrays=arrays, uses=uses, defs=defs)

    # -- reductions ---------------------------------------------------------
    def reduce(self, arr: HDArray, op: str, part_id: int):
        """Paper HDArrayReduce: a *planned* kernel — Eqns (1)-(2) derive
        the messages that make each device's reduce-partition region
        coherent (a reduce is a USE of those regions), the executor's
        local phase folds each region, and the ALL_REDUCE combine
        merges the per-device partials.  Ops: sum/prod/max/min.

        Each device folds its own (clipped) partition region, so
        elements covered by several regions of an OVERLAPPING manual
        partition are folded once per owner.  An empty domain yields
        the op's identity for sum/prod and raises ValueError for
        max/min.  On the metadata-only ``"null"`` backend the value is
        None (except the empty-domain identity) while the plan and its
        byte accounting still land in ``comm_log``.
        """
        if op not in REDUCE_OPS:
            raise ValueError(f"unknown reduce op {op!r}; one of {REDUCE_OPS}")
        part = self.parts[part_id]
        per_device = tuple(
            self._clip_region_to_array(part.region(p), arr)
            for p in range(self.nproc)
        )
        log_name = f"__reduce[{op}]_{arr.name}"
        if all(s.is_empty() for s in per_device):
            if op in ("max", "min"):
                raise ValueError(
                    f"reduce({op!r}) over an empty domain: partition "
                    f"{part_id} clips to no elements of {arr.name!r}")
            out = arr.dtype.type(_REDUCE_IDENTITY[op])
            self.log_plan(log_name, CommPlan(log_name, part.part_id, [
                self._reduce_ap(arr, per_device, op)]))
            return out
        # (1)-(2): the reduce USES the identity sections of its work
        # partition.  The plan name is shared across ops (the coherence
        # requirement is op-independent) so the §4.2 cache stays hot;
        # only the log entry carries the op.
        ident = AccessSpec.of(tuple(0 for _ in arr.shape))
        plan = self.planner.plan(f"__reduce_{arr.name}", part, [arr],
                                 {arr.name: ident}, {})
        self.executor.execute_plan(plan, self.arrays)
        self.planner.commit(plan, [arr], part)
        partials = self.executor.reduce_local(arr, per_device, op)
        out = self.executor.reduce_combine(partials, op, arr.dtype)
        logged = CommPlan(log_name, part.part_id,
                          list(plan.arrays)
                          + [self._reduce_ap(arr, per_device, op)],
                          cached=plan.cached)
        self.log_plan(log_name, logged)
        return out

    def _reduce_ap(self, arr: HDArray, per_device, op: str) -> ArrayCommPlan:
        """The ALL_REDUCE leg of a reduce plan: the combine over the
        live per-device partials — (live-1) partial values moved."""
        nlive = sum(1 for s in per_device if not s.is_empty())
        return ArrayCommPlan(
            arr.name, {}, CommKind.ALL_REDUCE,
            max(0, nlive - 1) * arr.itemsize,
            tuple(per_device),
            tuple(SectionSet.empty(arr.ndim) for _ in per_device),
            reduce_op=op)

    # -- repartition (elasticity) --------------------------------------------
    def repartition(self, arr: HDArray, old_part_id: Optional[int],
                    new_part_id: int) -> CommPlan:
        """Move an array's coherent blocks from one partition to another —
        the planner derives the migration messages automatically (the
        paper's 'repartition at any point').

        When ``old_part_id`` is given, the array must be coherent under
        that partition (every element of its regions has an up-to-date
        owner) — migrating an incoherent array would silently move
        stale bytes.  Pass None to skip the check."""
        if old_part_id is not None:
            old = self.parts[old_part_id]
            for p in range(self.nproc):
                missing = self._clip_region_to_array(old.region(p), arr)
                bb = missing.bbox_bounds()
                if bb is None:
                    continue
                for q in arr.valid.overlapping(*bb):
                    missing = missing.subtract(arr.valid[int(q)])
                    if missing.is_empty():
                        break
                if not missing.is_empty():
                    raise ValueError(
                        f"repartition: {arr.name!r} is not coherent under "
                        f"partition {old_part_id} — no device holds an "
                        f"up-to-date copy of {missing} (device {p}'s "
                        f"region)")
        ident = AccessSpec.of(tuple(0 for _ in arr.shape))
        return self.apply_kernel(
            f"__repartition_{arr.name}_{old_part_id}->{new_part_id}",
            new_part_id, kernel=None, arrays=[arr],
            uses={arr.name: ident}, defs={arr.name: ident},
        )

    # -- helpers -------------------------------------------------------------
    def _clip_region_to_array(self, region: Box, arr: HDArray) -> SectionSet:
        if region.is_empty():
            return SectionSet.empty(arr.ndim)
        nd = arr.ndim
        b = region.bounds[:nd]
        # pad missing dims with full extent
        while len(b) < nd:
            b = b + ((0, arr.shape[len(b)]),)
        return SectionSet.of(Box(tuple(b)).clamp(arr.shape))

    def lowered_schedule(self, plan: CommPlan, axis: str = "x"):
        return lower_plan(plan, axis)
