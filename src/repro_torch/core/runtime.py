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

Not ported yet (each raises NotImplementedError and is listed in
ROADMAP.md): the §4.2 comm/compute-overlap schedule (``overlap=True``,
``executors/overlap.py``), and fault recovery and rebalancing in
``run_pipeline`` (``recovery=`` / ``rebalance=``, ``ft/`` and
``ckpt/``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.executors import DeviceProfileRegistry, make_executor

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
        defaults to the registry's capability-proportional weights."""
        if overlap:
            raise NotImplementedError(
                "overlap=True is not ported yet: the §4.2 overlap "
                "schedule (executors/overlap.py) is queued in ROADMAP.md")
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
        self.arrays: Dict[str, HDArray] = {}
        self.comm_log: list = []     # [(kernel, CommPlan bytes, kinds)]

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
        **kw,
    ) -> CommPlan:
        """Paper Fig. 3: plan comm (Eqns 1-2) -> move data -> run kernel
        -> commit GDEF updates (Eqns 3-4)."""
        part = self.parts[part_id]
        plan = self.planner.plan(kernel_name, part, arrays, uses, defs)
        stats = self.planner.stats
        # ONE runtime->executor call for the whole step: a fusing
        # backend runs exchange + kernel as a single device program
        # (True); the classic two-phase path returns False
        fused = self.executor.execute_step(
            plan, self.arrays, kernel, part.regions, arrays,
            uses=uses, defs=defs, kw=kw)
        self.planner.commit(plan, arrays, part)
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
        """Run a program of apply_kernel steps in order.  Each step:
        dict(kernel_name=, part_id=, kernel=, arrays=, uses=, defs=,
        kw={}).  Per-rank kernel times, where the executor measures
        them, land in ``PlannerStats.rank_step_times``."""
        if recovery is not None or rebalance is not None:
            raise NotImplementedError(
                "run_pipeline(recovery=, rebalance=) is not ported yet: "
                "fault recovery and rebalancing (ft/, ckpt/) are queued "
                "in ROADMAP.md")
        stats = self.planner.stats
        plans = []
        for i, st in enumerate(steps):
            plans.append(self.apply_kernel(
                st["kernel_name"], st["part_id"], st["kernel"],
                st["arrays"], st["uses"], st["defs"], **st.get("kw", {})))
            rank_times = getattr(self.executor, "last_rank_times", None)
            if rank_times is not None:
                stats.note_rank_times(i, rank_times)
        return plans

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
