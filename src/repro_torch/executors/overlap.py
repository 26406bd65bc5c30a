"""Overlap-aware schedule — the paper's §4.2 / Fig. 7 optimization.

The serial apply_kernel timeline is

    plan -> execute messages -> run kernel -> commit GDEF (Eqns 3-4)

The paper hides the planning/commit cost by overlapping it with
communication and compute.  :class:`OverlapScheduler` reproduces that
schedule on any executor backend:

* **commit overlap** — the Eqn (3)-(4) GDEF commit touches only
  planner metadata (section sets), never device buffers, so it runs on
  the host thread while the executor moves messages on a comm thread.
* **next-step planning overlap** — in :meth:`pipeline`, step ``i+1``'s
  plan (Eqns 1-2 or a cache probe) is computed while step ``i``'s
  messages are still in flight; only the kernel waits for the data.
* **double-buffered halo** (stencil path) — when every message in the
  plan is a HALO exchange and no def'd array receives data, the kernel
  is split: the interior sweep (the work items whose reads provably
  avoid every incoming section) runs concurrently with the halo
  exchange, and the boundary strips run once the ghost cells have
  landed.  This is the classic overlap of ghost-cell exchange with
  interior compute, and it relies on the paper's work-item model: a
  kernel must compute any sub-region of its assigned region
  independently.

On a card the comm thread's copies run on a CUDA stream of their own:
an executor with ``comm_fence`` (the torch backend) hands the
scheduler a fence on the host thread each time a plan goes to the comm
thread.  The copies wait for everything the host thread had issued by
then (kernel ``i-1`` may define what they move), and the host thread's
kernels issued after the fence is joined wait for the copies.  Interior
sweeps issued before the join run beside the copies on the card.

Safety: the interior split is attempted only when (a) every ArrayComm-
Plan with traffic is classified HALO, (b) no array being def'd receives
messages, and (c) every use clause of an array with traffic is a pure
integer-offset AccessSpec with the identity work-dim mapping.  The
unsafe work items are then computed EXACTLY, by reflecting each
incoming message box through the use offsets (see ``_halo_split``) —
a fixed stencil-radius shrink is not sound when the work partition is
offset from the data-ownership partition.  Anything else falls back to
comm-then-kernel (still with commit overlap), preserving the serial
oracle bit-for-bit.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from repro_torch.core.hdarray import HDArray
    from repro_torch.core.partition import Partition
    from repro_torch.core.planner import CommPlan

    from .base import Executor


def halo_split(plan: "CommPlan", regions: Sequence, uses: Dict,
               defs: Dict):
    """Exact interior/boundary work split for double-buffered halo.

    A work item is *unsafe* (must wait for the exchange) iff one of its
    use-clause reads touches a section some message is about to deliver
    to its device.  The unsafe set is computed exactly, from the plan's
    actual message boxes reflected through the use offsets — NOT from a
    fixed shrink radius: when the work partition is offset from the
    data-ownership partition (the Jacobi interior-region idiom),
    incoming halos reach deeper than the stencil radius, and a
    radius-based shrink would race.

    Preconditions (else None): every ArrayCommPlan with traffic is
    HALO-classified, no def'd array receives messages, and every use
    clause of an array with traffic is a pure integer-offset AccessSpec
    with the identity work-dim mapping and matching rank.

    Returns ``(interior, boundary)`` — each a per-device tuple of Box
    tuples (disjoint sub-regions of that device's work region) — or
    None when the split is not provably safe.  This is shared by the
    host-side :class:`OverlapScheduler` (interior sweeps overlap the
    comm thread) and the fused steps of
    :class:`~repro_torch.executors.torch_exec.TorchExecutor` (the
    interior sweep issued beside the copies, on a forked stream).
    """
    from repro_torch.core.offsets import AccessSpec
    from repro_torch.core.planner import CommKind
    from repro_torch.core.sections import Box, SectionSet

    live = [ap for ap in plan.arrays if ap.messages]
    if not live or any(ap.kind != CommKind.HALO for ap in live):
        return None
    if {ap.array for ap in live} & set(defs):
        return None
    regions = list(regions)
    wnd = regions[0].ndim
    specs = {}
    for ap in live:
        spec = uses.get(ap.array)
        # pure offset clauses with the identity work-dim mapping and
        # matching rank are the only case we can reflect exactly
        if (not isinstance(spec, AccessSpec) or spec.work_dims is not None
                or any(len(off) != wnd for off in spec.offsets)):
            return None
        specs[ap.array] = spec

    nproc = len(regions)
    incoming: List[List[Tuple[Box, Tuple]]] = [[] for _ in range(nproc)]
    for ap in live:
        for (_src, dst), secs in ap.messages.items():
            for box in secs:
                incoming[dst].append((box, specs[ap.array].offsets))

    interior: List[Tuple[Box, ...]] = []
    boundary: List[Tuple[Box, ...]] = []
    for q, region in enumerate(regions):
        if region.is_empty():
            interior.append((region,))
            boundary.append(())
            continue
        rset = SectionSet.of(region)
        unsafe = SectionSet.empty(wnd)
        for box, offsets in incoming[q]:
            for off in offsets:
                # work items w reading `box` under offset o: w+o in box
                bounds = []
                for d, o in enumerate(off):
                    if o == "*":
                        bounds.append(region.bounds[d])
                    else:
                        lo, hi = box.bounds[d]
                        bounds.append((lo - int(o), hi - int(o)))
                unsafe = unsafe.union(SectionSet.of(Box(tuple(bounds))))
        unsafe = unsafe.intersect(rset)
        interior.append(tuple(rset.subtract(unsafe)))
        boundary.append(tuple(unsafe))
    if not any(boundary):
        return None
    return tuple(interior), tuple(boundary)


class OverlapScheduler:
    """Runs one (or a pipeline of) apply_kernel steps with §4.2 overlap."""

    def __init__(self, executor: "Executor", max_workers: int = 1) -> None:
        self.executor = executor
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="hdarray-comm")
        self._fence = getattr(executor, "comm_fence", None)
        # observability for the overlap benchmark
        self.steps_overlapped: int = 0
        self.halo_splits: int = 0

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)

    # -- one step --------------------------------------------------------
    def step(self, plan: "CommPlan", part: "Partition",
             kernel: Optional[Callable], arrays: Sequence["HDArray"],
             arrays_by_name: Dict[str, "HDArray"],
             uses: Dict, defs: Dict, kw: Dict,
             commit: Callable[[], None]) -> None:
        """Execute messages || commit (and, for halo plans, the interior
        kernel sweep), then finish the kernel."""
        comm = self._submit(plan, arrays_by_name)
        try:
            commit()                      # metadata only: overlaps comm
            self.steps_overlapped += 1
            if kernel is None:
                return
            split = self._halo_split(plan, part, uses, defs)
            dnames = tuple(defs)
            if split is None:
                self._join(comm)
                self.executor.run_kernel(kernel, part.regions, arrays,
                                         defs=dnames, **kw)
            else:
                interior_rounds, boundary_rounds = split
                self.halo_splits += 1
                # interior sweeps overlap the halo exchange
                for regions in interior_rounds:
                    self.executor.run_kernel(kernel, regions, arrays,
                                             defs=dnames, **kw)
                self._join(comm)
                for regions in boundary_rounds:
                    self.executor.run_kernel(kernel, regions, arrays,
                                             defs=dnames, **kw)
        finally:
            # surface comm-thread exceptions even on early error paths;
            # whatever the host thread issues next waits for the copies
            self._join(comm)

    # -- pipelined steps -------------------------------------------------
    def pipeline(self, runtime, steps: Sequence[Dict]) -> List["CommPlan"]:
        """Fig. 7 schedule over a program of apply_kernel steps.

        Each step is a dict with keys ``kernel_name``, ``part_id``,
        ``kernel``, ``arrays``, ``uses``, ``defs`` and optional ``kw``.
        Timeline per step i:

            plan(i) -> [messages(i) on comm thread
                        || commit(i); plan(i+1) on host]
                    -> kernel(i)

        plan(i+1) is legal during messages(i) because planning reads
        only GDEF metadata, already advanced by commit(i); kernel(i)
        waits for its data; messages(i+1) start only after kernel(i)
        (they may move sections kernel(i) defines).
        """
        plans: List["CommPlan"] = []
        n = len(steps)
        plan = self._plan_step(runtime, steps[0]) if n else None
        for i in range(n):
            st = steps[i]
            part = runtime.parts[st["part_id"]]
            arrays = st["arrays"]
            comm = self._submit(plan, runtime.arrays)
            try:
                runtime.planner.commit(plan, arrays, part)   # || messages(i)
                next_plan = (self._plan_step(runtime, steps[i + 1])
                             if i + 1 < n else None)          # || messages(i)
                self.steps_overlapped += 1
            finally:
                self._join(comm)
            if st.get("kernel") is not None:
                self.executor.run_kernel(st["kernel"], part.regions, arrays,
                                         defs=tuple(st["defs"]),
                                         **st.get("kw", {}))
            runtime.log_plan(st["kernel_name"], plan)
            plans.append(plan)
            plan = next_plan
        return plans

    @staticmethod
    def _plan_step(runtime, st: Dict) -> "CommPlan":
        return runtime.planner.plan(st["kernel_name"],
                                    runtime.parts[st["part_id"]],
                                    st["arrays"], st["uses"], st["defs"])

    # -- internals -------------------------------------------------------
    def _submit(self, plan: "CommPlan",
                arrays_by_name: Dict[str, "HDArray"]) -> Future:
        """Hand ``plan``'s messages to the comm thread, with a fence
        taken here, on the host thread, when the executor keeps one."""
        fence = (self._fence(plan, arrays_by_name)
                 if self._fence is not None else None)
        return self._pool.submit(self._run_messages, plan, arrays_by_name,
                                 fence)

    def _run_messages(self, plan: "CommPlan",
                      arrays_by_name: Dict[str, "HDArray"], fence):
        # one plan-level dispatch (host backends loop per array); on a
        # card, inside the fence: on the comm stream
        if fence is None:
            self.executor.execute_plan(plan, arrays_by_name)
        else:
            with fence:
                self.executor.execute_plan(plan, arrays_by_name)
        return fence

    @staticmethod
    def _join(comm: Future) -> None:
        """Wait for the comm thread (raising what it raised); on a card,
        order the host thread's next work after the copies."""
        fence = comm.result()
        if fence is not None:
            fence.join()

    def _halo_split(self, plan: "CommPlan", part: "Partition",
                    uses: Dict, defs: Dict):
        """Module-level :func:`halo_split`, reshaped into kernel sweep
        rounds: ``(interior_rounds, boundary_rounds)``, each a list of
        per-device Box lists, or None when the split is unsafe."""
        from repro_torch.core.sections import Box

        split = halo_split(plan, part.regions, uses, defs)
        if split is None:
            return None
        interior, boundary = split
        wnd = part.regions[0].ndim

        def _rounds(per_dev: Sequence[Tuple[Box, ...]]) -> List[List[Box]]:
            empty = Box(tuple((0, 0) for _ in range(wnd)))
            n = max((len(b) for b in per_dev), default=0)
            return [[b[k] if k < len(b) else empty for b in per_dev]
                    for k in range(n)]

        return _rounds(interior), _rounds(boundary)
