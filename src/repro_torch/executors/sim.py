"""SimExecutor — the host-numpy validation backend.

Each device holds a full-size numpy buffer (faithful to the paper's
``HDArrayCreate``, which allocates device buffers of the full
user-array size) and planner messages execute as section copies
between those buffers.  Runs with any number of simulated devices and
is the oracle the test-suite checks every other backend against: a
backend is correct iff it is bit-identical to SimExecutor on the same
program.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base import register_executor
from .kernels import resolve_kernel

if TYPE_CHECKING:
    from repro_torch.core.hdarray import HDArray
    from repro_torch.core.planner import CommKind
    from repro_torch.core.sections import Box, SectionSet

# local reduction / pairwise combine per HDArrayReduce op
REDUCE_FNS = {"sum": np.sum, "prod": np.prod, "max": np.max, "min": np.min}
REDUCE_COMBINE = {"sum": np.add, "prod": np.multiply,
                  "max": np.maximum, "min": np.minimum}


@register_executor("sim")
class SimExecutor:
    """Executes plans over per-device full-size numpy buffers."""

    holds_data = True   # this backend materializes real array bytes
    device_class = "sim"  # kernel-variant resolution key (resolve_kernel)

    def __init__(self, nproc: Optional[int] = None) -> None:
        # nproc is accepted for uniform registry construction; the sim
        # backend sizes everything from the arrays it allocates.
        self.nproc = nproc
        self.buffers: Dict[str, List[np.ndarray]] = {}
        self.bytes_moved: int = 0
        self.messages_executed: int = 0
        self.reduce_elements: int = 0
        # per-rank wall time of the latest kernel sweep (None when the
        # last step ran no kernel, or on backends that can't attribute
        # time per rank) — the heterogeneity signal for the ft
        # Rebalancer and the per-rank StragglerMonitor.
        self.last_rank_times: Optional[Tuple[float, ...]] = None
        # injected per-rank slowdown for heterogeneity experiments:
        # rank -> seconds of extra busy time PER WORK ITEM, so a rank's
        # kernel time scales with its region volume like a real slow
        # device's would.
        self.rank_cost: Dict[int, float] = {}

    def allocate(self, arr: "HDArray") -> None:
        self.buffers[arr.name] = [
            np.zeros(arr.shape, dtype=arr.dtype) for _ in range(arr.nproc)
        ]

    def free(self, arr: "HDArray") -> None:
        self.buffers.pop(arr.name, None)

    def drop_rank(self, arr: "HDArray", rank: int) -> None:
        """Device `rank` died: poison its buffer so any read of the lost
        bytes that slips past the recovery machinery is loud (NaN for
        float arrays) instead of silently stale."""
        bufs = self.buffers.get(arr.name)
        if bufs is None:
            return
        buf = bufs[rank]
        buf[...] = np.nan if np.issubdtype(buf.dtype, np.floating) else 0

    def add_rank(self, arr: "HDArray", rank: int) -> None:
        """Device `rank` (re)joined the mesh: give it a fresh zeroed
        buffer for `arr`.  Whatever it held before (a poisoned pre-loss
        buffer, or nothing) is NOT trusted — the rank gains coherent
        sections only through planned traffic (the grow repartition)."""
        bufs = self.buffers.get(arr.name)
        if bufs is None:
            return
        bufs[rank] = np.zeros(arr.shape, dtype=arr.dtype)

    # -- data movement --------------------------------------------------
    def write(self, arr: "HDArray", data: np.ndarray,
              per_device: Sequence["SectionSet"]) -> None:
        data = np.asarray(data, dtype=arr.dtype)
        assert data.shape == arr.shape, (data.shape, arr.shape)
        bufs = self.buffers[arr.name]
        for p, secs in enumerate(per_device):
            for sl in secs.iter_slices():
                bufs[p][sl] = data[sl]

    def read(self, arr: "HDArray",
             per_device: Sequence["SectionSet"]) -> np.ndarray:
        out = np.zeros(arr.shape, dtype=arr.dtype)
        bufs = self.buffers[arr.name]
        for p, secs in enumerate(per_device):
            for sl in secs.iter_slices():
                out[sl] = bufs[p][sl]
        return out

    def execute_messages(self, arr: "HDArray",
                         messages: Dict[Tuple[int, int], "SectionSet"],
                         kind: Optional["CommKind"] = None) -> None:
        # `kind` (the planner's pattern classification) is unused here:
        # the sim backend executes every pattern as direct section
        # copies.  Collective-aware backends dispatch on it.
        # Iteration goes through the SoA slice view (no Box
        # materialization) — at P=1024 a halo step carries ~2P messages.
        bufs = self.buffers[arr.name]
        itemsize = arr.itemsize
        for (src, dst), secs in messages.items():
            sbuf, dbuf = bufs[src], bufs[dst]
            for sl in secs.iter_slices():
                dbuf[sl] = sbuf[sl]
            self.bytes_moved += secs.volume() * itemsize
            self.messages_executed += len(secs)

    def execute_plan(self, plan, arrays_by_name: Dict[str, "HDArray"]) -> None:
        """Execute every array's messages of a CommPlan.  The default
        is a per-array loop; collective backends override this with one
        fused dispatch for the whole plan."""
        for ap in plan.arrays:
            if ap.messages:
                self.execute_messages(arrays_by_name[ap.array], ap.messages,
                                      kind=ap.kind)

    def execute_step(self, plan, arrays_by_name: Dict[str, "HDArray"],
                     kernel: Optional[Callable], part_regions,
                     arrays: Sequence["HDArray"], uses=None, defs=None,
                     kw=None) -> bool:
        """One whole apply_kernel step: exchange then kernel.  This
        default is the classic two-phase path and returns False ("not
        fused"); backends that trace both into ONE device program
        override it and return True.  ``uses``/``defs`` are the step's
        access clauses — fusing backends need them to compute the
        in-program halo split; the host path only reads the def names."""
        self.last_rank_times = None
        self.execute_plan(plan, arrays_by_name)
        if kernel is not None:
            self.run_kernel(kernel, part_regions, arrays,
                            defs=tuple(defs) if defs is not None else None,
                            **(kw or {}))
        return False

    def capture_cycle(self, cycle, reps: int) -> Optional[Callable]:
        """Whole-pipeline capture hook (see base.py).  Host backends
        keep the per-step oracle schedule: nothing to amortize."""
        return None

    # -- residency hooks (no-ops: sim data already lives on the host) ---
    def sync_host(self, arr: "HDArray") -> None:
        pass

    def sync_device(self, arr: "HDArray") -> None:
        pass

    def run_kernel(self, kernel: Callable, part_regions: Sequence["Box"],
                   arrays: Sequence["HDArray"],
                   defs: Optional[Sequence[str]] = None, **kw) -> None:
        """Run the kernel once per device over its work region.  The
        kernel sees full-size device buffers (OpenCL semantics) and
        either mutates its `def` arrays in place (host kernels) or
        returns ``{name: updated_buffer}`` (pure ``device_kernel``
        convention), which is applied to the mirrors here.  ``defs``
        (the def-clause array names) is bookkeeping for residency-aware
        backends; host-memory backends ignore it."""
        kernel = resolve_kernel(kernel, self.device_class)
        times = [0.0] * len(part_regions)
        for p, region in enumerate(part_regions):
            if region.is_empty():
                continue
            bufs = {a.name: self.buffers[a.name][p] for a in arrays}
            t0 = time.perf_counter()
            res = kernel(region, bufs, **kw)
            if isinstance(res, dict):
                for name, val in res.items():
                    bufs[name][...] = np.asarray(val)
            cost = self.rank_cost.get(p)
            if cost:
                # busy-wait (not sleep) to the modeled duration so the
                # measured time is deterministic at ms scale
                target = t0 + cost * region.volume()
                while time.perf_counter() < target:
                    pass
            times[p] = time.perf_counter() - t0
        self.last_rank_times = tuple(times)

    # -- reductions (HDArrayReduce, local phase + global combine) -------
    def reduce_local(self, arr: "HDArray",
                     per_device: Sequence["SectionSet"], op: str):
        """Per-device reduction over each device's sections.  Devices
        whose section set is empty contribute None (no identity element
        is fabricated — max/min over nothing has none)."""
        f = REDUCE_FNS[op]
        comb = REDUCE_COMBINE[op]
        bufs = self.buffers[arr.name]
        partials: List[Optional[np.generic]] = []
        for p, secs in enumerate(per_device):
            acc = None
            for sl in secs.iter_slices():
                v = f(bufs[p][sl])
                acc = v if acc is None else comb(acc, v)
            self.reduce_elements += secs.volume()
            partials.append(acc)
        return partials

    def reduce_combine(self, partials, op: str, dtype):
        """Sequential left-fold over the live partials (rank order) —
        the deterministic oracle every collective backend must match."""
        comb = REDUCE_COMBINE[op]
        out = None
        for v in partials:
            if v is None:
                continue
            out = v if out is None else comb(out, v)
        return out if out is None else np.dtype(dtype).type(out)
