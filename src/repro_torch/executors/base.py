"""The Executor protocol: what a backend must do for the HDArray
runtime, and the registry that makes backends selectable by name.

An executor owns the per-device storage of every HDArray and performs
the runtime actions the paper's library issues (§5):

* ``allocate`` / ``free`` — device buffers of the full user-array size
  (paper ``HDArrayCreate``: every device can hold any section),
* ``write`` / ``read`` — controller <-> device section transfers
  (``HDArrayWrite`` / ``HDArrayRead``),
* ``execute_messages`` — move a planner-classified message set between
  devices.  The optional ``kind`` is the planner's CommKind pattern,
* ``execute_plan`` — move ALL arrays' message sets of one CommPlan
  (the default implementation is the per-array loop),
* ``execute_step`` — run one WHOLE apply_kernel step (the plan's data
  movement AND the kernel).  Returns True when the backend fused both
  into one device program (counted as ``PlannerStats.fused_steps``),
  False for the classic two-phase path,
* ``capture_cycle`` — offer a steady-state pipeline cycle for
  whole-program capture; returns a zero-argument runner, or None when
  the backend cannot capture,
* ``sync_host`` / ``sync_device`` — the residency hooks: make the host
  mirrors (resp. the device-resident copy) of an array coherent.
  No-ops on host-memory backends; on a resident backend every
  full-buffer host↔device crossing is counted (``h2d_transfers`` /
  ``d2h_transfers``),
* ``run_kernel`` — invoke the user kernel once per device over its work
  region, against full-size device buffers (OpenCL semantics).  A
  kernel marked by :func:`repro_torch.executors.kernels.device_kernel`
  returns ``{name: updated_buffer}``, which a resident backend runs on
  the device,
* ``reduce_local`` / ``reduce_combine`` — the two phases of
  ``HDArrayReduce``: per-device reduction of each device's (planner-
  coherent) sections, then the global combine over the partials,
* ``drop_rank`` — the fault hook: rank p's buffer for an array is gone;
  backends poison it so nothing can silently read stale bytes,
* ``add_rank`` — the inverse: rank p (re)joined and gets a fresh, empty
  buffer that only planned traffic may fill.

``holds_data`` (class attribute) says whether the backend materializes
real array bytes.  ``device_class`` names the architecture kernels run
on — the key :func:`repro_torch.executors.kernels.resolve_kernel` uses
to pick a per-architecture ``@kernel.variant``.

Every executor keeps ``bytes_moved`` (payload bytes of executed
messages), ``messages_executed`` (one per transferred box) and
``reduce_elements`` (elements folded by local reductions).
``last_rank_times`` exposes the per-rank wall time of the latest kernel
sweep when the backend can attribute it (sim; None elsewhere).
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Callable, Dict, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

if TYPE_CHECKING:
    import numpy as np

    from repro_torch.core.hdarray import HDArray
    from repro_torch.core.planner import CommKind, CommPlan
    from repro_torch.core.sections import Box, SectionSet


@runtime_checkable
class Executor(Protocol):
    """Structural protocol every backend implements (duck-typed: any
    object with these members works, registration is optional)."""

    bytes_moved: int
    messages_executed: int
    reduce_elements: int
    holds_data: bool
    device_class: str
    last_rank_times: Optional[Tuple[float, ...]]

    def allocate(self, arr: "HDArray") -> None: ...

    def drop_rank(self, arr: "HDArray", rank: int) -> None: ...

    def add_rank(self, arr: "HDArray", rank: int) -> None: ...

    def free(self, arr: "HDArray") -> None: ...

    def write(self, arr: "HDArray", data: "np.ndarray",
              per_device: Sequence["SectionSet"]) -> None: ...

    def read(self, arr: "HDArray",
             per_device: Sequence["SectionSet"]) -> "np.ndarray": ...

    def execute_messages(
        self, arr: "HDArray",
        messages: Dict[Tuple[int, int], "SectionSet"],
        kind: Optional["CommKind"] = None,
    ) -> None: ...

    def execute_plan(self, plan: "CommPlan",
                     arrays_by_name: Dict[str, "HDArray"]) -> None: ...

    def execute_step(self, plan: "CommPlan",
                     arrays_by_name: Dict[str, "HDArray"],
                     kernel: Optional[Callable],
                     part_regions: Sequence["Box"],
                     arrays: Sequence["HDArray"],
                     uses: Optional[Dict] = None,
                     defs: Optional[Dict] = None,
                     kw: Optional[Dict] = None) -> bool: ...

    def capture_cycle(self, cycle: Sequence[Dict],
                      reps: int) -> Optional[Callable[[], None]]: ...

    def sync_host(self, arr: "HDArray") -> None: ...

    def sync_device(self, arr: "HDArray") -> None: ...

    def run_kernel(self, kernel: Callable, part_regions: Sequence["Box"],
                   arrays: Sequence["HDArray"],
                   defs: Optional[Sequence[str]] = None, **kw) -> None: ...

    def reduce_local(self, arr: "HDArray",
                     per_device: Sequence["SectionSet"],
                     op: str) -> Sequence[Optional[object]]: ...

    def reduce_combine(self, partials: Sequence[Optional[object]],
                       op: str, dtype) -> Optional[object]: ...


_REGISTRY: Dict[str, type] = {}


def register_executor(name: str):
    """Class decorator: make a backend constructible by name."""

    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        return cls

    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_executor(backend: str, nproc: Optional[int] = None, **kw) -> "Executor":
    """Instantiate a registered backend (``sim`` / ``null`` / ``torch``)."""
    try:
        cls = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown executor backend {backend!r}; "
            f"available: {available_backends()}") from None
    return cls(nproc=nproc, **kw)
