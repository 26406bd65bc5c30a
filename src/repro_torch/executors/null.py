"""NullExecutor — the metadata-only backend.

Plans are computed and classified, bytes are counted, but no buffer is
ever allocated and no element is ever copied.  This is what lets the
paper-scale communication-volume studies (10240^2 arrays, 32
processes, Table 3) run in milliseconds: the planner's set algebra is
the only work left.

Selected with ``HDArrayRuntime(nproc, backend="null")``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

from .base import register_executor
from .sim import SimExecutor

if TYPE_CHECKING:
    from repro_torch.core.hdarray import HDArray
    from repro_torch.core.planner import CommKind
    from repro_torch.core.sections import SectionSet


@register_executor("null")
class NullExecutor(SimExecutor):
    """Counts plan traffic without holding any data."""

    holds_data = False  # checkpoints carry metadata only, no payload
    device_class = "null"

    def allocate(self, arr: "HDArray") -> None:
        self.buffers[arr.name] = None

    def add_rank(self, arr: "HDArray", rank: int) -> None:
        # metadata-only: a join changes layouts and byte accounting
        # (the grow repartition), never storage
        pass

    def write(self, arr, data, per_device) -> None:
        pass

    def read(self, arr, per_device):
        raise RuntimeError("NullExecutor holds no data (metadata-only mode)")

    def execute_messages(self, arr: "HDArray",
                         messages: Dict[Tuple[int, int], "SectionSet"],
                         kind: Optional["CommKind"] = None) -> None:
        # one batched volume per SectionSet — no per-box Python loop
        itemsize = arr.itemsize
        for secs in messages.values():
            self.bytes_moved += secs.volume() * itemsize
            self.messages_executed += len(secs)

    def run_kernel(self, kernel, part_regions, arrays, defs=None,
                   **kw) -> None:
        raise RuntimeError("NullExecutor cannot run kernels")

    def reduce_local(self, arr: "HDArray", per_device, op: str):
        """Metadata-only local phase: account the elements each device
        would fold (the reduce's flop count) and contribute no value."""
        for secs in per_device:
            self.reduce_elements += secs.volume()
        return [None] * len(per_device)

    def reduce_combine(self, partials, op: str, dtype):
        # no data: the combined value is unknowable; the runtime still
        # logged the planned coherence traffic + ALL_REDUCE byte count
        return None
