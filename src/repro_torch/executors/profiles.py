"""Per-rank device capability profiles -> default partition weights.

The paper distributes work across *heterogeneous* devices in a process;
EngineCL/HaoCL-style runtimes drive that from a per-device capability
model.  A :class:`DeviceProfile` declares (or records, once measured)
one rank's device class and relative throughput; a
:class:`DeviceProfileRegistry` holds one per rank and turns them into
the normalized weight vector the weighted ``Partition`` factories
consume.  ``HDArrayRuntime(nproc, profiles=...)`` uses the registry's
weights as the default for every partition it creates, so declaring
"rank 0 is half as fast" reshapes every ROW/COL/BLOCK split in the
program without touching call sites.

Profiles come from two places:

* **declared** — :meth:`DeviceProfileRegistry.declare` with known
  flops/bandwidth figures (static heterogeneity: a CPU rank among
  GPUs);
* **measured** — :meth:`DeviceProfileRegistry.from_step_times` from
  observed per-rank kernel timings (the signal the ft Rebalancer uses
  mid-pipeline; here it seeds the *initial* weights instead).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class DeviceProfile:
    """One rank's device capability: `flops` is relative compute
    throughput (any consistent unit — only ratios matter), `bandwidth`
    relative memory/link bandwidth (recorded for cost models; weights
    derive from flops)."""

    rank: int
    device_class: str = "cpu"
    flops: float = 1.0
    bandwidth: float = 1.0


class DeviceProfileRegistry:
    """Per-rank profiles for an nproc-wide mesh; undeclared ranks get a
    uniform default profile."""

    def __init__(self, nproc: int) -> None:
        if nproc <= 0:
            raise ValueError(f"nproc must be positive: {nproc}")
        self.nproc = int(nproc)
        self._profiles: Dict[int, DeviceProfile] = {}

    def declare(self, rank: int, device_class: str = "cpu",
                flops: float = 1.0, bandwidth: float = 1.0) -> DeviceProfile:
        if not (0 <= rank < self.nproc):
            raise ValueError(f"rank {rank} out of range for nproc={self.nproc}")
        if flops <= 0:
            raise ValueError(f"flops must be positive: {flops}")
        prof = DeviceProfile(rank, device_class, float(flops), float(bandwidth))
        self._profiles[rank] = prof
        return prof

    def profile(self, rank: int) -> DeviceProfile:
        return self._profiles.get(rank, DeviceProfile(rank))

    def weights(self) -> Tuple[float, ...]:
        """Normalized (sum == 1) per-rank weights proportional to
        declared flops — the default weight vector for weighted
        partitions."""
        flops = [self.profile(p).flops for p in range(self.nproc)]
        total = sum(flops)
        return tuple(f / total for f in flops)

    @classmethod
    def from_step_times(cls, rank_times: Sequence[float],
                        volumes: Optional[Sequence[int]] = None,
                        device_class: str = "cpu") -> "DeviceProfileRegistry":
        """Build a measured registry from per-rank step timings: rank
        p's throughput is ``volumes[p] / rank_times[p]`` (work items
        per second; `volumes` defaults to equal work, i.e. flops
        proportional to 1/time).  Ranks with no measurement (time <= 0)
        get the mean observed throughput."""
        n = len(rank_times)
        reg = cls(n)
        vols = list(volumes) if volumes is not None else [1] * n
        if len(vols) != n:
            raise ValueError(f"{len(vols)} volumes for {n} rank times")
        speeds = [vols[p] / rank_times[p] if rank_times[p] > 0 else None
                  for p in range(n)]
        observed = [s for s in speeds if s is not None]
        fill = (sum(observed) / len(observed)) if observed else 1.0
        for p, s in enumerate(speeds):
            reg.declare(p, device_class=device_class,
                        flops=s if s is not None else fill)
        return reg
