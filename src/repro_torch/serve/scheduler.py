"""Priority + deadline admission queue for the serving cluster.

Replaces the engine's bounded FIFO at the cluster level: requests wait
here (not in a per-replica queue) until the router can place them on a
replica with a free slot.  Ordering is

  1. higher ``priority`` first,
  2. earlier ``deadline_tick`` first (``None`` sorts last),
  3. earlier arrival (``seq``) first — the deterministic tie-break.

Cancellation is tombstone-based so it is O(1) and safe against the
heap: a cancelled entry stays in the heap but is skipped (and its
tombstone dropped) when it surfaces.  Deadlines are in units of pool
*ticks* (one ``ReplicaPool.step`` = one tick), not wall-clock, so
scheduling decisions replay deterministically.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import List, Optional, Set, Tuple


@dataclasses.dataclass(frozen=True)
class QueuedRequest:
    """One admission-queue entry (the pool holds prompt/result state)."""
    rid: int
    priority: int = 0
    deadline_tick: Optional[int] = None


class PriorityScheduler:
    """Admission queue with priority, deadlines, and cancellation.

    ``push`` enqueues; ``pop`` returns the best admissible request id
    (dropping expired entries into ``expired``); ``cancel`` removes a
    pending entry.  ``max_pending`` bounds the queue — pushing beyond
    it raises ``QueueFull`` (the cluster analogue of the engine's
    :class:`~repro_torch.serve.engine.SlotsExhausted`).
    """

    def __init__(self, max_pending: int = 0):
        self.max_pending = int(max_pending)   # 0 => unbounded
        self._heap: List[Tuple[Tuple[float, float, int], int]] = []
        self._cancelled: Set[int] = set()
        self._seq = 0
        self.expired: List[int] = []

    def __len__(self) -> int:
        return len(self._heap) - len(self._cancelled)

    def push(self, req: QueuedRequest) -> None:
        if self.max_pending and len(self) >= self.max_pending:
            raise QueueFull(
                f"admission queue full ({len(self)}/{self.max_pending})")
        dl = math.inf if req.deadline_tick is None else float(req.deadline_tick)
        key = (-float(req.priority), dl, self._seq)
        self._seq += 1
        heapq.heappush(self._heap, (key, req.rid, req.deadline_tick))

    def pop(self, now_tick: int) -> Optional[int]:
        """Best admissible request id, or None if the queue is empty.
        Entries whose deadline passed are dropped and recorded in
        :attr:`expired` (the pool turns those into request failures)."""
        while self._heap:
            _key, rid, deadline = heapq.heappop(self._heap)
            if rid in self._cancelled:
                self._cancelled.discard(rid)
                continue
            if deadline is not None and now_tick > deadline:
                self.expired.append(rid)
                continue
            return rid
        return None

    def cancel(self, rid: int) -> bool:
        """Tombstone a pending entry.  True if it was pending."""
        if any(e[1] == rid and e[1] not in self._cancelled
               for e in self._heap):
            self._cancelled.add(rid)
            return True
        return False


class QueueFull(RuntimeError):
    """Cluster admission queue is at ``max_pending``."""
