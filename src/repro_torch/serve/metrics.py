"""Per-request serving observability.

One :class:`RequestMetrics` record per request tracks the full
lifecycle: submit -> (queue wait) -> admit/prefill (TTFT: the first
token is produced by the prefill itself) -> per-token decode latencies
-> finish / cancel / expiry.  Cluster-level events (instance failures,
rejoins, the migration bytes they moved, straggler flags) land in
:attr:`ServeMetrics.events`.

``export()`` returns one JSON-ready dict: the raw request records plus
derived aggregates (throughput, p50/p99 TTFT and token latency, queue
waits, prefill-work counters per replica).  ``save(path)`` writes it.
Wall-clock fields are observability only — scheduling and routing run
on logical ticks, so none of the determinism gates read them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

QUEUED, RUNNING = "queued", "running"
DONE, CANCELLED, EXPIRED = "done", "cancelled", "expired"


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    priority: int
    prompt_len: int
    submitted_tick: int
    submitted_s: float
    status: str = QUEUED
    replica: Optional[int] = None
    slot: Optional[int] = None
    admitted_tick: Optional[int] = None
    finished_tick: Optional[int] = None
    queue_wait_ticks: Optional[int] = None
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    token_latencies_s: List[float] = dataclasses.field(default_factory=list)
    tokens_generated: int = 0
    prefix_hit_len: int = 0
    deadline_tick: Optional[int] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank-with-interpolation percentile; None when empty."""
    if not values:
        return None
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1 - frac) + xs[hi] * frac)


class ServeMetrics:
    """Cluster-wide collector owned by the :class:`ReplicaPool`."""

    def __init__(self):
        self.requests: Dict[int, RequestMetrics] = {}
        self.events: List[Dict[str, Any]] = []
        self.started_s: Optional[float] = None
        self.stopped_s: Optional[float] = None

    def new_request(self, rec: RequestMetrics) -> None:
        self.requests[rec.rid] = rec
        if self.started_s is None:
            self.started_s = rec.submitted_s

    def note_event(self, **fields: Any) -> None:
        self.events.append(dict(fields))

    # ------------------------------------------------------------------
    def export(self, replica_stats: Optional[Dict[int, Dict[str, int]]]
               = None) -> Dict[str, Any]:
        recs = [r for r in self.requests.values()]
        done = [r for r in recs if r.status == DONE]
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        tls = [t for r in done for t in r.token_latencies_s]
        waits = [r.queue_wait_s for r in done if r.queue_wait_s is not None]
        tokens = sum(r.tokens_generated for r in done)
        span = ((self.stopped_s - self.started_s)
                if self.started_s is not None and self.stopped_s is not None
                else None)
        failovers = [e for e in self.events if e.get("kind") == "dead"]
        rejoins = [e for e in self.events if e.get("kind") == "join"]
        return {
            "requests": [r.as_dict() for r in recs],
            "counts": {
                "submitted": len(recs),
                "done": len(done),
                "cancelled": sum(r.status == CANCELLED for r in recs),
                "expired": sum(r.status == EXPIRED for r in recs),
            },
            "tokens_generated": tokens,
            "throughput_tok_s": (tokens / span if span else None),
            "ttft_s": {"p50": percentile(ttfts, 0.50),
                       "p99": percentile(ttfts, 0.99)},
            "token_latency_s": {"p50": percentile(tls, 0.50),
                                "p99": percentile(tls, 0.99)},
            "queue_wait_s": {"p50": percentile(waits, 0.50),
                             "p99": percentile(waits, 0.99)},
            "replicas": replica_stats or {},
            "events": self.events,
            "failover": {
                "instance_losses": len(failovers),
                "instance_joins": len(rejoins),
                "recovery_latency_s": [e.get("latency_s")
                                       for e in failovers],
                "migration_bytes": sum(e.get("migration_bytes", 0)
                                       for e in self.events),
            },
        }

    def save(self, path: str,
             replica_stats: Optional[Dict[int, Dict[str, int]]]
             = None) -> None:
        with open(path, "w") as f:
            json.dump(self.export(replica_stats), f, indent=2,
                      default=float)
            f.write("\n")
