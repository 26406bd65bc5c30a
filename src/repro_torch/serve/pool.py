"""ReplicaPool: the serving-cluster brain over the HDArray runtime
(the port of the reference's ``repro/serve/pool.py``).

Runs N :class:`~repro_torch.serve.engine.RecoveryEngine` replicas (each one
an HDArray-partitioned slot engine spread over `instances` serving
ranks), and hides replica choice, queueing, and failover behind one
submit/step/result API — the EngineCL-style usability argument applied
to serving: the caller never names a device, a replica, or a recovery
action.

Per ``step()`` (one logical *tick*):

  1. **membership** — every instance either heartbeats or misses; the
     :class:`~repro_torch.serve.membership.Membership` state machine turns
     miss streaks into ``dead`` events (pool reacts with the planned
     shrink ``fail_instance``: KV migrates to survivors and the
     checkpointed window replays, so in-flight token streams stay
     bit-identical) and beat streaks from a dead rank into ``join``
     events (planned grow ``rejoin_instance``).  No caller
     involvement.
  2. **dispatch** — the :class:`PriorityScheduler` yields admissible
     requests (priority desc, deadline asc, arrival asc; expired ones
     are failed); the :class:`Router` policy places each on a replica
     with a free slot; the engine prefills (prefix_reuse turns router
     locality into skipped prefill work).
  3. **decode** — each replica with live slots runs one decode step;
     per-replica wall times feed the pool's
     :class:`~repro_torch.ft.faults.StragglerMonitor` (replica index = rank),
     whose flags the load-aware router reads.
  4. **harvest** — requests that reached ``max_new`` tokens finish and
     free their slot; per-request metrics land in
     :class:`~repro_torch.serve.metrics.ServeMetrics`.

Determinism: routing, scheduling, membership, and failover all run on
logical ticks and deterministic tie-breaks; with greedy sampling the
per-request token stream is the same regardless of policy, replica
count, or an injected instance failure (gated in
``tests/test_torch_serve_cluster.py``).

Every replica serves the same ``params``: the same tensors, so the
weights sit on the card once however many replicas run.  On a card the
clock is read after ``torch.cuda.synchronize()``, so TTFT and
per-token latencies count the device work, not its launch.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.ft.faults import StragglerMonitor

from .engine import RecoveryEngine, ServeConfig, _sync
from .membership import Membership, MembershipConfig
from .metrics import (CANCELLED, DONE, EXPIRED, QUEUED, RUNNING,
                      RequestMetrics, ServeMetrics)
from .router import ReplicaView, Router, get_router
from .scheduler import PriorityScheduler, QueuedRequest


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    priority: int
    deadline_tick: Optional[int]
    status: str = QUEUED
    replica: Optional[int] = None
    slot: Optional[int] = None
    generated: int = 0
    result: Optional[List[int]] = None


class ReplicaPool:
    """N failure-aware replicas + router + scheduler + membership +
    metrics.  See the module docstring for the per-tick pipeline."""

    def __init__(self, bundle, params, scfg: ServeConfig,
                 replicas: int = 2, instances: int = 2,
                 policy="round_robin", backend: str = "torch",
                 seed: int = 0, checkpoint_interval: int = 2,
                 membership: Optional[MembershipConfig] = None,
                 max_pending: int = 0,
                 straggler_threshold: float = 2.0,
                 straggler_cooldown: int = 8,
                 ckpt_dir: Optional[str] = None):
        """``ckpt_dir`` (default: a temporary directory per replica)
        holds replica r's checkpoints under ``replica<r>/``."""
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        self.scfg = scfg
        self.replicas: Dict[int, RecoveryEngine] = {
            rid: RecoveryEngine(
                bundle, params, scfg, instances=instances, seed=seed,
                checkpoint_interval=checkpoint_interval,
                ckpt_dir=(None if ckpt_dir is None
                          else os.path.join(ckpt_dir, f"replica{rid}")),
                backend=backend)
            for rid in range(replicas)}
        self.instances = instances
        self.router: Router = get_router(policy)
        self.scheduler = PriorityScheduler(max_pending)
        self.membership = Membership(
            {rid: range(instances) for rid in range(replicas)},
            membership or MembershipConfig())
        self.metrics = ServeMetrics()
        self.monitor = StragglerMonitor(threshold=straggler_threshold,
                                        warmup=3)
        self.straggler_cooldown = straggler_cooldown
        self._straggler_until: Dict[int, int] = {}
        self._requests: Dict[int, _Request] = {}
        self._by_slot: Dict[tuple, int] = {}
        self._prefilled: set = set()   # replicas that admitted this tick
        self._next_rid = 0
        self.tick = 0
        # heartbeat suppression: (replica, rank) -> first tick at which
        # the instance beats again (the injected-failure harness; a
        # real deployment feeds tick() from actual heartbeats)
        self._down_until: Dict[tuple, int] = {}

    # -- client API ----------------------------------------------------
    def submit(self, prompt_tokens: Sequence[int], max_new: int,
               priority: int = 0,
               deadline_in: Optional[int] = None) -> int:
        """Enqueue a request for `max_new` generated tokens; returns a
        request id.  `deadline_in` (ticks from now): if the request is
        still queued after that many ticks it expires instead of
        running."""
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        rid = self._next_rid
        self._next_rid += 1
        prompt = np.asarray(prompt_tokens)
        deadline = None if deadline_in is None else self.tick + deadline_in
        self._requests[rid] = _Request(rid, prompt, int(max_new),
                                       int(priority), deadline)
        self.scheduler.push(QueuedRequest(rid, int(priority), deadline))
        self.metrics.new_request(RequestMetrics(
            rid=rid, priority=int(priority), prompt_len=len(prompt),
            submitted_tick=self.tick, submitted_s=time.perf_counter(),
            deadline_tick=deadline))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request mid-queue (removed before it runs) or
        mid-decode (slot freed; partial tokens kept in the result).
        True unless the request already reached a terminal state."""
        req = self._requests[rid]
        if req.status == QUEUED and self.scheduler.cancel(rid):
            req.status = CANCELLED
            self.metrics.requests[rid].status = CANCELLED
            return True
        if req.status == RUNNING:
            toks = self.replicas[req.replica].cancel(req.slot)
            del self._by_slot[(req.replica, req.slot)]
            req.result = toks
            req.status = CANCELLED
            rec = self.metrics.requests[rid]
            rec.status = CANCELLED
            rec.finished_tick = self.tick
            return True
        return False

    def result(self, rid: int) -> Optional[List[int]]:
        """Full token list (prompt + generated) once DONE; partial
        tokens for a mid-decode cancel; None while queued/running."""
        return self._requests[rid].result

    def status(self, rid: int) -> str:
        return self._requests[rid].status

    @property
    def pending(self) -> int:
        return sum(r.status in (QUEUED, RUNNING)
                   for r in self._requests.values())

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        """Step until every submitted request reaches a terminal
        state; returns {rid: tokens} for the DONE ones."""
        t = 0
        while self.pending and t < max_ticks:
            self.step()
            t += 1
        if self.pending:
            raise RuntimeError(f"{self.pending} requests still pending "
                               f"after {max_ticks} ticks")
        return {rid: r.result for rid, r in self._requests.items()
                if r.status == DONE}

    # -- failure injection (test/benchmark harness) --------------------
    def inject_instance_failure(self, replica: int, rank: int,
                                down_for: int) -> None:
        """Suppress (replica, rank)'s heartbeats for `down_for` ticks —
        membership will confirm it dead and fail it over, then see the
        heartbeats resume and rejoin it.  The caller never touches
        fail_instance/rejoin_instance."""
        self._down_until[(replica, rank)] = self.tick + down_for

    # -- the tick ------------------------------------------------------
    def step(self) -> Dict[int, Dict[int, int]]:
        """One cluster tick; returns {replica: {slot: token}} for the
        decode steps that ran."""
        self.tick += 1
        self._prefilled: set = set()
        self._membership_tick()
        self._dispatch()
        out = self._decode_all()
        self._harvest()
        self.metrics.stopped_s = time.perf_counter()
        return out

    # -- phase 1: membership -------------------------------------------
    def _membership_tick(self) -> None:
        for rid, eng in self.replicas.items():
            beats = {r for r in range(self.instances)
                     if self._down_until.get((rid, r), 0) <= self.tick}
            for ev in self.membership.tick(rid, beats, self.tick):
                self._apply_membership_event(rid, eng, ev)

    def _apply_membership_event(self, rid: int, eng: RecoveryEngine,
                                ev) -> None:
        if ev.kind == "dead":
            if ev.rank not in eng.live:
                return
            if len(eng.live) <= 1:
                # never shrink away the last live instance — stay
                # degraded-but-up and wait for heartbeats to resume
                self.metrics.note_event(kind="quarantine_skipped",
                                        replica=rid, rank=ev.rank,
                                        tick=self.tick)
                return
            t0 = time.perf_counter()
            eng.fail_instance(ev.rank)
            rec = eng.recovery_log[-1]
            self.metrics.note_event(
                kind="dead", replica=rid, rank=ev.rank, tick=self.tick,
                latency_s=time.perf_counter() - t0,
                migration_bytes=rec["migration_bytes"],
                steps_replayed=rec["steps_replayed"],
                live=list(eng.live))
        elif ev.kind == "join":
            if ev.rank in eng.live:
                return
            t0 = time.perf_counter()
            eng.rejoin_instance(ev.rank)
            rec = eng.recovery_log[-1]
            self.metrics.note_event(
                kind="join", replica=rid, rank=ev.rank, tick=self.tick,
                latency_s=time.perf_counter() - t0,
                migration_bytes=rec["migration_bytes"],
                live=list(eng.live))
        else:
            self.metrics.note_event(kind=ev.kind, replica=rid,
                                    rank=ev.rank, tick=self.tick)

    # -- phase 2: dispatch ---------------------------------------------
    def _free_slots(self, rid: int) -> int:
        return int((~self.replicas[rid].engine.slot_live).sum())

    def _view(self, rid: int) -> ReplicaView:
        eng = self.replicas[rid].engine
        return ReplicaView(
            replica_id=rid,
            free_slots=self._free_slots(rid),
            outstanding=int(eng.slot_live.sum()) + len(eng.queue),
            step_ewma=self.monitor.rank_ewma.get(rid, 0.0),
            straggler=self.tick <= self._straggler_until.get(rid, -1))

    def _dispatch(self) -> None:
        while True:
            candidates = [self._view(rid) for rid in self.replicas
                          if self._free_slots(rid) > 0]
            self._drain_expired()
            if not candidates:
                break
            rid = self.scheduler.pop(self.tick)
            self._drain_expired()
            if rid is None:
                break
            req = self._requests[rid]
            target = self.router.choose(req.prompt, candidates)
            self._admit(rid, req, target)

    def _drain_expired(self) -> None:
        for rid in self.scheduler.expired:
            req = self._requests[rid]
            req.status = EXPIRED
            rec = self.metrics.requests[rid]
            rec.status = EXPIRED
            rec.finished_tick = self.tick
        self.scheduler.expired.clear()

    def _admit(self, rid: int, req: _Request, target: int) -> None:
        eng = self.replicas[target]
        reused0 = eng.engine.prefix_tokens_reused
        t0 = time.perf_counter()
        slot = eng.add_request(req.prompt, priority=req.priority)
        _sync(eng.engine.device)
        now = time.perf_counter()
        req.status = RUNNING
        req.replica, req.slot = target, slot
        req.generated = 1              # prefill emits the first token
        self._by_slot[(target, slot)] = rid
        self._prefilled.add(target)
        self.router.note_admitted(target, req.prompt)
        rec = self.metrics.requests[rid]
        rec.status = RUNNING
        rec.replica, rec.slot = target, slot
        rec.admitted_tick = self.tick
        rec.queue_wait_ticks = self.tick - rec.submitted_tick
        rec.queue_wait_s = t0 - rec.submitted_s
        rec.ttft_s = now - rec.submitted_s
        rec.tokens_generated = 1
        rec.prefix_hit_len = eng.engine.prefix_tokens_reused - reused0

    # -- phase 3: decode -----------------------------------------------
    def _decode_all(self) -> Dict[int, Dict[int, int]]:
        out: Dict[int, Dict[int, int]] = {}
        times = [0.0] * len(self.replicas)
        for rid, eng in self.replicas.items():
            if not eng.engine.slot_live.any():
                continue
            t0 = time.perf_counter()
            toks = eng.step()
            _sync(eng.engine.device)
            dt = time.perf_counter() - t0
            # injected per-instance slowdowns ride along so tests and
            # benchmarks exercise the straggler path deterministically
            times[rid] = max(dt, eng.last_step_time)
            out[rid] = toks
            for slot, tok in toks.items():
                req = self._requests[self._by_slot[(rid, slot)]]
                req.generated += 1
                rec = self.metrics.requests[req.rid]
                rec.tokens_generated += 1
                rec.token_latencies_s.append(times[rid])
        # prefill ticks carry compile + prompt-length wall time, which
        # is not a decode-speed signal (TTFT tracks it per request) —
        # feed the straggler monitor steady-state decode times only
        obs = [0.0 if rid in self._prefilled else t
               for rid, t in enumerate(times)]
        if any(t > 0 for t in obs):
            n0 = len(self.monitor.events)
            self.monitor.observe(self.tick, max(obs), rank_times=obs)
            for ev in self.monitor.events[n0:]:
                if ev.rank is not None:
                    self._straggler_until[ev.rank] = (
                        self.tick + self.straggler_cooldown)
                    self.metrics.note_event(kind="straggler",
                                            replica=ev.rank,
                                            tick=self.tick,
                                            duration_s=ev.duration,
                                            baseline_s=ev.ewma)
        return out

    # -- phase 4: harvest ----------------------------------------------
    def _harvest(self) -> None:
        for (rid, slot), req_id in list(self._by_slot.items()):
            req = self._requests[req_id]
            if req.generated < req.max_new:
                continue
            toks = self.replicas[rid].finish(slot)
            del self._by_slot[(rid, slot)]
            req.result = toks
            req.status = DONE
            rec = self.metrics.requests[req_id]
            rec.status = DONE
            rec.finished_tick = self.tick

    # -- observability --------------------------------------------------
    def replica_stats(self) -> Dict[int, Dict[str, Any]]:
        out: Dict[int, Dict[str, Any]] = {}
        for rid, eng in self.replicas.items():
            e = eng.engine
            out[rid] = {
                "prefill_tokens_computed": e.prefill_tokens_computed,
                "prefix_hits": e.prefix_hits,
                "prefix_tokens_reused": e.prefix_tokens_reused,
                "live_instances": list(eng.live),
                "elastic_shrinks": eng.rt.planner.stats.elastic_shrinks,
                "elastic_grows": eng.rt.planner.stats.elastic_grows,
                "rank_steps_recorded":
                    len(eng.rt.planner.stats.rank_step_times),
            }
        return out

    def export_metrics(self) -> Dict[str, Any]:
        return self.metrics.export(self.replica_stats())

    def save_metrics(self, path: str) -> None:
        self.metrics.save(path, self.replica_stats())
