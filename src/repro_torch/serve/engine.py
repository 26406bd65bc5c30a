"""Serving engine: batched prefill + decode over a ModelBundle's cache,
the port of the reference's ``repro/serve/engine.py`` ``Engine``.

  * each cache slot holds one active sequence; per-slot positions are
    ragged (``pos: (B,)``), so new requests join mid-flight without
    flushing the batch,
  * prefill writes a new request's KV into its slot with a snapshot +
    scatter, so every OTHER live slot's cache is untouched (prefill
    runs the whole pool batch; only the admitted slot's rows are kept),
  * sampling: greedy / temperature / top-k, all on float32 logits;
    temperature and top-k draw from a ``torch.Generator`` and so do not
    repeat ``jax.random``'s bits,
  * backpressure: with every slot busy, requests queue up to
    ``queue_depth`` (priority-ordered, FIFO within a priority level,
    drained on ``finish``/``cancel``) and beyond that raise the typed
    :class:`SlotsExhausted`,
  * cancellation: ``cancel(ticket)`` removes a queued request;
    ``cancel(slot)`` aborts a live decode, frees the slot, and
    backfills it from the admission queue,
  * prefix reuse (``ServeConfig(prefix_reuse=True)``): when another
    slot's cache rows start with a prefix of the new prompt, the
    matched rows are copied and only the suffix is prefilled.

The cache is updated in place by the model (the reference's steps are
functional); the snapshot is a copy taken before each prefill.

Failover: :class:`RecoveryEngine` backs the slot caches with HDArrays
partitioned over serving instances (ranks), so an instance loss
mid-request is the ft layer's planned shrink — the KV sections migrate
to the survivors and the decode steps since the last checkpoint replay
silently — and a rejoin is the planned grow.
"""
from __future__ import annotations

import collections
import dataclasses
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (_NUMPY_FLOATS, _SINT, _UINT,
                                         from_host, to_host)


class SlotsExhausted(RuntimeError):
    """``add_request`` with every slot busy AND the admission queue
    full (or disabled, the ``queue_depth=0`` default): real
    backpressure, distinct from a transient queue wait."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048         # cache capacity per slot
    slots: int = 8              # concurrent sequences
    temperature: float = 0.0    # 0 => greedy
    top_k: int = 0              # 0 => full softmax
    queue_depth: int = 0        # admission queue size (0 => reject)
    prefix_reuse: bool = False  # copy matching cached prefix rows on admit


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, 1, V) -> int32 tokens (B, 1).  Greedy is the first
    index of the float32 maximum."""
    logits = logits[:, -1, :].float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1)[:, None].to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        kth = logits.sort(dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    tok = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                            generator=generator)
    return tok.to(torch.int32)


def make_prefill_step(bundle) -> Callable:
    def prefill_step(params, batch, cache):
        return bundle.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(bundle) -> Callable:
    def decode_step(params, batch, cache):
        return bundle.decode(params, batch, cache)
    return decode_step


# -- the cache as a tree of dicts with tensor leaves ----------------------
def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree, path=""):
    """(path, leaf) pairs in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _leaves(v, f"{path}/{k}")]
    return [(path, tree)]


def _diff_axis(a, b) -> int:
    return next((d for d, (s0, s1) in enumerate(zip(a.shape, b.shape))
                 if s0 != s1), -1)


class Engine:
    """Slot-based continuous batching on top of the model's steps.

    Host-side request management; device-side state is one cache tree
    whose batch dim is the slot pool, on the model's device.
    """

    def __init__(self, bundle, params, scfg: ServeConfig, seed: int = 0):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.scfg = scfg
        self.params = params
        self.device = bundle.device
        self.cache = bundle.init_cache(scfg.slots, scfg.max_seq)
        self._prefill = make_prefill_step(bundle)
        self._decode = make_decode_step(bundle)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # host-side slot table
        self.slot_pos = np.zeros(scfg.slots, np.int32)      # next write pos
        self.slot_live = np.zeros(scfg.slots, bool)
        self.slot_tokens: List[List[int]] = [[] for _ in range(scfg.slots)]
        # admission queue (backpressure): deferred requests drained
        # into freed slots on finish()/cancel() in (priority desc,
        # arrival asc) order; `admitted` maps each drained ticket
        # (negative id) to the slot it landed in
        self.queue: collections.deque = collections.deque()
        self.admitted: Dict[int, int] = {}
        self._next_ticket = -1
        # which axis of each cache leaf is the slot (batch) dim, and
        # which the per-position (seq) dim: probed on shape-only "meta"
        # caches with one extra slot / one extra row (-1: none)
        probe = bundle.init_cache(scfg.slots + 1, scfg.max_seq, "meta")
        self._slot_axis = _tree_map(_diff_axis, self.cache, probe)
        probe = bundle.init_cache(scfg.slots, scfg.max_seq + 1, "meta")
        self._seq_axis = _tree_map(_diff_axis, self.cache, probe)
        # a slot-carrying non-`pos` leaf with no seq axis folds history
        # into running state, so reuse is off
        self.supports_prefix_reuse = all(
            tax >= 0 or sax < 0 or "pos" in name
            for (name, sax), (_, tax) in zip(_leaves(self._slot_axis),
                                             _leaves(self._seq_axis)))
        # the token sequence whose KV currently occupies each slot's
        # cache rows (positions 0..len-1) -- retained after finish()
        # until the slot is reused, so finished sequences act as a
        # prefix cache; len(kv_tokens[s]) == slot_pos[s] while live
        self.kv_tokens: List[List[int]] = [[] for _ in range(scfg.slots)]
        # prefill-work accounting for the router/benchmark layer
        self.prefill_tokens_computed = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    # ------------------------------------------------------------------
    def add_request(self, prompt_tokens: np.ndarray,
                    extra_inputs: Optional[Dict[str, Any]] = None,
                    priority: int = 0) -> int:
        """Prefill `prompt_tokens` into a free slot; returns the slot
        id (>= 0).  With every slot busy the request queues (up to
        ``queue_depth``) and a NEGATIVE ticket id returns instead --
        ``finish``/``cancel`` drain the queue into freed slots in
        (priority desc, arrival asc) order and record ticket -> slot
        in :attr:`admitted`.  Queue full (or disabled) raises
        :class:`SlotsExhausted`."""
        free = np.flatnonzero(~self.slot_live)
        if free.size == 0:
            if len(self.queue) < self.scfg.queue_depth:
                ticket = self._next_ticket
                self._next_ticket -= 1
                self.queue.append((ticket, np.asarray(prompt_tokens),
                                   extra_inputs, int(priority)))
                return ticket
            raise SlotsExhausted(
                f"no free slots ({self.scfg.slots} busy) and the "
                f"admission queue is full "
                f"({len(self.queue)}/{self.scfg.queue_depth})")
        return self._admit(int(free[0]), np.asarray(prompt_tokens),
                           extra_inputs)

    def cancel(self, tid: int) -> Optional[List[int]]:
        """Abort a request.  ``tid`` < 0 (a queue ticket): the queued
        request is removed before it ever touches a slot (a drained
        ticket resolves through :attr:`admitted` to its slot first).
        ``tid`` >= 0 (a live slot): the slot is freed mid-decode and
        backfilled from the admission queue, and the tokens produced
        so far return.  Raises KeyError for an unknown/idle id."""
        if tid < 0:
            if tid in self.admitted:
                return self.cancel(self.admitted.pop(tid))
            for i, entry in enumerate(self.queue):
                if entry[0] == tid:
                    del self.queue[i]
                    return None
            raise KeyError(f"ticket {tid} is not queued")
        if not (0 <= tid < self.scfg.slots) or not self.slot_live[tid]:
            raise KeyError(f"slot {tid} is not live")
        self.slot_live[tid] = False
        toks, self.slot_tokens[tid] = self.slot_tokens[tid], []
        self.slot_pos[tid] = 0
        self._drain_queue()
        return toks

    def _drain_queue(self) -> None:
        """Admit the best queued request (priority desc, then arrival
        order -- earlier tickets are numerically GREATER) into a free
        slot, recording ticket -> slot in :attr:`admitted`."""
        if not self.queue:
            return
        best = max(range(len(self.queue)),
                   key=lambda i: (self.queue[i][3], self.queue[i][0]))
        ticket, prompt, extra, _prio = self.queue[best]
        del self.queue[best]
        slot = int(np.flatnonzero(~self.slot_live)[0])
        self.admitted[ticket] = self._admit(slot, prompt, extra)

    def _admit(self, sid: int, prompt_tokens: np.ndarray,
               extra_inputs: Optional[Dict[str, Any]]) -> int:
        T = len(prompt_tokens)
        B = self.scfg.slots
        # prefix reuse: find the slot whose cached rows share the
        # longest prefix with this prompt, copy those rows, and only
        # prefill the suffix (L is capped at T-1: the last prompt
        # token always runs so prefill has logits to return)
        L, src = 0, sid
        if (self.scfg.prefix_reuse and self.supports_prefix_reuse
                and not extra_inputs):
            src, L = self._best_prefix(prompt_tokens)
        snapshot = _tree_map(torch.clone, self.cache)
        if L > 0 and src != sid:
            self._copy_prefix_rows(src, sid, L)
        toks = np.zeros((B, T - L), np.int64)
        toks[sid] = prompt_tokens[L:]
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if extra_inputs:
            batch.update(extra_inputs)
        # snapshot + scatter: prefill runs the WHOLE pool batch, so it
        # rewrites every slot's cache at the prompt positions (and
        # advances every slot's pos).  Keep only the admitted slot's
        # rows; every other live slot's cache is bit-identical to its
        # pre-prefill snapshot.
        slots = torch.arange(B, device=self.device)
        for g in self._cache_groups():
            g["pos"] = torch.where(slots == sid, L, g["pos"])
        logits, cache = self._prefill(self.params, batch, self.cache)
        self.cache = self._scatter_slot(snapshot, cache, sid)
        self.slot_pos[sid] = T
        self.slot_live[sid] = True
        self.slot_tokens[sid] = list(map(int, prompt_tokens))
        self.kv_tokens[sid] = list(map(int, prompt_tokens))
        self.prefill_tokens_computed += T - L
        if L > 0:
            self.prefix_hits += 1
            self.prefix_tokens_reused += L
        # first generated token
        tok = self._sample(logits)
        self.slot_tokens[sid].append(int(tok[sid, 0]))
        return sid

    def _best_prefix(self, prompt: np.ndarray) -> Tuple[int, int]:
        """(slot, match length): the slot whose cached token rows share
        the longest common prefix with `prompt` (live or retained),
        capped at len(prompt)-1.  Ties break to the lowest slot id."""
        best_s, best_l = 0, 0
        cap = len(prompt) - 1
        for s in range(self.scfg.slots):
            cached = self.kv_tokens[s]
            n = min(cap, len(cached))
            m = 0
            while m < n and cached[m] == int(prompt[m]):
                m += 1
            if m > best_l:
                best_s, best_l = s, m
        return best_s, best_l

    def _copy_prefix_rows(self, src: int, dst: int, L: int) -> None:
        """Copy cache rows [0, L) (along each leaf's seq axis) from
        slot `src` to slot `dst`, in place.  Bit-identical to
        recomputing them: under causal attention KV at position i
        depends only on tokens[0..i], which match by construction."""
        def copy(leaf, sax, tax):
            if sax >= 0 and tax >= 0:
                src_ix = [slice(None)] * leaf.dim()
                dst_ix = [slice(None)] * leaf.dim()
                src_ix[sax], dst_ix[sax] = src, dst
                src_ix[tax] = dst_ix[tax] = slice(0, L)
                leaf[tuple(dst_ix)] = leaf[tuple(src_ix)]
            return leaf

        self.cache = _tree_map(copy, self.cache, self._slot_axis,
                               self._seq_axis)

    def _scatter_slot(self, old, new, sid: int):
        """Merge two cache trees: slot `sid`'s rows from `new`, every
        other slot's from `old`, copied into `new` in place
        (slot-invariant leaves keep the snapshot)."""
        others = torch.tensor([s for s in range(self.scfg.slots) if s != sid],
                              dtype=torch.long, device=self.device)

        def pick(o, n, ax):
            if ax < 0:
                return o
            return n.index_copy_(ax, others, o.index_select(ax, others))

        return _tree_map(pick, old, new, self._slot_axis)

    def step(self) -> Dict[int, int]:
        """One decode step for all live slots; returns {slot: token}."""
        B = self.scfg.slots
        last = np.array([self.slot_tokens[s][-1] if self.slot_live[s] else 0
                         for s in range(B)], np.int64)[:, None]
        batch = {"token": torch.from_numpy(last).to(self.device),
                 "pos": torch.tensor(self.slot_pos, device=self.device)}
        logits, self.cache = self._decode(self.params, batch, self.cache)
        toks = self._sample(logits)
        out = {}
        for s in range(B):
            if self.slot_live[s]:
                # the fed token's KV was just written at slot_pos[s]
                self.kv_tokens[s].append(int(last[s, 0]))
                t = int(toks[s, 0])
                self.slot_tokens[s].append(t)
                self.slot_pos[s] += 1
                out[s] = t
        return out

    def finish(self, sid: int) -> List[int]:
        self.slot_live[sid] = False
        toks, self.slot_tokens[sid] = self.slot_tokens[sid], []
        self.slot_pos[sid] = 0
        # kv_tokens[sid] is deliberately retained: the finished
        # sequence's cache rows stay valid until the slot is reused,
        # so they keep serving as a prefix cache
        self._drain_queue()
        return toks

    def generate(self, prompt_tokens: np.ndarray, n_tokens: int,
                 extra_inputs: Optional[Dict[str, Any]] = None) -> List[int]:
        sid = self.add_request(np.asarray(prompt_tokens), extra_inputs)
        for _ in range(n_tokens - 1):
            self.step()
        return self.finish(sid)

    # ------------------------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        return sample_tokens(logits, self._gen, self.scfg.temperature,
                             self.scfg.top_k).cpu().numpy()

    def _cache_groups(self):
        if isinstance(self.cache, dict) and "pos" in self.cache:
            return [self.cache]
        return [g for g in self.cache.values()
                if isinstance(g, dict) and "pos" in g]


def _sync(device: torch.device) -> None:
    """Wait for the card, so that a host clock read after it counts
    the device work and not only its launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
class RecoveryEngine:
    """Failure-aware serving: an :class:`Engine` whose slot caches are
    backed by HDArrays partitioned over serving ``instances`` (ranks of
    an :class:`~repro_torch.core.runtime.HDArrayRuntime`): rank p owns
    the cache sections of its share of the slot pool, the way a
    production stack spreads requests over replicas.

    Every cache leaf with a slot axis mirrors into one HDArray (slot
    axis moved to dim 0; dtypes numpy lacks, such as bfloat16, kept as
    the unsigned integers of their size, bit for bit).  On the
    ``"torch"`` backend (the default, on the engine's device) the
    HDArrays live on that device and the mirror after each decode step
    is a device copy (``TorchExecutor.write`` of a tensor): the
    checkpoint's read is the only download.  A ``CheckpointManager``
    snapshots the HDArrays, and the host slot table with the sampling
    generator's state, after each admit, finish and cancel and every
    ``checkpoint_interval`` decode steps.

    ``fail_instance(rank)`` is the ft layer's planned shrink applied to
    serving: mark the rank lost, restore the checkpoint onto the
    survivors' staging layout, ``repartition`` the caches onto the
    shrunken layout (migration bytes in ``rt.comm_log``), then silently
    replay the decode steps since the snapshot — greedy decoding (or
    the restored generator) makes the replay, and therefore every
    in-flight token stream, repeat an uninterrupted run.
    ``rejoin_instance(rank)`` is the planned grow: ``Executor.add_rank``
    + ``grow_partition`` + a migrating ``repartition``, no replay
    needed (the survivors hold every coherent byte).  The audit records
    land in ``rt.recovery_log`` as ``kind="instance_loss"`` /
    ``"instance_join"``.
    """

    def __init__(self, bundle, params, scfg: ServeConfig,
                 instances: int = 2, seed: int = 0,
                 checkpoint_interval: int = 2,
                 ckpt_dir: Optional[str] = None, backend: str = "torch"):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.core import HDArrayRuntime

        self.engine = Engine(bundle, params, scfg, seed)
        self.scfg = scfg
        self.instances = instances
        self.rt = HDArrayRuntime(instances, backend=backend,
                                 device=self.engine.device)
        # a resident executor reads and writes tensors on its device
        self._on_device = hasattr(self.rt.executor, "read_tensor")
        self.live: List[int] = list(range(instances))
        self._tmp = (tempfile.TemporaryDirectory()
                     if ckpt_dir is None else None)
        self.cm = CheckpointManager(ckpt_dir or self._tmp.name)
        self.checkpoint_interval = max(1, int(checkpoint_interval))
        self.recovery_log = self.rt.recovery_log
        # one HDArray per slot-carrying cache leaf, row-partitioned
        # (slot dim 0) over the instances
        self._leaves: List[Tuple[str, str, int, torch.dtype]] = []
        self._parts: Dict[str, int] = {}
        for (path, leaf), (_p, ax) in zip(_leaves(self.engine.cache),
                                          _leaves(self.engine._slot_axis)):
            name = "kv" + path
            self._leaves.append((name, path, int(ax), leaf.dtype))
            if ax < 0:
                continue
            shape = (leaf.shape[ax],) + tuple(
                s for d, s in enumerate(leaf.shape) if d != ax)
            self.rt.create(name, shape, dtype=_numpy_dtype(leaf.dtype))
            self._parts[name] = self.rt.partition_row(shape)
        self._decode_count = 0
        self._ckpt_step = 0
        self._ckpt_decode = 0
        self._host_snap: Optional[Dict[str, Any]] = None
        # injected per-instance slowdown (seconds added to that
        # instance's reported step latency): deterministic straggler
        # modeling for tests
        self.step_cost: Dict[int, float] = {}
        self.last_step_time = 0.0
        self._checkpoint()

    # -- engine API (checkpointed) -------------------------------------
    def add_request(self, prompt_tokens, extra_inputs=None,
                    priority: int = 0) -> int:
        sid = self.engine.add_request(np.asarray(prompt_tokens),
                                      extra_inputs, priority=priority)
        # checkpoint right after the admit so the replay window after
        # a failure only ever contains decode steps
        self._checkpoint()
        return sid

    def step(self) -> Dict[int, int]:
        t0 = time.perf_counter()
        out = self.engine.step()
        _sync(self.engine.device)
        dt = time.perf_counter() - t0
        # per-instance step latency: the decode is one synchronous
        # program over the slot pool, so each live instance's share of
        # the step is the measured wall time plus its injected
        # `step_cost`; dead instances report 0.0 (skipped by the
        # monitor).  Lands in PlannerStats.rank_step_times for the
        # straggler machinery and, through it, the load-aware router.
        times = [dt + self.step_cost.get(r, 0.0) if r in self.live else 0.0
                 for r in range(self.instances)]
        self.rt.planner.stats.note_rank_times(self._decode_count, times)
        self.last_step_time = max(times)
        self._decode_count += 1
        self._mirror()
        if self._decode_count - self._ckpt_decode >= self.checkpoint_interval:
            self._checkpoint()
        return out

    def finish(self, sid: int) -> List[int]:
        out = self.engine.finish(sid)
        self._checkpoint()
        return out

    def cancel(self, tid: int) -> Optional[List[int]]:
        out = self.engine.cancel(tid)
        self._checkpoint()
        return out

    def generate(self, prompt_tokens, n_tokens: int,
                 extra_inputs=None) -> List[int]:
        sid = self.add_request(np.asarray(prompt_tokens), extra_inputs)
        for _ in range(n_tokens - 1):
            self.step()
        return self.finish(sid)

    # -- elasticity ----------------------------------------------------
    def fail_instance(self, rank: int) -> None:
        """Instance `rank` died mid-serving.  Planned shrink + replay:
        caller-visible token streams continue unchanged."""
        from repro_torch.ft.faults import (ElasticPlan, inherit_partition,
                                           shrink_partition,
                                           survivor_partition)

        if rank not in self.live:
            raise ValueError(f"instance {rank} is not live ({self.live})")
        self.live.remove(rank)
        if not self.live:
            raise RuntimeError(f"instance {rank} lost and no survivors "
                               f"remain")
        for arr in self.rt.arrays.values():
            arr.mark_rank_lost(rank)
            self.rt.executor.drop_rank(arr, rank)
        staging: Dict[str, int] = {}
        targets: Dict[str, int] = {}
        for name, arr in self.rt.arrays.items():
            pid = inherit_partition(self.rt, self._parts[name], self.live)
            if pid is None:
                pid = survivor_partition(self.rt, arr.shape, self.live)
            staging[name] = pid
            targets[name] = shrink_partition(self.rt, self._parts[name],
                                             self.live)
        self.cm.restore_runtime(self.rt, parts=staging, live=self.live)
        migration = 0
        for name, arr in self.rt.arrays.items():
            if targets[name] != staging[name]:
                plan = self.rt.repartition(arr, staging[name],
                                           targets[name])
                migration += plan.bytes_total
        self._parts.update(targets)
        # rebuild the engine at the checkpoint, then silently replay
        replay = self._decode_count - self._ckpt_decode
        slots_live = int(self.engine.slot_live.sum())
        self._restore_host(self._host_snap)
        self.engine.cache = self._cache_from_hdarrays()
        self._decode_count = self._ckpt_decode
        for _ in range(replay):
            self.engine.step()
            self._decode_count += 1
            self._mirror()
        self.rt.planner.stats.elastic_shrinks += 1
        self.rt.recovery_log.append({
            "kind": "instance_loss", "rank": rank, "live": list(self.live),
            "migration_bytes": migration, "steps_replayed": replay,
            "slots_live": slots_live,
            "plan": ElasticPlan(len(self.live) + 1, len(self.live),
                                (len(self.live),), migration)})

    def rejoin_instance(self, rank: int) -> None:
        """Instance `rank` (re)joined: planned grow — add_rank +
        grow_partition + a migrating repartition.  No replay needed;
        the survivors hold every coherent byte."""
        from repro_torch.ft.faults import ElasticPlan, grow_partition

        if rank in self.live:
            self.rt.recovery_log.append({
                "kind": "instance_join", "rank": rank,
                "live": list(self.live), "migration_bytes": 0,
                "noop": True, "plan": None})
            return
        self.live.append(rank)
        self.live.sort()
        for arr in self.rt.arrays.values():
            arr.mark_rank_joined(rank)
            self.rt.executor.add_rank(arr, rank)
        migration = 0
        for name, arr in self.rt.arrays.items():
            tgt = grow_partition(self.rt, self._parts[name], self.live,
                                 rank)
            plan = self.rt.repartition(arr, self._parts[name], tgt)
            migration += plan.bytes_total
            self._parts[name] = tgt
        self.rt.planner.stats.elastic_grows += 1
        self.rt.recovery_log.append({
            "kind": "instance_join", "rank": rank, "live": list(self.live),
            "migration_bytes": migration,
            "plan": ElasticPlan(len(self.live) - 1, len(self.live),
                                (len(self.live),), migration)})

    # -- cache <-> HDArray mirroring ------------------------------------
    def _mirror(self) -> None:
        """Write the engine's current cache leaves into their backing
        HDArrays (slot axis first, bit views for dtypes numpy lacks)
        under the current data layout: device copies on a resident
        executor, host arrays otherwise."""
        flat = dict(_leaves(self.engine.cache))
        for name, path, ax, dtype in self._leaves:
            if ax < 0:
                continue
            t = flat[path].movedim(ax, 0)
            if not self._on_device:
                t = to_host(t)
            elif not _is_native(dtype):
                t = t.view(_SINT[t.element_size()])
            self.rt.write(self.rt.arrays[name], t, self._parts[name])

    def _cache_from_hdarrays(self):
        """Rebuild the engine's cache tree from the (restored +
        repartitioned) HDArrays — the inverse of :meth:`_mirror`.
        Leaves without a slot axis come from the host snapshot."""
        static = self._host_snap["static_leaves"]
        new: Dict[str, torch.Tensor] = {}
        for name, path, ax, dtype in self._leaves:
            if ax < 0:
                new[path] = static[name].clone()
                continue
            arr = self.rt.arrays[name]
            if self._on_device:
                t = self.rt.executor.read_tensor(arr, tuple(arr.valid))
                t = t.view(dtype) if t.dtype != dtype else t
            else:
                like = torch.empty(0, dtype=dtype, device=self.engine.device)
                t = from_host(self.rt.read_coherent(arr), like)
            new[path] = t.movedim(0, ax).contiguous()
        return _with_leaves(self.engine.cache, new)

    # -- host-state snapshots -------------------------------------------
    def _checkpoint(self) -> None:
        self._mirror()
        self.cm.save_runtime(self._ckpt_step, self.rt)
        self._ckpt_step += 1
        self._ckpt_decode = self._decode_count
        eng = self.engine
        flat = dict(_leaves(eng.cache))
        self._host_snap = {
            "slot_pos": eng.slot_pos.copy(),
            "slot_live": eng.slot_live.copy(),
            "slot_tokens": [list(t) for t in eng.slot_tokens],
            "kv_tokens": [list(t) for t in eng.kv_tokens],
            "generator": eng._gen.get_state(),
            "queue": list(eng.queue),
            "admitted": dict(eng.admitted),
            "next_ticket": eng._next_ticket,
            "static_leaves": {name: flat[path].clone()
                              for name, path, ax, _d in self._leaves
                              if ax < 0},
        }

    def _restore_host(self, snap: Dict[str, Any]) -> None:
        eng = self.engine
        eng.slot_pos = snap["slot_pos"].copy()
        eng.slot_live = snap["slot_live"].copy()
        eng.slot_tokens = [list(t) for t in snap["slot_tokens"]]
        eng.kv_tokens = [list(t) for t in snap["kv_tokens"]]
        eng._gen.set_state(snap["generator"])
        eng.queue = collections.deque(snap["queue"])
        eng.admitted = dict(snap["admitted"])
        eng._next_ticket = snap["next_ticket"]


def _with_leaves(tree, new: Dict[str, Any], path: str = ""):
    """``tree``'s structure with the leaf at each path taken from
    ``new`` (paths as :func:`_leaves` spells them)."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, new, f"{path}/{k}")
                for k, v in tree.items()}
    return new[path]


def _is_native(dtype: torch.dtype) -> bool:
    """True for tensor dtypes numpy has (and an npz round-trips):
    bfloat16 and the float8 types are not."""
    return not dtype.is_floating_point or dtype in _NUMPY_FLOATS


def _bit_view(dtype: torch.dtype):
    """The same-itemsize unsigned numpy integer that stores a dtype
    numpy lacks, bit for bit (np.uint16 for bfloat16)."""
    return _UINT[torch.empty((), dtype=dtype).element_size()]


def _numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of an HDArray backing a leaf of ``dtype``."""
    if _is_native(dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(_bit_view(dtype))
