"""Replica routing policies for the serving cluster.

The pool presents each routable replica as a :class:`ReplicaView`
(free slots, outstanding work, step-time EWMA, straggler flag, id) and
the router picks one.  Three policies, all deterministic:

  * ``round_robin`` — cycle replica ids, skipping full replicas.
  * ``load_aware``  — fewest outstanding sequences wins; replicas the
    straggler monitor currently flags sort behind healthy ones (the
    signal comes from ``RecoveryEngine.step`` latencies surfaced into
    ``PlannerStats.rank_step_times``); ties break to the lower id.
  * ``prefix_aware`` — longest-prefix match of the prompt against a
    per-replica :class:`TokenTrie` of admitted token sequences (the
    router's model of which replica holds which KV prefixes — the
    engine's ``prefix_reuse`` then turns the hit into skipped prefill
    work).  No usable match falls back to load-aware.

``get_router(policy)`` maps names to instances so the pool accepts
either a string or a Router object.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """What a policy may look at when choosing a replica."""
    replica_id: int
    free_slots: int
    outstanding: int        # live slots + engine-queued requests
    step_ewma: float        # EWMA of this replica's step wall time
    straggler: bool         # currently flagged by the monitor


class Router:
    """Policy interface.  ``choose`` gets only replicas with a free
    slot and must return one of their ids; ``note_admitted`` /
    ``note_evicted`` keep per-replica routing state in sync with what
    the engines actually hold."""

    name = "base"

    def choose(self, prompt: Sequence[int],
               candidates: List[ReplicaView]) -> int:
        raise NotImplementedError

    def note_admitted(self, replica_id: int,
                      tokens: Sequence[int]) -> None:
        pass

    def note_evicted(self, replica_id: int,
                     tokens: Sequence[int]) -> None:
        pass


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, prompt, candidates):
        ids = sorted(v.replica_id for v in candidates)
        pick = next((i for i in ids if i >= self._next), ids[0])
        self._next = pick + 1
        return pick


class LoadAwareRouter(Router):
    name = "load_aware"

    def choose(self, prompt, candidates):
        return min(candidates,
                   key=lambda v: (v.straggler, v.outstanding,
                                  v.replica_id)).replica_id


class TokenTrie:
    """Radix-ish index of token sequences with refcounted nodes.

    ``insert``/``remove`` keep per-node counts so eviction of one
    sequence never drops a prefix another sequence still pins;
    ``match`` walks the longest indexed prefix of a query.  ``cap``
    bounds the number of resident sequences (oldest evicted first) so
    the index mirrors a bounded KV cache rather than all history.
    """

    def __init__(self, cap: int = 256):
        self.cap = cap
        self._root: Dict[int, list] = {}          # tok -> [count, children]
        self._resident: Deque[tuple] = deque()

    def insert(self, tokens: Sequence[int]) -> None:
        toks = tuple(int(t) for t in tokens)
        if not toks:
            return
        node = self._root
        for t in toks:
            ent = node.setdefault(t, [0, {}])
            ent[0] += 1
            node = ent[1]
        self._resident.append(toks)
        while len(self._resident) > self.cap:
            self._remove(self._resident.popleft())

    def remove(self, tokens: Sequence[int]) -> None:
        toks = tuple(int(t) for t in tokens)
        try:
            self._resident.remove(toks)
        except ValueError:
            return
        self._remove(toks)

    def _remove(self, toks: tuple) -> None:
        node = self._root
        for t in toks:
            ent = node.get(t)
            if ent is None:
                return
            ent[0] -= 1
            if ent[0] <= 0:
                del node[t]
                return
            node = ent[1]

    def match(self, tokens: Sequence[int]) -> int:
        """Length of the longest indexed prefix of `tokens`."""
        node, n = self._root, 0
        for t in tokens:
            ent = node.get(int(t))
            if ent is None:
                break
            n += 1
            node = ent[1]
        return n

    def __len__(self) -> int:
        return len(self._resident)


class PrefixAwareRouter(Router):
    name = "prefix_aware"

    def __init__(self, min_match: int = 1, cap: int = 256):
        self.min_match = min_match
        self.cap = cap
        self._tries: Dict[int, TokenTrie] = {}
        self._fallback = LoadAwareRouter()

    def _trie(self, rid: int) -> TokenTrie:
        if rid not in self._tries:
            self._tries[rid] = TokenTrie(self.cap)
        return self._tries[rid]

    def choose(self, prompt, candidates):
        scored = [(self._trie(v.replica_id).match(prompt), v)
                  for v in candidates]
        best = max(s for s, _v in scored)
        if best < self.min_match:
            return self._fallback.choose(prompt, candidates)
        hits = [v for s, v in scored if s == best]
        return min(hits, key=lambda v: (v.outstanding,
                                        v.replica_id)).replica_id

    def note_admitted(self, replica_id, tokens):
        self._trie(replica_id).insert(tokens)

    def note_evicted(self, replica_id, tokens):
        self._trie(replica_id).remove(tokens)

    def match_len(self, replica_id: int, tokens: Sequence[int]) -> int:
        return self._trie(replica_id).match(tokens)


POLICIES = {
    "round_robin": RoundRobinRouter,
    "load_aware": LoadAwareRouter,
    "prefix_aware": PrefixAwareRouter,
}


def get_router(policy) -> Router:
    """'round_robin' | 'load_aware' | 'prefix_aware' | Router instance."""
    if isinstance(policy, Router):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown router policy {policy!r}; "
                         f"one of {sorted(POLICIES)}") from None
