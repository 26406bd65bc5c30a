"""Membership service: heartbeat-driven instance liveness.

Nobody calls ``fail_instance``/``rejoin_instance`` by hand.  Each
``ReplicaPool.step`` ticks the service once per replica with the set
of instance ranks that heartbeat this tick; the per-instance state
machine is

    alive --miss x suspect_after--> suspect
    suspect --miss x dead_after (total)--> dead      (emit "dead")
    suspect --beat--> alive                          (emit "alive")
    dead --beat x rejoin_after (consecutive)--> alive (emit "join")

The pool reacts to "dead" with the ft layer's planned shrink
(``RecoveryEngine.fail_instance``: KV migrates to survivors, the
checkpointed window replays, token streams stay bit-identical) and to
"join" with the planned grow (``rejoin_instance``).  ``rejoin_after``
debounces a flapping instance: one stray heartbeat from a dead rank
does not trigger a grow migration.

Ticks are logical (one per pool step), so a test or benchmark that
suppresses heartbeats for K ticks produces exactly the same event
sequence every run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Set, Tuple

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    suspect_after: int = 2   # consecutive misses: alive -> suspect
    dead_after: int = 4      # consecutive misses: suspect -> dead
    rejoin_after: int = 2    # consecutive beats: dead -> alive ("join")

    def __post_init__(self):
        if not (0 < self.suspect_after <= self.dead_after):
            raise ValueError(
                f"need 0 < suspect_after <= dead_after, got "
                f"{self.suspect_after}/{self.dead_after}")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    kind: str        # "suspect" | "dead" | "alive" | "join"
    replica: int
    rank: int
    tick: int


class Membership:
    """Per-(replica, rank) liveness state machine over heartbeat sets."""

    def __init__(self, replicas: Dict[int, Iterable[int]],
                 cfg: MembershipConfig = MembershipConfig()):
        self.cfg = cfg
        self.state: Dict[Tuple[int, int], str] = {}
        self._miss: Dict[Tuple[int, int], int] = {}
        self._beat: Dict[Tuple[int, int], int] = {}
        self.events: List[MembershipEvent] = []
        for rid, ranks in replicas.items():
            for r in ranks:
                self.state[(rid, r)] = ALIVE
                self._miss[(rid, r)] = 0
                self._beat[(rid, r)] = 0

    def ranks(self, replica: int) -> List[int]:
        return sorted(r for (rid, r) in self.state if rid == replica)

    def tick(self, replica: int, beats: Set[int],
             now_tick: int) -> List[MembershipEvent]:
        """Advance every instance of `replica` one heartbeat period.
        Returns the transitions that fired this tick (also appended to
        :attr:`events`)."""
        out: List[MembershipEvent] = []
        for r in self.ranks(replica):
            key = (replica, r)
            st = self.state[key]
            if r in beats:
                self._miss[key] = 0
                if st == SUSPECT:
                    self._emit(out, "alive", replica, r, now_tick)
                    self.state[key] = ALIVE
                elif st == DEAD:
                    self._beat[key] += 1
                    if self._beat[key] >= self.cfg.rejoin_after:
                        self._emit(out, "join", replica, r, now_tick)
                        self.state[key] = ALIVE
                        self._beat[key] = 0
            else:
                self._beat[key] = 0
                if st == DEAD:
                    continue
                self._miss[key] += 1
                if st == ALIVE and self._miss[key] >= self.cfg.suspect_after:
                    self._emit(out, "suspect", replica, r, now_tick)
                    self.state[key] = SUSPECT
                    st = SUSPECT
                if st == SUSPECT and self._miss[key] >= self.cfg.dead_after:
                    self._emit(out, "dead", replica, r, now_tick)
                    self.state[key] = DEAD
        return out

    def _emit(self, out: List[MembershipEvent], kind: str, replica: int,
              rank: int, tick: int) -> None:
        ev = MembershipEvent(kind, replica, rank, tick)
        out.append(ev)
        self.events.append(ev)
