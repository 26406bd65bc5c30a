"""Serving: the slot ``Engine``, the failure-aware ``RecoveryEngine``,
and the ``ReplicaPool`` cluster with its routers, scheduler,
membership and metrics."""
from .engine import (Engine, RecoveryEngine, ServeConfig, SlotsExhausted,
                     make_decode_step, make_prefill_step, sample_tokens)
from .membership import Membership, MembershipConfig, MembershipEvent
from .metrics import RequestMetrics, ServeMetrics, percentile
from .pool import ReplicaPool
from .router import (LoadAwareRouter, PrefixAwareRouter, ReplicaView,
                     RoundRobinRouter, Router, TokenTrie, get_router)
from .scheduler import PriorityScheduler, QueueFull, QueuedRequest

__all__ = ["ServeConfig", "Engine", "RecoveryEngine", "SlotsExhausted",
           "make_prefill_step", "make_decode_step", "sample_tokens",
           "Membership", "MembershipConfig", "MembershipEvent",
           "RequestMetrics", "ServeMetrics", "percentile",
           "ReplicaPool",
           "LoadAwareRouter", "PrefixAwareRouter", "ReplicaView",
           "RoundRobinRouter", "Router", "TokenTrie", "get_router",
           "PriorityScheduler", "QueueFull", "QueuedRequest"]
