"""Serving: the slot ``Engine`` and its steps.  ``RecoveryEngine``,
the replica pool, routers, scheduler, membership and metrics are still
to port (ROADMAP)."""
from .engine import (Engine, ServeConfig, SlotsExhausted, make_decode_step,
                     make_prefill_step, sample_tokens)

__all__ = ["ServeConfig", "Engine", "SlotsExhausted", "make_prefill_step",
           "make_decode_step", "sample_tokens"]
