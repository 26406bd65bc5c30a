"""Fault tolerance and measured rebalancing for the HDArray runtime
(PyTorch port): fault injection, the recovery policy, the partition
algebra of a mesh shrink and grow (:mod:`.faults`), and the
measurement-driven :class:`~.rebalance.Rebalancer`.  Host numpy, as in
the reference package."""
from .faults import (ElasticPlan, FaultInjector, FaultSpec, RankJoinedEvent,
                     RankLostFault, RecoveryPolicy, StepGuard,
                     StragglerEvent, StragglerMonitor, TransientFault,
                     coverage_box, grow_partition, inherit_partition,
                     plan_elastic_rescale, shrink_partition,
                     survivor_partition)
from .rebalance import Rebalancer, reweighted_partition

__all__ = [
    "ElasticPlan", "FaultInjector", "FaultSpec", "RankJoinedEvent",
    "RankLostFault", "RecoveryPolicy", "StepGuard", "StragglerEvent",
    "StragglerMonitor", "TransientFault", "coverage_box", "grow_partition",
    "inherit_partition", "plan_elastic_rescale", "shrink_partition",
    "survivor_partition", "Rebalancer", "reweighted_partition",
]
