"""HDArray core, PyTorch port: the paper's contribution on torch.

Public surface:
  sections  — N-d box/section-set algebra (GDEF/LDEF/LUSE substrate)
  partition — ROW/COL/BLOCK/manual work partitions
  offsets   — use/def offset + absolute-section clauses
  hdarray   — the HDArray handle and its coherence state
  planner   — Eqns (1)-(4), pattern classification, plan cache
  comm      — symbolic collective lowering
  runtime   — HDArrayRuntime facade (paper Table 2), backend selector

The metadata layer is host numpy, as in the reference package; the
executors (sim / null / torch) live in :mod:`repro_torch.executors`.
"""
from .sections import Box, SectionSet
from .partition import Partition, PartitionTable, PartType
from .offsets import (AccessSpec, AbsoluteSpec, stencil, trapezoid,
                      balanced_triangular_rows, IDENTITY_1D, IDENTITY_2D,
                      ROW_ALL, COL_ALL, ALL_2D)
from .hdarray import HDArray
from .planner import Planner, CommPlan, CommKind, classify
from .comm import lower_plan, CollectiveOp
from .runtime import HDArrayRuntime

__all__ = [
    "Box", "SectionSet", "Partition", "PartitionTable", "PartType",
    "AccessSpec", "AbsoluteSpec", "stencil", "trapezoid",
    "balanced_triangular_rows", "IDENTITY_1D", "IDENTITY_2D", "ROW_ALL",
    "COL_ALL", "ALL_2D", "HDArray", "Planner", "CommPlan", "CommKind",
    "classify", "lower_plan", "CollectiveOp", "HDArrayRuntime",
]
