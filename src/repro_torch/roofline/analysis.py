"""Roofline terms of a step from its per-rank op costs, for an NVIDIA
H100: the port of the reference's ``roofline/analysis.py``.

    compute    = FLOPs_per_rank / peak rate of their operand type
    memory     = bytes_per_rank / HBM_BW
    collective = coll_bytes_per_rank / FABRIC_BW

The counts come from :mod:`~repro_torch.roofline.op_costs`, one rank's
(DTensor's local ops), so each term is one card's time directly.
Collective bytes are each collective's operand payload, the reference's
convention.

Constants: the H100 SXM 80GB at its 700 W limit, from NVIDIA's data
sheet (specification, not measurement): 989e12 FLOP/s dense on the
tensor cores in bf16 and fp16, 67e12 FP32 outside them (the rates of
``PERF.md``'s kernel bounds; a float32 product counts at the latter,
TF32 being off), 3.35e12 B/s of HBM3.  The fabric is one constant, as
the reference keeps one: 50e9 B/s per GPU, InfiniBand NDR at 400 Gb/s.
A (16, 16) mesh of 256 GPUs in nodes of 8 crosses nodes on both axes
(a 'model' group of 16 spans two nodes), and a collective over a group
that crosses nodes runs at the slowest link in it, so one rate stands
for both axes; NVLink's 450e9 B/s inside a node is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12      # bf16 / fp16 dense, tensor cores
PEAK_FLOPS_F32 = 67e12   # FP32 outside the tensor cores
HBM_BW = 3.35e12         # bytes/s, HBM3
FABRIC_BW = 400e9 / 8    # bytes/s per GPU, InfiniBand NDR 400 Gb/s

PEAK_BY_TYPE = {"bf16": PEAK_FLOPS, "f32": PEAK_FLOPS_F32}


def compute_seconds(flops_by_type: Dict[str, float]) -> float:
    """Each type's FLOPs at its peak rate (others at the bf16 peak)."""
    return sum(v / PEAK_BY_TYPE.get(k, PEAK_FLOPS)
               for k, v in flops_by_type.items())


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float             # per device (the counted ops' FLOPs)
    hlo_bytes: float             # per device
    coll_bytes: float            # per device
    coll_by_kind: Dict[str, float]
    model_flops_total: float     # analytic useful FLOPs (whole step)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0    # MODEL_FLOPS / (FLOPs * chips)
    roofline_fraction: float = 0.0
    mem_per_device: Optional[float] = None
    flops_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)

    def finish(self) -> "RooflineReport":
        self.t_compute = (compute_seconds(self.flops_by_type)
                          if self.flops_by_type
                          else self.hlo_flops / PEAK_FLOPS)
        self.t_memory = self.hlo_bytes / HBM_BW
        self.t_collective = self.coll_bytes / FABRIC_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        total = self.hlo_flops * self.n_chips
        self.useful_ratio = self.model_flops_total / total if total else 0.0
        # useful FLOPs at peak against the step's dominant term: how
        # close the step runs to the best achievable
        t_ideal = self.model_flops_total / (self.n_chips * PEAK_FLOPS)
        t_step = max(terms.values())
        self.roofline_fraction = t_ideal / t_step if t_step else 0.0
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape_cell) -> float:
    """Analytic useful FLOPs for the step: 6·N·D train (fwd+bwd),
    2·N·D forward-only (prefill/decode); N = active params (MoE)."""
    n = cfg.active_param_count()
    tokens = shape_cell.global_batch * (
        shape_cell.seq_len if shape_cell.kind in ("train", "prefill") else 1)
    mult = 6.0 if shape_cell.kind == "train" else 2.0
    return mult * n * tokens


def analyze(cost, *, arch: str, shape: str, mesh_name: str, n_chips: int,
            model_flops_total: float) -> RooflineReport:
    """The report of one rank's :class:`~repro_torch.roofline.op_costs.
    Cost`; ``mem_per_device`` is the peak of its live bytes."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=float(cost.flops), hlo_bytes=float(cost.hbm_bytes),
        coll_bytes=float(cost.coll_bytes), coll_by_kind=dict(cost.coll),
        model_flops_total=model_flops_total,
        mem_per_device=float(cost.peak_bytes) or None,
        flops_by_type=dict(cost.flops_by_type),
    ).finish()
