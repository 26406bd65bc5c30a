"""The H100 cost model: per-rank op costs of a step (``op_costs``,
with the kernels' own work from ``kernel_work``), its roofline terms
(``analysis``) and their attribution by tag (``attribute``)."""
