"""Plain PyTorch version of the RG-LRU scan, the function of the
reference's ``_rglru_scan`` (``repro/models/rglru.py:73-93``):

    log_a = -8 * softplus(lam) * sigmoid(gate_a)
    a     = exp(log_a)
    b     = sqrt(max(1 - exp(2 * log_a), 1e-12)) * sigmoid(gate_i) * x
    h_t   = a_t * h_{t-1} + b_t,    h_{-1} = h0 (or 0)

in float32, the carried state folded into the first step's b as the
reference folds it.  The reference runs the recurrence as a
log-depth ``associative_scan``; this runs it as a loop over T, which
rounds in another order (within 1e-5 relative in float32) and is the
order the CUDA kernel takes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

C = 8.0  # the RG-LRU "c" constant of the paper


def gates(x_in: torch.Tensor, gate_a: torch.Tensor, gate_i: torch.Tensor,
          lam: torch.Tensor):
    """(a, b) of the recurrence, float32 (B, T, W)."""
    log_a = -C * F.softplus(lam.float()) * torch.sigmoid(gate_a.float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (torch.sigmoid(gate_i.float()) * x_in.float())
    return a, b


def rglru_scan_ref(x_in: torch.Tensor, gate_a: torch.Tensor,
                   gate_i: torch.Tensor, lam: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_in, gate_a, gate_i (B, T, W); lam (W,); h0 (B, W) or None.
    Returns h (B, T, W) float32."""
    a, b = gates(x_in, gate_a, gate_i, lam)
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    out = torch.empty_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
