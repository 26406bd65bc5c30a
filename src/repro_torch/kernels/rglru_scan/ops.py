"""Public entry of the RG-LRU scan."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import rglru_scan_cuda
from .ref import rglru_scan_ref


def rglru_scan(x_in: torch.Tensor, gate_a: torch.Tensor,
               gate_i: torch.Tensor, lam: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 of (B, T, W) inputs, with the
    gates of :mod:`.ref`; returns h (B, T, W) float32.

    A CUDA tensor launches the kernel (``csrc/rglru_scan.cu``); a CPU
    tensor runs the plain version."""
    if x_in.is_cuda:
        return rglru_scan_cuda(x_in, gate_a, gate_i, lam, h0)
    return rglru_scan_ref(x_in, gate_a, gate_i, lam, h0)
