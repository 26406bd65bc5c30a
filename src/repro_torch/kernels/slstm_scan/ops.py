"""Public entry of the sLSTM recurrence."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import slstm_scan_cuda
from .ref import State, slstm_scan_ref


def slstm_scan(pre_x: torch.Tensor, r: torch.Tensor,
               state: Optional[State] = None, out: Optional[State] = None
               ) -> Tuple[torch.Tensor, State]:
    """The sLSTM recurrence of :mod:`.ref` over axis 1 of pre_x (B, T,
    4D); returns hs (B, T, D) float32 and the final (c, n, h, m), in
    ``out`` when given (which may be ``state``: in place).

    A CUDA tensor launches the kernel (``csrc/slstm_scan.cu``); a CPU
    tensor runs the plain version."""
    if pre_x.is_cuda:
        return slstm_scan_cuda(pre_x, r, state, out)
    return slstm_scan_ref(pre_x, r, state, out)
