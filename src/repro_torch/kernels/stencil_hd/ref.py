"""Plain PyTorch version of the Jacobi 5-point stencil step.

Boundary rows/cols pass through unchanged (the paper's ghost-cell
convention: work is partitioned over the interior only).  The sum is
taken in float32 in the order ((left + right) + above) + below and
scaled by 0.25, which is bit-identical to the reference package's
``jacobi_ref`` (``/ 4``) and ``jacobi_pallas`` (``* 0.25``)."""
import torch


def jacobi_ref(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    out = x.clone()
    inner = (xf[1:-1, :-2] + xf[1:-1, 2:] + xf[:-2, 1:-1] + xf[2:, 1:-1]) * 0.25
    out[1:-1, 1:-1] = inner.to(x.dtype)
    return out
