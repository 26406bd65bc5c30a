"""Public entry of the Jacobi stencil step."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import Window, jacobi_cuda, sweep_out
from .ref import jacobi_ref


def jacobi_step(x: torch.Tensor, *, impl: str = "auto",
                window: Optional[Window] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Jacobi sweep of ``x (M, N)``; edges pass through.

    ``window=((i0, i1), (j0, j1))`` asks for rows ``[i0, i1)`` and
    columns ``[j0, j1)`` of the result (default all of it); they are
    written into ``out``, a tensor of the window's shape that shares no
    memory with ``x`` (default a new one), which is returned.

    ``impl="auto"`` launches the CUDA kernel for a CUDA tensor and runs
    the plain version for a CPU tensor; ``"cuda"`` and ``"ref"`` pick
    one explicitly (``"cuda"`` on a CPU tensor raises)."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        return jacobi_cuda(x, window=window, out=out)
    if impl == "ref":
        ((i0, i1), (j0, j1)), out = sweep_out(x, window, out)
        return out.copy_(jacobi_ref(x)[i0:i1, j0:j1])
    raise ValueError(f"unknown impl {impl!r}; one of 'auto', 'cuda', 'ref'")
