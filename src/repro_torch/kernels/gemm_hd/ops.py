"""Public entry of the blocked GEMM."""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import gemm_cuda, product_out
from .ref import gemm_ref


def gemm(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
         impl: str = "auto",
         out_dtype: Optional[torch.dtype] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * a @ b`` with float32 accumulation, written into ``out``
    (a tensor of the product's shape that shares no memory with ``a``
    or ``b``; default a new one of ``out_dtype``, itself defaulting to
    ``a.dtype``), which is returned.

    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``"cuda"`` and ``"ref"`` pick one
    explicitly (``"cuda"`` on CPU tensors raises)."""
    if impl == "auto":
        impl = "cuda" if a.is_cuda else "ref"
    if impl == "cuda":
        return gemm_cuda(a, b, alpha=alpha, out_dtype=out_dtype, out=out)
    if impl == "ref":
        out = product_out(a, b, out_dtype, out)
        return out.copy_(gemm_ref(a, b, alpha=alpha, out_dtype=out.dtype))
    raise ValueError(f"unknown impl {impl!r}; one of 'auto', 'cuda', 'ref'")
