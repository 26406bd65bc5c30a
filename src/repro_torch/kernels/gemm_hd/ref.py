"""Plain PyTorch version of the blocked GEMM kernel: float32
accumulation, alpha applied to the float32 product, output in
``out_dtype`` (default ``a.dtype``)."""
from typing import Optional

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return (alpha * torch.matmul(a.float(), b.float())).to(out_dtype)
