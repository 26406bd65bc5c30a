"""HDArray device-kernel factories for the real compute kernels.

The kernel packages (``gemm_hd`` / ``stencil_hd``) expose *tensor ->
tensor* ops; the runtime calls OpenCL-style per-device kernels,
``kernel(region, bufs) -> {name: buffer}`` (the
:func:`~repro_torch.executors.kernels.device_kernel` convention).  Each
factory returns a device kernel that slices its work region out of the
per-device buffers and runs the op (the CUDA kernel on a CUDA tensor,
the plain version on a CPU one), which writes the region's result
straight into the destination buffer through its row pitch: no
temporary, no copy back.  On the torch backend the buffers are views
of the resident tensors, so the whole step stays on the card; on sim
they are numpy mirrors, which the factories view as CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.executors.kernels import device_kernel


def make_gemm_kernel(a: str = "A", b: str = "B", c: str = "C", *,
                     alpha: float = 1.0):
    """``C[rows, :] = alpha * A[rows, :] @ B`` over the region's row
    band — the row-partitioned GEMM of the paper's Table 3.  ``A`` is
    used with ROW_ALL, ``B`` with COL_ALL (every device reads all of
    B), ``C`` defined with the identity map."""
    from repro_torch.kernels.gemm_hd.ops import gemm

    @device_kernel
    def gemm_hd_kernel(region, bufs):
        r0, r1 = (int(v) for v in region.bounds[0])
        gemm(torch.as_tensor(bufs[a])[r0:r1, :], torch.as_tensor(bufs[b]),
             alpha=alpha, out=torch.as_tensor(bufs[c])[r0:r1, :])
        return {c: bufs[c]}

    return gemm_hd_kernel


def make_jacobi_kernel(src: str = "A", dst: str = "B"):
    """One Jacobi sweep ``dst[region] = avg4(src)`` over an INTERIOR
    work region (the standard idiom: work partition over
    ``Box.make((1, M-1), (1, N-1))``, boundary rows/cols pass through).
    The op sweeps the region's row band plus its one-row halo — the
    halo rows themselves arrive via the planner's ghost-cell
    exchange."""
    from repro_torch.kernels.stencil_hd.ops import jacobi_step

    @device_kernel
    def jacobi_hd_kernel(region, bufs):
        (r0, r1), (c0, c1) = ((int(lo), int(hi)) for lo, hi in region.bounds)
        x = torch.as_tensor(bufs[src])
        m, n = x.shape
        if not (r0 >= 1 and r1 <= m - 1 and c0 >= 1 and c1 <= n - 1):
            raise ValueError("jacobi kernel needs an interior work region")
        # slab = band + vertical halo; only the band's interior
        # [r0, r1) x [c0, c1) — slab rows [1, r1 - r0 + 1) — is written
        jacobi_step(x[r0 - 1:r1 + 1, :], window=((1, r1 - r0 + 1), (c0, c1)),
                    out=torch.as_tensor(bufs[dst])[r0:r1, c0:c1])
        return {dst: bufs[dst]}

    return jacobi_hd_kernel
