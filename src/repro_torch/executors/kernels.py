"""Backend-portable device kernels.

The paper's kernels are OpenCL work-item functions; the executors call
a Python ``kernel(region, bufs, **kw)`` once per device.  Two calling
conventions coexist:

* **host kernels** (the default) mutate their ``def`` arrays in place
  on numpy device buffers.  They run on the host mirrors everywhere —
  on the torch backend this costs a d2h sync of every stale input.
* **device kernels** — marked with :func:`device_kernel` — take the
  full per-device buffers and return ``{name: updated_buffer}`` for
  every array they define.  The resident
  :class:`~repro_torch.executors.torch_exec.TorchExecutor` hands them
  per-rank views of its resident tensors, so a pipeline of such
  kernels never leaves the device; the sim backend applies the
  returned buffers to its numpy mirrors.

:func:`kernel_put` writes a section on either buffer flavor, which is
usually all a stencil/GEMM body needs to be convention-agnostic::

    @device_kernel
    def jacobi(region, bufs):
        (r0, r1), (c0, c1) = region.bounds
        B = bufs["B"]
        new = (B[r0:r1, c0 - 1:c1 - 1] + B[r0:r1, c0 + 1:c1 + 1]
               + B[r0 - 1:r1 - 1, c0:c1] + B[r0 + 1:r1 + 1, c0:c1]) / 4
        return {"A": kernel_put(bufs["A"], (slice(r0, r1), slice(c0, c1)),
                                new)}

Device kernels may carry **per-architecture variants**: the decorated
function is the portable default and ``@kernel.variant("cuda")``
registers an implementation that replaces it on executors of that
device class (``"sim"``, ``"null"``, ``"cpu"``, ``"cuda"``), resolved
through :func:`resolve_kernel`.  Variants share the default's calling
convention and def-clause; they are about HOW to compute, never WHAT.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def device_kernel(fn: Callable) -> Callable:
    """Mark ``fn`` as a device kernel.

    Contract: ``fn(region, bufs, **kw) -> {name: updated_buffer}``,
    returning the FULL updated per-device buffer of every array it
    defines.  See the module docstring.

    The returned function gains ``.variant(*device_classes)``, a
    decorator registering a per-architecture implementation resolved
    by :func:`resolve_kernel`.
    """
    fn.__hdarray_device__ = True
    fn.__hdarray_variants__ = {}

    def variant(*device_classes: str) -> Callable:
        if not device_classes:
            raise ValueError("variant() needs at least one device class")

        def register(impl: Callable) -> Callable:
            impl.__hdarray_device__ = True
            impl.__hdarray_variants__ = {}  # variants are terminal
            for dc in device_classes:
                fn.__hdarray_variants__[str(dc)] = impl
            return impl

        return register

    fn.variant = variant
    return fn


def resolve_kernel(kernel: Optional[Callable],
                   device_class: Optional[str]) -> Optional[Callable]:
    """Pick the implementation of ``kernel`` for ``device_class``:
    the registered variant if one matches, else the portable default."""
    if kernel is None or device_class is None:
        return kernel
    variants = getattr(kernel, "__hdarray_variants__", None)
    if not variants:
        return kernel
    return variants.get(str(device_class), kernel)


def kernel_put(buf, slices, value):
    """Section assignment on either buffer flavor; returns the buffer
    holding ``buf[slices] = value``.

    On a ``torch.Tensor`` the write is IN PLACE (``buf[slices] = value;
    return buf``), where the reference package's version is functional
    (a copy and ``.at[].set``).  The resident executor hands each rank
    a view of its resident tensor, so writing in place saves one
    full-buffer copy per rank per step — half a gigabyte per rank for
    the paper's Jacobi array.  A kernel that reads a buffer after
    putting into it therefore sees the new values; the kernels here put
    last.  A numpy buffer (the sim backend's mirrors) is copied first,
    as in the reference."""
    if isinstance(buf, torch.Tensor):
        buf[slices] = value
        return buf
    out = np.array(buf, copy=True)
    out[slices] = np.asarray(value)
    return out
