"""Pluggable executor backends for the HDArray runtime (PyTorch port).

=========  ============================================================
backend    what executes a classified ``CommPlan``
=========  ============================================================
``sim``    per-device full-size numpy buffers, messages as host
           section copies — the validation oracle
           (:class:`~repro_torch.executors.sim.SimExecutor`)
``null``   metadata only: bytes counted, nothing allocated
           (:class:`~repro_torch.executors.null.NullExecutor`)
``torch``  device-resident ``(nproc, *shape)`` tensors on one card
           (or the CPU); every CommKind is a device-to-device section
           copy and :func:`~repro_torch.executors.kernels.device_kernel`
           kernels run on the device
           (:class:`~repro_torch.executors.torch_exec.TorchExecutor`)
=========  ============================================================

Select with ``HDArrayRuntime(nproc, backend=...)`` or construct via
:func:`make_executor`.
"""
from .base import Executor, available_backends, make_executor, register_executor
from .sim import SimExecutor
from .null import NullExecutor
from .torch_exec import TorchExecutor
from .kernels import device_kernel, kernel_put, resolve_kernel
from .profiles import DeviceProfile, DeviceProfileRegistry

__all__ = [
    "Executor", "available_backends", "make_executor", "register_executor",
    "SimExecutor", "NullExecutor", "TorchExecutor", "device_kernel",
    "kernel_put", "resolve_kernel", "DeviceProfile", "DeviceProfileRegistry",
]
