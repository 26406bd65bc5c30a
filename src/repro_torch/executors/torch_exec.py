"""TorchExecutor — the HDArray executor on one CUDA card (or the CPU).

The counterpart of the reference package's resident ``JaxExecutor``.

**Residency.**  Each HDArray lives as ONE ``(nproc, *shape)`` tensor on
``device``: the ``nproc`` logical ranks share one card, as the
reference fakes ``nproc`` host devices on one CPU, and every rank
holds a full-size buffer (paper ``HDArrayCreate``).  The numpy host
mirrors of the Sim layout are a lazy, dirty-tracked cache that
materializes only on ``sync_host`` — for an unmarked host kernel or
the reduce's local fold.  ``write`` uploads the user array once and
scatters each rank's sections on the device; ``read`` assembles the
requested sections on the device and downloads one array.
``h2d_transfers`` / ``d2h_transfers`` count these full-buffer
crossings, so a test can assert that a steady pipeline moves none.

**Copy schedule.**  Every CommKind (ALL_GATHER, HALO, ALL_TO_ALL,
P2P) lowers to device-to-device section copies inside the array's
tensor: message ``(src, dst, box)`` is ``t[dst][box] = t[src][box]``.
The copies run in the Sim oracle's order.  The planner never makes a
device send a box it also receives in the same plan (at most one
device holds the pending coherent copy of an element,
``HDArray._supersede``), so this order gives the same bytes as the
reference's collect-every-payload-then-apply order.
``copy_counts`` counts the copied boxes per kind, in place of the
reference's per-collective counts.

**Kernels.**  A :func:`~repro_torch.executors.kernels.device_kernel`
runs once per rank on that rank's view of the resident tensors
(``device_kernel_launches`` counts one per step, as the reference
does); a rank only ever touches its own view, so ranks stay isolated
as in the OpenCL model.  Unmarked host kernels mutate the numpy
mirrors after a ``sync_host``, and the arrays they define re-upload on
their next device use.

**Reductions** fold on the host mirrors after one ``sync_host`` and
combine with the Sim left fold, so a reduce is bit-identical to the
oracle's.  A fold on the device would change the summation order.

``execute_step`` is the classic two-phase path (returns False) and
``capture_cycle`` declines (None): CUDA-graph capture is not ported.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .base import register_executor
from .kernels import resolve_kernel
from .sim import SimExecutor

if TYPE_CHECKING:
    from repro_torch.core.hdarray import HDArray
    from repro_torch.core.planner import CommKind
    from repro_torch.core.sections import SectionSet

# CommKind values that carry section messages
_COPY_KINDS = ("all_gather", "halo", "all_to_all", "p2p")


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


@register_executor("torch")
class TorchExecutor(SimExecutor):
    """Executes plans over device-resident ``(nproc, *shape)`` tensors."""

    def __init__(self, nproc: Optional[int] = None,
                 device: str = "cuda") -> None:
        super().__init__(nproc=nproc)
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchExecutor runs on 'cuda' or 'cpu', "
                             f"not {device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchExecutor(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run on the host")
        self.device = dev
        self.device_class = dev.type
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.device_kernel_launches = 0
        self.copy_counts: Dict[str, int] = dict.fromkeys(_COPY_KINDS, 0)
        self._device: Dict[str, torch.Tensor] = {}
        self._device_ok: Dict[str, bool] = {}
        self._host_ok: Dict[str, bool] = {}

    # -- lifecycle ------------------------------------------------------
    def allocate(self, arr: "HDArray") -> None:
        self._device[arr.name] = torch.zeros(
            (arr.nproc,) + arr.shape, dtype=torch_dtype(arr.dtype),
            device=self.device)
        self.buffers[arr.name] = None     # mirrors materialize on sync_host
        self._device_ok[arr.name] = True
        self._host_ok[arr.name] = False

    def free(self, arr: "HDArray") -> None:
        super().free(arr)
        self._device.pop(arr.name, None)
        self._device_ok.pop(arr.name, None)
        self._host_ok.pop(arr.name, None)

    def drop_rank(self, arr: "HDArray", rank: int) -> None:
        """Device ``rank`` died: poison its buffer (NaN for float
        arrays, as the Sim oracle does) on the device."""
        dev = self._device.get(arr.name)
        if dev is None:
            return
        self.sync_device(arr)
        dev[rank].fill_(float("nan") if dev.is_floating_point() else 0)
        self._host_ok[arr.name] = False

    def add_rank(self, arr: "HDArray", rank: int) -> None:
        """Device ``rank`` (re)joined: its buffer restarts zeroed; only
        planned traffic may fill it."""
        dev = self._device.get(arr.name)
        if dev is None:
            return
        self.sync_device(arr)
        dev[rank].zero_()
        self._host_ok[arr.name] = False

    # -- residency hooks (Executor protocol) ----------------------------
    def sync_host(self, arr: "HDArray") -> None:
        """Materialize the host mirrors from the resident tensor (one
        d2h when the device copy is newer; no-op otherwise)."""
        name = arr.name
        if self._host_ok[name]:
            return
        stacked = self._device[name].to("cpu", copy=True).numpy()
        self.buffers[name] = list(stacked)   # per-rank writable views
        self._host_ok[name] = True
        self.d2h_transfers += 1

    def sync_device(self, arr: "HDArray") -> None:
        """Upload the host mirrors into the resident tensor (one h2d
        when the mirrors are newer; no-op otherwise)."""
        name = arr.name
        if self._device_ok[name]:
            return
        dev = self._device[name]
        for p, buf in enumerate(self.buffers[name]):
            dev[p].copy_(torch.from_numpy(buf))
        self._device_ok[name] = True
        self.h2d_transfers += 1

    # -- controller I/O -------------------------------------------------
    def write(self, arr: "HDArray", data: np.ndarray,
              per_device: Sequence["SectionSet"]) -> None:
        data = np.ascontiguousarray(data, dtype=arr.dtype)
        if data.shape != arr.shape:
            raise ValueError(f"write of shape {data.shape} into "
                             f"{arr.name!r} of shape {arr.shape}")
        self.sync_device(arr)
        src = torch.from_numpy(data).to(self.device)
        self.h2d_transfers += 1
        dev = self._device[arr.name]
        for p, secs in enumerate(per_device):
            for sl in secs.iter_slices():
                dev[p][sl] = src[sl]
        self._host_ok[arr.name] = False

    def read(self, arr: "HDArray",
             per_device: Sequence["SectionSet"]) -> np.ndarray:
        if self._host_ok[arr.name]:
            return super().read(arr, per_device)
        dev = self._device[arr.name]
        out = torch.zeros(arr.shape, dtype=dev.dtype, device=self.device)
        for p, secs in enumerate(per_device):
            for sl in secs.iter_slices():
                out[sl] = dev[p][sl]
        self.d2h_transfers += 1
        return out.cpu().numpy()

    # -- protocol: message execution ------------------------------------
    def execute_messages(self, arr: "HDArray",
                         messages: Dict[Tuple[int, int], "SectionSet"],
                         kind: Optional["CommKind"] = None) -> None:
        if not messages:
            return
        self.sync_device(arr)
        dev = self._device[arr.name]
        key = kind.value if kind is not None else "p2p"
        if key not in self.copy_counts:
            key = "p2p"
        itemsize = arr.itemsize
        for (src, dst), secs in messages.items():
            s, d = dev[src], dev[dst]
            for sl in secs.iter_slices():
                d[sl] = s[sl]
            self.bytes_moved += secs.volume() * itemsize
            self.messages_executed += len(secs)
            self.copy_counts[key] += len(secs)
        self._host_ok[arr.name] = False

    # -- kernels --------------------------------------------------------
    def run_kernel(self, kernel, part_regions, arrays,
                   defs: Optional[Sequence[str]] = None, **kw) -> None:
        """Device kernels run on per-rank views of the resident
        tensors; anything else runs on the host mirrors (Sim
        semantics), after which only the arrays in ``defs`` (all
        touched arrays without it) must re-upload."""
        kernel = resolve_kernel(kernel, self.device_class)
        if getattr(kernel, "__hdarray_device__", False):
            self._run_device_kernel(kernel, part_regions, arrays, kw)
            return
        for a in arrays:
            self.sync_host(a)
        super().run_kernel(kernel, part_regions, arrays, **kw)
        stale = set(defs) if defs is not None else {a.name for a in arrays}
        for a in arrays:
            if a.name in stale:
                self._device_ok[a.name] = False

    def _run_device_kernel(self, kernel, part_regions, arrays, kw) -> None:
        self.last_rank_times = None      # no per-rank host timing on device
        for a in arrays:
            self.sync_device(a)
        defined = set()
        for p, region in enumerate(part_regions):
            if region.is_empty():
                continue
            bufs = {a.name: self._device[a.name][p] for a in arrays}
            res = kernel(region, bufs, **kw) or {}
            for name, val in res.items():
                if val is not bufs[name]:     # a new tensor, not a put
                    bufs[name].copy_(val)
                defined.add(name)
        for name in defined:
            self._host_ok[name] = False
        self.device_kernel_launches += 1

    # -- reductions -----------------------------------------------------
    def reduce_local(self, arr: "HDArray", per_device, op: str):
        """The local fold runs on the host mirrors, exactly like the
        Sim oracle — one d2h sync when the resident copy is newer."""
        self.sync_host(arr)
        return super().reduce_local(arr, per_device, op)
