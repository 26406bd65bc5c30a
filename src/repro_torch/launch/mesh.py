"""Production mesh construction, the port of the reference's
``repro/launch/mesh.py`` onto ``torch.distributed.DeviceMesh``.

Functions, not module constants: a DeviceMesh needs a process group of
at least as many ranks, and importing this module touches none.

Mesh layout (the reference's: 256 devices a pod):
  single-pod : (16, 16)      axes ("data", "model")
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")

Axis roles under the baseline rules (train/sharding.py):
  pod    — pure data parallel across pods (the grad all-reduce)
  data   — data parallel + FSDP param sharding (ZeRO within a pod)
  model  — tensor parallel (heads/ffn/vocab) + expert parallel (MoE)

No machine here holds 256 cards: the dry-run (``launch/dryrun.py``)
builds these meshes over a fake process group of 256 or 512 ranks.  The
reference's ``ensure_host_devices`` and ``make_host_mesh`` (placeholder
XLA host devices for its ``JaxExecutor``) have no counterpart: the
port's ``TorchExecutor`` runs its logical ranks on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices or a process group:
    what the sharding rules and the planner read (``shape`` is the
    {axis: size} dict that :func:`~repro_torch.train.sharding.axis_sizes`
    takes)."""
    dims: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _device_mesh(ms: MeshShape, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {ms.dims} needs a process group of {ms.size} ranks; "
            f"run it through launch/dryrun.py, which makes a fake one")
    world = dist.get_world_size()
    if world != ms.size:
        raise RuntimeError(f"mesh {ms.dims} needs {ms.size} ranks, the "
                           f"process group has {world}")
    return init_device_mesh(device_type, ms.dims, mesh_dim_names=ms.axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (16, 16) or (2, 16, 16) DeviceMesh over the current process
    group, which must have exactly 256 or 512 ranks."""
    return _device_mesh(production_shape(multi_pod=multi_pod), device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cpu"):
    """A small mesh over a process group of ``prod(shape)`` ranks
    (tests)."""
    return _device_mesh(MeshShape(tuple(shape), tuple(axes)), device_type)
