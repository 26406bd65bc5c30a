"""Atomic, rotated, optionally asynchronous checkpoints (the
fault-tolerance substrate), the port of the reference's
``repro/ckpt/checkpoint.py``.

Layout:  <dir>/step_<N>/
             meta.json           (step, keys, array inventory)
             shard_<host>.npz    (this host's leaves)
             _COMMITTED          (atomicity marker, written LAST)

Guarantees:
  * atomic: writes go to step_<N>.tmp/, fsynced, then renamed; a crash
    mid-save never corrupts the restore point (restore scans for the
    newest _COMMITTED step),
  * async: ``save_async`` copies the leaves to host memory and writes
    on a worker thread,
  * keep-k rotation.

Two state families share the directory format:

  * tensor trees (``save`` / ``restore``): nested dicts and lists whose
    leaves are tensors or numpy arrays, keyed by their path
    (``"a/b/0"``).  Leaves numpy has no dtype for (bfloat16, the float8
    types) are stored as the unsigned integers of their size, bit for
    bit; ``restore(like)`` views them back as the matching leaf of
    ``like`` and puts each on that leaf's device,
  * HDArrayRuntime state (``save_runtime`` / ``restore_runtime``):
    global coherent snapshots of every HDArray, keyed ``hda::<name>``.
    The snapshot reads through the executor's ``read`` (on the torch
    backend the coherent sections are assembled on the device and
    downloaded once, never every rank's full-size copy).  The restore
    is a PLANNED write through the Executor protocol
    (``executor.write`` + ``sync_device``), in place on a resident
    backend, so captured programs keep their addresses.

``stats`` counts saves and restores with their host-clock seconds and
payload bytes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_unflatten

# numpy's unsigned integer of each itemsize, and torch's signed one
# (torch's unsigned types beyond uint8 support few operations)
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_SINT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def to_host(leaf) -> np.ndarray:
    """A copy of a leaf as a numpy array on the host (a snapshot that
    later in-place updates cannot reach): a tensor whose dtype numpy
    lacks comes back as the unsigned integers of its size, bit for
    bit."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype.is_floating_point and t.dtype not in _NUMPY_FLOATS:
        size = t.element_size()
        return t.view(_SINT[size]).numpy().view(_UINT[size])
    return t.numpy()


def from_host(arr: np.ndarray, like):
    """The inverse of :func:`to_host` for a leaf shaped like ``like``:
    a tensor of ``like``'s dtype on ``like``'s device (bit views where
    the dtypes differ), or a numpy array when ``like`` is not a
    tensor."""
    if not isinstance(like, torch.Tensor):
        return np.asarray(arr)
    # ascontiguousarray makes a 0-d array 1-d: keep the shape (an
    # optimizer's step counter is 0-d)
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        arr = arr.view(f"i{arr.dtype.itemsize}")
    t = torch.from_numpy(arr)
    if t.dtype != like.dtype:
        t = t.view(like.dtype)
    return t.to(like.device)


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of a tree of dicts, lists and tuples (NamedTuples
    such as an optimizer state included), in tree_leaves' order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_leaf_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: Optional[threading.Thread] = None
        self.stats = {"saves": 0, "save_s": 0.0, "save_bytes": 0,
                      "restores": 0, "restore_s": 0.0, "restore_bytes": 0}
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        host = {k: to_host(v) for k, v in _leaf_paths(state).items()}
        self._submit(step, host, None, blocking)

    def save_async(self, step: int, state: Any) -> None:
        self.save(step, state, blocking=False)

    def save_runtime(self, step: int, rt, blocking: bool = True) -> None:
        """Checkpoint an HDArrayRuntime's arrays as GLOBAL coherent
        snapshots (each assembled by the executor's read path), so a
        restore can land on ANY partition over ANY surviving mesh — the
        checkpoint is layout-free.  Every array must have coherent
        cover; a torn mid-commit state has no global value to
        snapshot.  On a metadata-only executor (``holds_data=False``)
        the payload is skipped and only the array inventory is
        recorded."""
        t0 = time.perf_counter()
        holds = getattr(rt.executor, "holds_data", True)
        host: Dict[str, np.ndarray] = {}
        inventory: Dict[str, Dict[str, Any]] = {}
        for name, arr in rt.arrays.items():
            if not arr.coherent_cover():
                raise ValueError(
                    f"checkpoint at step {step}: array {name!r} has no "
                    "coherent cover (mid-commit state cannot be "
                    "snapshotted)")
            inventory[name] = {"shape": list(arr.shape),
                               "dtype": arr.dtype.str}
            if holds:
                host["hda::" + name] = rt.read_coherent(arr)
        extra = {"kind": "hdarrays", "holds_data": holds,
                 "arrays": inventory}
        self._submit(step, host, extra, blocking, t0)

    def _submit(self, step: int, host: Dict[str, np.ndarray],
                extra: Optional[Dict[str, Any]], blocking: bool,
                t0: Optional[float] = None) -> None:
        if t0 is None:
            t0 = time.perf_counter()
        if blocking:
            self._write(step, host, extra, t0)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra, t0),
                daemon=True)
            self._thread.start()

    def restore_runtime(self, rt, step: Optional[int] = None,
                        parts: Optional[Dict[str, int]] = None,
                        live: Optional[Sequence[int]] = None) -> int:
        """Restore every checkpointed array into `rt` as a PLANNED
        write: the payload routes through the Executor protocol
        (``write`` + ``sync_device``, so a device-resident backend
        re-stages the shards, in place, and its transfer counters see
        the crossing), and the coherence metadata is rebuilt from the
        restore partition (:meth:`HDArray.record_restore`), which busts
        the §4.2 plan caches for the restored arrays.

        ``parts`` maps array name -> restore partition id; arrays not
        named there (or when ``parts`` is None) restore onto an even
        dim-0 split over the ``live`` ranks (all ranks by default).
        The coherence gate rejects any restore partition that leaves a
        region of the array uncovered — BEFORE any state is touched.
        Returns the restored step number."""
        from repro_torch.core.sections import SectionSet
        from repro_torch.ft.faults import survivor_partition

        self.wait()
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        holds = (getattr(rt.executor, "holds_data", True)
                 and meta.get("holds_data", True))
        data = (np.load(os.path.join(d, f"shard_{self.host_id}.npz"))
                if holds else None)
        names = [n for n in meta.get("arrays", rt.arrays) if n in rt.arrays]
        # gate first: reject the whole restore before mutating anything
        layouts = {}
        for name in names:
            arr = rt.arrays[name]
            if parts is not None and name in parts:
                pid = parts[name]
            else:
                pid = survivor_partition(
                    rt, arr.shape,
                    live if live is not None else range(rt.nproc))
            part = rt.parts[pid]
            per_device = tuple(
                rt._clip_region_to_array(part.region(p), arr)
                for p in range(rt.nproc))
            cover = SectionSet.empty(arr.ndim)
            for s in per_device:
                cover = cover.union(s)
            if cover != SectionSet.full(arr.shape):
                raise ValueError(
                    f"restore of {name!r} at step {step}: partition "
                    f"{pid} leaves regions of the array uncovered — "
                    "restoring would lose checkpointed sections")
            layouts[name] = per_device
        payload_bytes = 0
        for name in names:
            arr = rt.arrays[name]
            per_device = layouts[name]
            payload = np.asarray(data["hda::" + name]) if holds else None
            if payload is not None:
                payload_bytes += payload.nbytes
            rt.executor.write(arr, payload, per_device)
            arr.record_restore(per_device)
            # re-stage device residency NOW (counted h2d on resident
            # backends) instead of leaving a dirty mirror for the next
            # kernel to trip over mid-pipeline
            rt.executor.sync_device(arr)
            nbytes = sum(s.volume() for s in per_device) * arr.itemsize
            rt.comm_log.append(
                (f"__restore_{name}", nbytes, ((name, "restore", nbytes),)))
            rt.planner.stats.checkpoint_restores += 1
        self.stats["restores"] += 1
        self.stats["restore_s"] += time.perf_counter() - t0
        self.stats["restore_bytes"] += payload_bytes
        return step

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray],
               extra_meta: Optional[Dict[str, Any]], t0: float) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"), **host)
        meta = {"step": step, "n_hosts": self.n_hosts,
                "keys": sorted(host.keys())}
        if extra_meta:
            meta.update(extra_meta)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        # commit marker last, then atomic rename
        open(os.path.join(tmp, "_COMMITTED"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._rotate()
        self.stats["saves"] += 1
        self.stats["save_s"] += time.perf_counter() - t0
        self.stats["save_bytes"] += sum(a.nbytes for a in host.values())

    def _rotate(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "_COMMITTED")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any) -> Tuple[int, Any]:
        """Restore into the structure of `like`: each leaf takes the
        dtype and device of the matching leaf of ``like`` (the elastic
        restart onto another device is a ``like`` on that device)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        data = np.load(os.path.join(d, f"shard_{self.host_id}.npz"))
        # _leaf_paths walks the tree in tree_leaves' order
        return step, tree_unflatten(like, [
            from_host(data[k], leaf) for k, leaf in _leaf_paths(like).items()])
