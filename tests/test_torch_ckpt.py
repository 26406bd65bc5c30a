"""The port's ``CheckpointManager`` (``repro_torch.ckpt``) on the CPU,
against the reference's where both write the same files.

* ``save_runtime`` / ``restore_runtime`` round trips on the port's Sim
  oracle and torch backend: values, the ``__restore_<name>`` comm_log
  entries, the restore counters, and the transfer counters of the
  resident backend (a snapshot downloads each array once, a restore
  uploads it once);
* the coherence gate rejects an uncovered restore partition before it
  touches an array, its metadata or the log;
* atomicity and rotation: only ``_COMMITTED`` steps count, ``keep``
  bounds the directory, and the layout (npz keys, ``meta.json``)
  equals the reference's for the same program;
* tensor trees through ``save`` / ``restore`` (bfloat16 bits kept,
  each leaf back on its ``like`` leaf's dtype and device), blocking
  and asynchronous;
* a checkpoint that the reference's ``save_runtime`` wrote restores
  into the port's runtime with equal values, and the other way round.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.ckpt.checkpoint import CheckpointManager as RefCM
from repro_torch.ckpt import CheckpointManager

N, NPROC = 12, 4


def _runtime(mod, backend):
    if mod is port and backend == "torch":
        return port.HDArrayRuntime(NPROC, backend="torch", device="cpu")
    return mod.HDArrayRuntime(NPROC, backend="sim")


def _arrays(mod, rt, seed=0):
    """Two arrays written over row and column partitions, then one
    repartition step (so the coherent copies sit on other ranks than
    the writes put them)."""
    rng = np.random.default_rng(seed)
    x = rt.create("x", (N, N))
    y = rt.create("y", (N, 6), dtype=np.int32)
    prow, pcol = rt.partition_row((N, N)), rt.partition_col((N, N))
    rt.write(x, rng.standard_normal((N, N)).astype(np.float32), prow)
    rt.write(y, rng.integers(-50, 50, (N, 6)).astype(np.int32),
             rt.partition_row((N, 6)))
    rt.repartition(x, prow, pcol)
    return x, y


@pytest.mark.parametrize("backend", ["sim", "torch"])
def test_runtime_round_trip(tmp_path, backend):
    rt = _runtime(port, backend)
    x, y = _arrays(port, rt)
    want = rt.read_coherent(x), rt.read_coherent(y)
    cm = CheckpointManager(str(tmp_path))
    ex = rt.executor
    d2h = getattr(ex, "d2h_transfers", 0)
    cm.save_runtime(7, rt)
    if backend == "torch":
        assert ex.d2h_transfers - d2h == 2        # one download per array
    # clobber both arrays, then restore onto the 3 survivors of rank 1
    rt.write(x, np.zeros((N, N), np.float32), rt.partition_row((N, N)))
    rt.write(y, np.ones((N, 6), np.int32), rt.partition_row((N, 6)))
    h2d = getattr(ex, "h2d_transfers", 0)
    n_log = len(rt.comm_log)
    assert cm.restore_runtime(rt, live=[0, 2, 3]) == 7
    if backend == "torch":
        assert ex.h2d_transfers - h2d == 2        # one upload per array
    assert np.array_equal(rt.read_coherent(x), want[0])
    assert np.array_equal(rt.read_coherent(y), want[1])
    assert [e[0] for e in rt.comm_log[n_log:]] == ["__restore_x",
                                                   "__restore_y"]
    assert rt.comm_log[n_log][1] == N * N * 4
    assert rt.planner.stats.checkpoint_restores == 2
    # the restore layout owns everything: rank 1 holds nothing
    assert x.valid[1].is_empty() and not x.valid[0].is_empty()
    assert cm.stats["saves"] == 1 and cm.stats["restores"] == 1
    assert cm.stats["save_bytes"] == cm.stats["restore_bytes"] \
        == N * N * 4 + N * 6 * 4


@pytest.mark.parametrize("backend", ["sim", "torch"])
def test_restore_gate_rejects_uncovered_partition_untouched(tmp_path,
                                                            backend):
    rt = _runtime(port, backend)
    x, y = _arrays(port, rt)
    cm = CheckpointManager(str(tmp_path))
    cm.save_runtime(0, rt)
    rt.write(x, np.full((N, N), 3.0, np.float32), rt.partition_row((N, N)))
    before = (rt.read_coherent(x), rt.read_coherent(y),
              [x.valid[p] for p in range(NPROC)], list(rt.comm_log),
              rt.planner.stats.checkpoint_restores, list(x.events))
    holed = rt.partition_manual((N, N), [
        port.Box.make((0, 4), (0, N)), port.Box.make((4, 8), (0, N)),
        port.Box.make((0, 0), (0, 0)), port.Box.make((9, N), (0, N))])
    with pytest.raises(ValueError, match="uncovered"):
        # y (restored first in the inventory's order after x) would
        # pass; x's hole rejects the whole restore before either moves
        cm.restore_runtime(rt, parts={"x": holed})
    after = (rt.read_coherent(x), rt.read_coherent(y),
             [x.valid[p] for p in range(NPROC)], list(rt.comm_log),
             rt.planner.stats.checkpoint_restores, list(x.events))
    assert np.array_equal(after[0], before[0])
    assert np.array_equal(after[1], before[1])
    assert after[2:] == before[2:]


def test_rotation_commit_marker_and_layout_match_reference(tmp_path):
    dirs = {}
    for name, mod, cm_cls in (("ref", ref, RefCM), ("port", port,
                                                     CheckpointManager)):
        d = tmp_path / name
        rt = _runtime(mod, "sim")
        _arrays(mod, rt)
        cm = cm_cls(str(d), keep=2)
        for step in range(5):
            cm.save_runtime(step, rt)
        # a save torn before its marker: ignored, never restored
        os.makedirs(d / "step_00000009.tmp")
        os.makedirs(d / "step_00000008")
        assert cm.list_steps() == [3, 4] and cm.latest_step() == 4
        dirs[name] = d
    for step in (3, 4):
        sub = f"step_{step:08d}"
        metas = [json.load(open(dirs[k] / sub / "meta.json"))
                 for k in ("ref", "port")]
        assert metas[0] == metas[1]
        npz = [np.load(dirs[k] / sub / "shard_0.npz") for k in ("ref", "port")]
        assert sorted(npz[0].files) == sorted(npz[1].files)
        for key in npz[0].files:
            assert npz[0][key].dtype == npz[1][key].dtype
            assert np.array_equal(npz[0][key], npz[1][key])
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["ref"]))


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((5, 3), generator=g),
                       "wb": torch.randn((4, 4), generator=g).to(
                           torch.bfloat16),
                       "layers": [torch.randn(3, generator=g).half(),
                                  torch.arange(6, dtype=torch.int32)]},
            "step": np.int64(seed), "host": np.arange(4.0)}


@pytest.mark.parametrize("blocking", [True, False])
def test_tensor_tree_save_restore_bits(tmp_path, blocking):
    cm = CheckpointManager(str(tmp_path), keep=1)
    state = _tree(1)
    if blocking:
        cm.save(3, state)
    else:
        cm.save_async(3, state)
        state["params"]["w"].zero_()      # the snapshot is already taken
        cm.wait()
    step, got = cm.restore(None, _tree(2))
    want = _tree(1)
    assert step == 3
    flat_got = got["params"]["layers"] + [got["params"]["w"],
                                          got["params"]["wb"]]
    flat_want = want["params"]["layers"] + [want["params"]["w"],
                                            want["params"]["wb"]]
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == w.dtype and g.device == w.device
        assert torch.equal(g.view(torch.uint8) if g.dtype == torch.bfloat16
                           else g, w.view(torch.uint8)
                           if w.dtype == torch.bfloat16 else w)
    assert int(got["step"]) == 1 and np.array_equal(got["host"], np.arange(4.0))
    data = np.load(tmp_path / "step_00000003" / "shard_0.npz")
    assert data["params/wb"].dtype == np.uint16      # bf16 bits
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(None, want)


@pytest.mark.parametrize("backend", ["sim", "torch"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer, backend):
    """One package's ``save_runtime`` file restores into the other's
    runtime (the port on ``backend``; the reference on Sim)."""
    src_mod, dst_mod = (ref, port) if writer == "ref" else (port, ref)
    src = _runtime(src_mod, backend if src_mod is port else "sim")
    _arrays(src_mod, src, seed=5)
    want = {n: src.read_coherent(a) for n, a in src.arrays.items()}
    (RefCM if writer == "ref" else CheckpointManager)(
        str(tmp_path)).save_runtime(11, src)
    dst = _runtime(dst_mod, backend if dst_mod is port else "sim")
    _arrays(dst_mod, dst, seed=6)                  # other values
    reader = CheckpointManager if dst_mod is port else RefCM
    assert reader(str(tmp_path)).restore_runtime(dst, live=[1, 3]) == 11
    for n, a in dst.arrays.items():
        assert np.array_equal(dst.read_coherent(a), want[n])
