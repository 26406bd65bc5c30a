"""The ops that reach DTensor in the four dry-run cells whose models once
asked DTensor for what some torch releases cannot place: deepseek-v3's
``train_4k`` (``aten.roll`` of the MTP head's shifted tokens and
labels), recurrentgemma's ``prefill_32k`` and ``decode_32k`` (a gate's
bias added to a partial product, which asks for a shard turned partial)
and xlstm's ``train_4k`` (``aten.flip`` in the backward of the mLSTM
chunk's ``cumsum``).  The torch this suite runs on may place each of
them anyway, so the cells' ops are recorded as they reach DTensor, in a
subprocess (a process holds one fake group at a time), and held to
what the models now do: no ``roll``, no ``flip``, no
``aten.add.Tensor`` that makes DTensor turn a ``Shard`` operand into a
``Partial``, and no ``aten.index_put`` (an embedding's backward) whose
values are sharded along an indexed dim, where torch 2.11's strategy
builds a shard of a negative dim (deepseek-v3's ``train_4k``, once its
``roll`` was gone).

An add of a partial sum to a sharded tensor is placed by the operand
that DTensor's pointwise rule follows (the one with the most shards,
then the most dims, then the first, in the torch releases whose rule is
that): where it is the partial one, the other operand's shard must
become a partial, which those releases cannot do (the recurrentgemma
cells' fault); where it is the sharded one, the partial is
reduce-scattered, which every release does (a residual add of an
attention output, a gradient accumulated in the backward).  So the test
holds each add whose operands are ``Partial`` and ``Shard`` on one mesh
dim to the second form.  The recorder and its two checks are in
``tests/torch_dryrun_recorder.py``, and are tested here on a fake group.

The helpers the models use instead (``models.common``: ``roll``,
``shardwise`` along a dim, ``add_bias``, ``gather_rows``) run the op
itself on a plain tensor: their values and gradients equal
``torch.roll``'s, ``torch.cumsum``'s, ``+``'s and indexing's bit for
bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.launch.dryrun import fake_process_group
from repro_torch.models.common import (add_bias, gather_rows, roll,
                                       shardwise)
from repro_torch.roofline.op_costs import OpCosts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [("deepseek-v3-671b", "train_4k"),
         ("recurrentgemma-2b", "prefill_32k"),
         ("recurrentgemma-2b", "decode_32k"),
         ("xlstm-125m", "train_4k")]

CODE = r'''
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from torch_dryrun_recorder import Recorder

DR.OpCosts = Recorder
for arch, shape in json.loads(sys.argv[1]):
    Recorder.ops, Recorder.bad = set(), []
    try:
        rec = DR.lower_cell(arch, shape, False, verbose=False,
                            cfg=get_config(arch).reduced(), global_batch=32,
                            seq_len=64)
        out = {"status": rec["status"], "colls": rec.get("collective_ops")}
    except Exception as e:
        out = {"status": "error", "error": repr(e)[-2000:]}
    out.update(ops=sorted(Recorder.ops), bad=Recorder.bad)
    print("CELL " + json.dumps([arch, shape, out]), flush=True)
'''


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_ops")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        os.path.join(REPO, d) for d in ("src", "tests")),
               REPRO_TORCH_RESULTS_DIR=str(tmp), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", CODE, json.dumps(CELLS)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    return {(a, s): rec for a, s, rec in (
        json.loads(ln[5:]) for ln in out.stdout.splitlines()
        if ln.startswith("CELL "))}


@pytest.mark.parametrize("arch, shape", CELLS)
def test_cell_reaches_dtensor_with_no_op_it_cannot_place(cells, arch, shape):
    rec = cells[arch, shape]
    assert rec["status"] == "ok", rec.get("error")
    assert "aten.add.Tensor" in rec["ops"] and rec["colls"]
    assert not {"aten.roll.default", "aten.flip.default"} & set(rec["ops"])
    assert rec["bad"] == []


# -- the helpers on plain tensors: the op itself, bit for bit -------------
def _grad(fn, x, seed):
    x = x.clone().requires_grad_()
    y = fn(x)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(y.shape)).astype(np.float32)).to(y.dtype)
    (dx,) = torch.autograd.grad(y, x, g)
    return y.detach(), dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift, dim", [(-1, 1), (3, 1), (-1, 0)])
def test_roll_is_torch_roll(dtype, shift, dim):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 11, 5)).astype(np.float32)).to(dtype)
    got = _grad(lambda t: roll(t, shift, dim), x, 1)
    want = _grad(lambda t: torch.roll(t, shift, dim), x, 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tokens = torch.arange(24).reshape(2, 12)
    assert torch.equal(roll(tokens, -1, 1), torch.roll(tokens, -1, 1))


def test_log_gate_prefix_sum_is_cumsum_of_logsigmoid():
    """xlstm's chunk: shardwise along time of logsigmoid then cumsum,
    against the two ops as the chunk ran them before, values and
    gradients."""
    fg = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 4, 64)).astype(np.float32) * 3)
    got = _grad(lambda f: shardwise(
        lambda u: torch.cumsum(F.logsigmoid(u), dim=-1), f, dim=-1), fg, 3)
    want = _grad(lambda f: torch.cumsum(F.logsigmoid(f), dim=-1), fg, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_bias_is_add(dtype):
    rng = np.random.default_rng(4)
    y, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((2, 7, 16), (16,)))
    got = add_bias(y, b)
    assert torch.equal(got, y + b)
    yy, bb = y.clone().requires_grad_(), b.clone().requires_grad_()
    g = torch.ones_like(got)
    want = torch.autograd.grad(yy + bb, (yy, bb), g)
    have = torch.autograd.grad(add_bias(yy, bb), (yy, bb), g)
    for a, w in zip(have, want):
        assert torch.equal(a, w)


def test_gather_rows_is_indexing():
    table = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (32, 8)).astype(np.float32))
    idx = torch.from_numpy(np.random.default_rng(6).integers(
        0, 32, (3, 9)))
    got = _grad(lambda t: gather_rows(t, idx), table, 7)
    want = _grad(lambda t: t[idx], table, 7)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the recorder's checks on a fake group ---------------------------------
@pytest.mark.parametrize("placement, flagged", [
    ("Shard(0)", True), ("Shard(1)", True), ("Shard(2)", False),
    ("Replicate()", False)])
def test_recorder_flags_index_put_values_sharded_on_an_indexed_dim(
        placement, flagged):
    """An embedding's backward: ``index_put`` of (B, T, D) row gradients
    into a (V, D) table at a (B, T) index.  Values sharded on the batch
    or the token dim (both indexed) are flagged, on the model dim not."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch_dryrun_recorder import index_put_on_indexed_dim

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        with FakeTensorMode():
            pl = [eval(placement, {"Shard": Shard, "Replicate": Replicate})]
            dst = DTensor.from_local(torch.empty(32, 8), mesh, [Replicate()],
                                     run_check=False)
            idx = DTensor.from_local(torch.empty(4, 16, dtype=torch.long),
                                     mesh, [Replicate()], run_check=False)
            values = DTensor.from_local(torch.empty(4, 16, 8), mesh, pl,
                                        run_check=False)
            got = index_put_on_indexed_dim(dst, [idx], values)
    assert got is flagged


@pytest.mark.parametrize("a, b, flagged", [
    (("Shard(0)", "Partial()"), ("Replicate()", "Shard(0)"), True),
    (("Replicate()", "Partial()"), ("Replicate()", "Shard(0)"), False),
    (("Shard(0)", "Partial()"), ("Replicate()", "Replicate()"), False),
    (("Shard(0)", "Shard(1)"), ("Replicate()", "Shard(0)"), False)])
def test_recorder_flags_an_add_that_turns_a_shard_partial(a, b, flagged):
    """A (B, W) product beside a (W,) bias on a (data, model) mesh of 2 x
    2: a product sharded on the batch and partial over "model" plus a
    bias sharded over "model" (recurrentgemma's gate before the fix) is
    flagged, since the rule follows the product (as many shards, more
    dims); a product partial alone is reduce-scattered onto the bias's
    shard (the rule follows the bias), and one with no partial is not
    flagged."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch_dryrun_recorder import add_turns_shard_partial

    names = {"Shard": Shard, "Replicate": Replicate, "Partial": Partial}
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(4, 8), mesh,
                                   [eval(p, names) for p in a],
                                   run_check=False)
            y = DTensor.from_local(torch.empty(8), mesh,
                                   [eval(p, names) for p in b],
                                   run_check=False)
            got = add_turns_shard_partial(x, y)
    assert got is flagged


# -- the helpers on DTensors: placements kept, collectives counted --------
def test_helpers_on_a_fake_group_keep_placements_and_count_collectives():
    """On rank 0 of 4: rolling along an unsharded dim is local; along a
    sharded one it gathers that dim once and shards it again; a partial
    product's bias add reduce-scatters onto the bias's sharded dim."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Shard

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(2, 8, 3), mesh, [Shard(0)],
                                   run_check=False)
            s = DTensor.from_local(torch.empty(8, 2, 3), mesh, [Shard(1)],
                                   run_check=False)
            y = DTensor.from_local(torch.empty(8, 5, 16), mesh, [Partial()],
                                   run_check=False)
            b = DTensor.from_local(torch.empty(4), mesh, [Shard(0)],
                                   run_check=False)
            with OpCosts() as local:
                rx = roll(x, -1, 1)
            with OpCosts() as gathered:
                rs = roll(s, -1, 1)
            with OpCosts() as summed:
                out = add_bias(y, b)
    assert rx.placements == x.placements and rx.shape == x.shape
    assert local.cost.coll_ops == {}
    assert rs.placements == s.placements and rs.shape == s.shape
    assert gathered.cost.coll_ops == {"all-gather": 1}
    assert out.placements == (Shard(2),) and out.shape == (8, 5, 16)
    assert summed.cost.coll_ops == {"reduce-scatter": 1}
