"""The port's dry-run (``repro_torch.launch.dryrun.lower_cell``) on the
(16, 16) mesh of a fake 256-rank process group, in the cells whose
ops once had no DTensor form: the moe dispatch (``searchsorted``, the
router's counts), xlstm's ``log_sigmoid`` and sLSTM scan, and
recurrentgemma's ring cache write.

The cells run one after another in one subprocess (a process holds one
fake group at a time), each counted by ``OpCosts`` with every
collective's payload kept by the innermost ``repro_torch`` function
that issued it.  Reduced configs run at 32 x 64 tokens:

* qwen3-moe-30b-a3b ``train_4k`` with 16 experts, which divide the
  "model" axis: ``impl="auto"`` takes the expert-parallel dispatch;
* qwen3-moe-30b-a3b ``decode_32k`` at its exact config (128 experts, 8
  a column): each of its 48 moe layers books one all-reduce of the
  partial outputs, 8 x 1 x 2048 bf16 values (128 rows over 16 data
  ranks, one token, d_model 2048);
* deepseek-v3-671b ``decode_32k`` (8 experts on 16 columns: the sort,
  gathered whole on purpose, its all-gathers counted);
* xlstm-125m ``train_4k`` and ``decode_32k``;
* recurrentgemma-2b ``decode_32k``.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [
    # (name, arch, shape, reduced, n_experts)
    ("qwen3_train_ep", "qwen3-moe-30b-a3b", "train_4k", True, 16),
    ("qwen3_decode_exact", "qwen3-moe-30b-a3b", "decode_32k", False, None),
    ("dsv3_decode", "deepseek-v3-671b", "decode_32k", True, None),
    ("xlstm_train", "xlstm-125m", "train_4k", True, None),
    ("xlstm_decode", "xlstm-125m", "decode_32k", True, None),
    ("rg_decode", "recurrentgemma-2b", "decode_32k", True, None),
]

CODE = r'''
import dataclasses, json, sys, time
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.roofline.op_costs import OpCosts

class Tagged(OpCosts):
    """OpCosts keeping each collective's (kind, payload) by its tag."""
    last = None

    def __init__(self):
        super().__init__(tag=True)
        self.colls = {}
        Tagged.last = self

    def _add(self, tag, flops=0.0, nbytes=0.0, ftype=None, coll_kind=None,
             coll_bytes=0.0):
        super()._add(tag, flops, nbytes, ftype, coll_kind, coll_bytes)
        if coll_kind:
            self.colls.setdefault(tag.split(" | ")[1], []).append(
                [coll_kind, coll_bytes])

DR.OpCosts = Tagged
for name, arch, shape, reduced, n_exp in json.loads(sys.argv[1]):
    kw = {}
    if reduced:
        cfg = get_config(arch).reduced()
        if n_exp:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=n_exp))
        kw = dict(cfg=cfg, global_batch=32, seq_len=64)
    t0 = time.time()
    try:
        rec = DR.lower_cell(arch, shape, False, verbose=False, **kw)
        rec["colls_by_site"] = Tagged.last.colls
    except Exception as e:
        rec = {"status": "error", "error": repr(e)[-2000:]}
    rec["seconds"] = time.time() - t0
    print("CELL " + json.dumps([name, rec]), flush=True)
'''


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_RESULTS_DIR=str(tmp), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", CODE, json.dumps(CELLS)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = dict(json.loads(ln[5:]) for ln in out.stdout.splitlines()
                if ln.startswith("CELL "))
    assert not os.listdir(tmp)            # lower_cell writes no record
    return recs


def _site(rec, fn, kind):
    """The payloads of ``kind`` collectives issued in ``fn`` (a prefix of
    the function's qualified name: ``models.moe.`` takes the module)."""
    return [b for site, colls in rec["colls_by_site"].items()
            if site.startswith(fn) for k, b in colls if k == kind]


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_cell_traces(cells, name):
    rec = cells[name]
    assert rec["status"] == "ok", rec.get("error")
    rl = rec["roofline"]
    assert rl["n_chips"] == 256 and rl["hlo_flops"] > 0
    assert rec["memory"]["total_hbm_bytes"] > 0


def test_qwen3_train_with_divisible_experts_takes_ep(cells):
    """4 layers: each forward's psum over "model" (and again in the
    backward's recompute), the shards' aux mean."""
    rec = cells["qwen3_train_ep"]
    assert rec["status"] == "ok", rec.get("error")
    assert len(_site(rec, "models.moe._moe_ffn_ep", "all-reduce")) >= 2 * 4


def test_qwen3_decode_books_one_model_all_reduce_a_layer(cells):
    rec = cells["qwen3_decode_exact"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["rules"] == "serve"
    B_loc, D = 128 // 16, 2048
    assert _site(rec, "models.moe._moe_ffn_ep", "all-reduce") == \
        [B_loc * 1 * D * 2] * 48


def test_reduced_dsv3_gathers_the_sort_whole(cells):
    """8 experts do not divide 16 columns: the sort on every rank, its
    operands gathered (counted) in the moe function itself."""
    rec = cells["dsv3_decode"]
    assert rec["status"] == "ok", rec.get("error")
    assert _site(rec, "models.moe.", "all-gather")
    assert not _site(rec, "models.moe.", "all-reduce")
