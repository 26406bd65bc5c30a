"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake process
group: the reference's cell (``tests/test_dryrun_subprocess.py``) in a
subprocess of its own, its per-rank parameter bytes against the
reference's local shard sizes, a reduced train cell on the (2, 16, 16)
mesh, and the record cache's rules.

Records go to a temporary ``REPRO_TORCH_RESULTS_DIR``; nothing is
written under the reference's ``results/dryrun``.
"""
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_RESULTS = os.path.join(REPO, "results", "dryrun")


def _snapshot(path):
    if not os.path.isdir(path):
        return {}
    return {n: os.stat(os.path.join(path, n)).st_mtime_ns
            for n in os.listdir(path)}


def _env(tmp):
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                REPRO_TORCH_RESULTS_DIR=str(tmp))


@pytest.fixture(scope="module")
def whisper_cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    before = _snapshot(REF_RESULTS)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "whisper-base", "--shape", "decode_32k",
         "--mesh", "single", "--force"],
        cwd=REPO, env=_env(tmp), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert _snapshot(REF_RESULTS) == before
    with open(os.path.join(str(tmp), "whisper-base__decode_32k__pod16x16.json")
              ) as f:
        return json.load(f)


def test_dryrun_cell_runs_on_the_production_mesh(whisper_cell):
    rec = whisper_cell
    assert rec["status"] == "ok", rec.get("error")
    rl = rec["roofline"]
    assert rl["n_chips"] == 256
    assert rl["hlo_flops"] > 0 and rl["hlo_bytes"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    # the serve rules were selected for a decode cell
    assert rec["rules"] == "serve"
    assert rec["memory"]["total_hbm_bytes"] > 0
    assert rl["mem_per_device"] == rec["memory"]["total_hbm_bytes"]


def test_param_bytes_equal_the_reference_shards(whisper_cell):
    """Rank 0's parameter bytes: the reference's parameters in bf16 (its
    ``_cast_shapes``), each leaf's local shard under its partition spec
    on the (16, 16) mesh with the serve rules."""
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh

    from repro.configs import get_config
    from repro.models import build
    from repro.train import sharding as REF

    bundle = build(get_config("whisper-base"))
    cell = {}

    def only_params(key):
        p, s = bundle.init(key)
        cell["s"] = s
        return p
    shapes = jax.eval_shape(only_params, jax.random.PRNGKey(0))
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rules = REF.serve_rules()
    specs = jax.tree.leaves(cell["s"], is_leaf=lambda x: isinstance(
        x, tuple) and all(isinstance(s, str) for s in x))
    total = 0
    for spec, leaf in zip(specs, jax.tree.leaves(shapes)):
        local = list(leaf.shape)
        for d, e in enumerate(REF.spec_to_pspec(spec, leaf.shape, mesh,
                                                rules)):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                local[d] = -(-local[d] // mesh.shape[a])
        total += math.prod(local) * 2                 # bf16
    assert whisper_cell["memory"]["param_bytes"] == total


def test_reduced_train_cell_on_the_multi_pod_mesh(tmp_path):
    """Reduced yi-9b's train step, 32 x 64 tokens, on 512 fake ranks:
    the batch over pod x data leaves one row a rank, so the microbatches
    halve to 1; FSDP gathers and gradient reductions cross the group."""
    code = (
        "import json\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch.dryrun import lower_cell\n"
        "rec = lower_cell('yi-9b', 'train_4k', True, verbose=False,\n"
        "                 cfg=get_config('yi-9b').reduced(),\n"
        "                 global_batch=32, seq_len=64)\n"
        "print(json.dumps(rec))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "pod2x16x16"
    assert rec["rules"] == "baseline"
    assert rec["train_cfg"]["microbatches"] == 1
    rl = rec["roofline"]
    assert rl["n_chips"] == 512 and rl["hlo_flops"] > 0
    assert rl["coll_by_kind"].get("all-gather", 0) > 0
    assert rl["coll_by_kind"].get("all-reduce", 0) > 0
    assert not os.listdir(tmp_path)           # lower_cell writes no record


def test_error_records_are_never_cache_hits(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    calls = []

    def failing(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("aten.foo.default has no sharding strategy")
    monkeypatch.setattr(dryrun, "lower_cell", failing)
    for _ in range(2):
        rec = dryrun.run_cell("yi-9b", "train_4k", False)
        assert rec["status"] == "error" and "aten.foo" in rec["error"]
    assert len(calls) == 2
    good = {"arch": "yi-9b", "shape": "train_4k", "status": "ok"}
    with open(os.path.join(str(tmp_path), "yi-9b__train_4k__pod16x16.json"),
              "w") as f:
        json.dump(good, f)
    assert dryrun.run_cell("yi-9b", "train_4k", False) == good   # a hit
    assert dryrun.run_cell("yi-9b", "train_4k", False,
                           force=True)["status"] == "error"
    with open(os.path.join(str(tmp_path),
                           "yi-9b__train_4k__pod16x16.json")) as f:
        assert json.load(f) == good     # the good record is kept


def test_list_shows_every_cell(capsys):
    from repro_torch.launch import dryrun

    dryrun.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 40
    assert any("yi-9b" in ln and "long_500k" in ln and "SKIP" in ln
               for ln in lines)
    assert any("xlstm-125m" in ln and "long_500k" in ln and "run" in ln
               for ln in lines)
