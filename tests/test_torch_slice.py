"""The port's main path as a whole, on the CPU, against the reference.

Two programs run through ``repro_torch`` (``backend="torch"``,
``device="cpu"``, so every kernel runs its plain PyTorch version) and
through ``repro`` on its ``sim`` oracle, with the same numpy inputs:

  * the ping-pong Jacobi pipeline of ``make_jacobi_kernel`` over an
    interior row partition — values and ``comm_log`` identical;
  * the quickstart sequence (examples/quickstart.py): GEMM, a second
    GEMM that moves nothing, reduce(sum) over a column partition and a
    weighted (2, 1, 1, 1) repartition — ``comm_log`` identical, values
    within the quickstart's own rtol 2e-4 (the two CPU products sum in
    different orders).

Import hygiene is checked here too: the port and ``chip_smoke.py``
import neither jax nor the reference package, and the smoke run fails
without a card.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
import repro.kernels.hd as ref_hd
import repro_torch.core as port
import repro_torch.kernels.hd as port_hd
from repro_torch.kernels.gemm_hd import kernel as gemm_kernel
from repro_torch.kernels.stencil_hd import kernel as jacobi_kernel

ROOT = Path(__file__).resolve().parents[1]
NPROC = 4


def _runtime(mod, backend=None):
    if mod is port:
        if backend == "sim":
            return port.HDArrayRuntime(NPROC, backend="sim")
        return port.HDArrayRuntime(NPROC, backend="torch", device="cpu")
    return ref.HDArrayRuntime(NPROC, backend="sim")


# ----------------------------------------------------------------------
# Jacobi ping-pong pipeline
# ----------------------------------------------------------------------
def _jacobi_pipeline(mod, rt, shape, sweeps, **kw):
    M, N = shape
    hd = port_hd if mod is port else ref_hd
    init = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    A, B = rt.create("A", shape), rt.create("B", shape)
    pd = rt.partition_row(shape)
    pw = rt.partition_row(shape, region=mod.Box.make((1, M - 1), (1, N - 1)))
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    ab = hd.make_jacobi_kernel("A", "B", **kw)
    ba = hd.make_jacobi_kernel("B", "A", **kw)
    fp = mod.stencil(2, 1)
    rt.run_pipeline([
        dict(kernel_name="jab", part_id=pw, kernel=ab, arrays=[A, B],
             uses={"A": fp}, defs={"B": mod.IDENTITY_2D}) if i % 2 == 0 else
        dict(kernel_name="jba", part_id=pw, kernel=ba, arrays=[A, B],
             uses={"B": fp}, defs={"A": mod.IDENTITY_2D})
        for i in range(sweeps)])
    return rt.read_coherent(A), rt.read_coherent(B)


@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
@pytest.mark.parametrize("shape", [(64, 64), (97, 120)])
def test_jacobi_pipeline_identical_to_reference(shape, ref_impl):
    sweeps = 6
    jacobi_kernel.jacobi_cuda.launches = 0
    rt, rt_ref = _runtime(port), _runtime(ref)
    got = _jacobi_pipeline(port, rt, shape, sweeps)
    want = _jacobi_pipeline(ref, rt_ref, shape, sweeps, impl=ref_impl)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert rt.comm_log == rt_ref.comm_log
    assert {k for _n, _b, arrs in rt.comm_log[-sweeps:]
            for _a, k, _b in arrs} == {"halo", "none"}
    ex = rt.executor
    assert ex.device_kernel_launches == sweeps
    assert (ex.h2d_transfers, ex.d2h_transfers) == (2, 2)
    # a CPU tensor runs the plain version: the CUDA kernel never launched
    assert jacobi_kernel.jacobi_cuda.launches == 0


def test_jacobi_pipeline_same_on_port_sim_and_torch():
    """One kernel source runs on the port's host oracle (numpy mirrors
    viewed as CPU tensors) and on its resident executor."""
    shape = (40, 33)
    got = _jacobi_pipeline(port, _runtime(port), shape, 5)
    want = _jacobi_pipeline(port, _runtime(port, "sim"), shape, 5)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ----------------------------------------------------------------------
# the quickstart sequence
# ----------------------------------------------------------------------
def _quickstart(mod, n, **kw):
    hd = port_hd if mod is port else ref_hd
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)
    rt = _runtime(mod)
    part = rt.partition_row((n, n))
    hA, hB, hC = (rt.create(s, (n, n)) for s in "abc")
    rt.write(hA, a, part)
    rt.write(hB, b, part)
    rt.write(hC, np.zeros((n, n), np.float32), part)
    mm = hd.make_gemm_kernel("a", "b", "c", **kw)
    step = dict(uses={"a": mod.ROW_ALL, "b": mod.COL_ALL},
                defs={"c": mod.IDENTITY_2D})
    plan1 = rt.apply_kernel("gemm", part, mm, [hA, hB, hC], **step)
    c1 = rt.read(hC, part)
    plan2 = rt.apply_kernel("gemm", part, mm, [hA, hB, hC], **step)
    total = rt.reduce(hC, "sum", rt.partition_col((n, n)))
    p_w = rt.partition_row((n, n), weights=(2, 1, 1, 1))
    rt.repartition(hC, part, p_w)
    out = dict(c1=c1, c2=rt.read(hC, p_w), total=total,
               bytes=(plan1.bytes_total, plan2.bytes_total),
               kinds={ap.array: ap.kind.value for ap in plan1.arrays},
               rows0=rt.parts[p_w].region(0).bounds[0],
               lowered=[op.describe() for op in rt.lowered_schedule(plan1)])
    return rt, out, a @ b


@pytest.mark.parametrize("n", [64, 128])
def test_quickstart_sequence_matches_reference(n):
    gemm_kernel.gemm_cuda.launches = 0
    rt, got, ab = _quickstart(port, n)
    rt_ref, want, _ = _quickstart(ref, n, impl="pallas")
    assert rt.comm_log == rt_ref.comm_log
    for key in ("bytes", "kinds", "rows0", "lowered"):
        assert got[key] == want[key], key
    assert got["bytes"][0] > 0 and got["bytes"][1] == 0
    assert got["kinds"]["b"] == "all_gather"
    np.testing.assert_allclose(got["c1"], want["c1"], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got["c1"], ab, rtol=2e-4, atol=1e-5)
    # the weighted repartition moves C without changing a byte of it
    assert np.array_equal(got["c2"], got["c1"])
    assert got["total"].dtype == want["total"].dtype == np.float32
    np.testing.assert_allclose(got["total"], want["total"], rtol=2e-4)
    np.testing.assert_allclose(got["total"], ab.sum(), rtol=2e-4)
    assert rt.executor.device_kernel_launches == 2
    assert gemm_kernel.gemm_cuda.launches == 0


def test_unported_paths_raise_naming_the_roadmap(tmp_path):
    """The paths still to port raise naming ROADMAP.md; fault recovery
    and rebalancing in ``run_pipeline`` are ported and run."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.ft import RecoveryPolicy, Rebalancer
    from repro_torch.models import build

    rt = port.HDArrayRuntime(2, backend="sim")
    pol = RecoveryPolicy(checkpoint=CheckpointManager(str(tmp_path)))
    for kw in ({"recovery": pol}, {"rebalance": Rebalancer()}):
        assert rt.run_pipeline([], **kw) == []
    for name in ("recurrentgemma-2b", "xlstm-125m", "whisper-base",
                 "deepseek-v3-671b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(get_config(name).reduced(), device="cpu")


# ----------------------------------------------------------------------
# import hygiene and the smoke script
# ----------------------------------------------------------------------
def _foreign_imports(path: Path):
    """Every jax or reference-package import in ``path``'s source,
    function-level imports included."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((path.name, node.lineno, name))
    return bad


def test_port_and_smoke_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert [b for f in files for b in _foreign_imports(f)] == []


def _env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    env.update(extra)
    return env


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=_env(PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25   # every module was imported


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_fails_alone_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "checkout of the repository" in out.stderr
