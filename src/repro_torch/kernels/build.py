"""Build and load the port's hand-written CUDA kernels.

Each source ``repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  Libraries go to ``build/repro_torch/`` at the repository
root, named by a hash of the source, the headers beside it and the
flags, so a changed source or header rebuilds and an unchanged one
loads at once; each library keeps the log of its build beside it
(``.log``), so :func:`ptxas_faults` can read it on every load.  Nothing
here runs at import: a kernel builds on its first launch, or earlier
through :func:`build`, which starts one ``nvcc`` per source, all at
once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("jacobi_hd", "gemm_hd", "flash_attn_hd", "flash_attn_bwd_hd",
           "rglru_scan", "slstm_scan")
# no --use_fast_math: the Jacobi sweep is held bit-identical to its
# plain version, the GEMM to IEEE f32 (FFMA, not TF32), flash
# attention's f32 path to 2e-5 (accurate expf, tanhf and division) and
# the RG-LRU scan to float64 (accurate expf, log1pf and sqrtf) and the
# sLSTM recurrence to float64 (accurate expf and tanhf, IEEE division)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every header in ``csrc/`` (any source may include one) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Returns by name the compiler's
    output (the ``-Xptxas -v`` register, spill and shared-memory
    report) of every named source, read back from the log beside a
    library built earlier; raises with that output if one fails.  A
    library without its log is built again."""
    jobs, logs = {}, {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists() and out.with_suffix(".log").exists():
                logs[name] = out.with_suffix(".log").read_text()
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            # the log first, so that a library never stands without it;
            # both atomic: a reader never sees half of either
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(log)
            os.replace(tmp_log, out.with_suffix(".log"))
            os.replace(tmp, out)
            logs[name] = log
        return logs
    finally:
        for proc, _tmp, _out in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def ptxas_faults(log: str) -> List[str]:
    """The lines of an ``nvcc -Xptxas -v`` log that say a kernel spills
    (a nonzero spill store or load) or that ptxas serialised its wgmmas
    or lost performance in another way it reports (its C75xx
    warnings).  None of the port's kernels may do either."""
    return [line.strip() for line in log.splitlines()
            if re.search(r"\(C75\d\d\)", line)
            or re.search(r"\b[1-9]\d* bytes spill (stores|loads)", line)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
