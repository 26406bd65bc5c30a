#!/usr/bin/env python3
"""The two backward kernels of the training path's deepseek-v3 and
xlstm-125m layers in the layouts their designs were chosen from, side
by side on one card: the flash backward's dK/dV pass at Dh 192 / Dv 128
and the sLSTM recurrence's backward.

    python3 tools/bwd_layouts.py

Needs one CUDA card and nvcc.  Copies ``src/repro_torch`` once a layout
under ``build/bwd_layouts/<name>/``, changes one line or a few of the
copy's source, builds every copy at once with the port's nvcc flags
(each into its own ``build/``), prints the ptxas registers and spills
of the changed kernels, and then measures each in a process of its own,
in two rounds, with ``tools/bwd_roles_ab.py``'s measurements (CUDA
events, torch.profiler by kernel, each against its plain version, two
launches bit for bit):

* flash backward at deepseek-v3's training microbatch (q, k (1, 4096,
  128, 192), v, dO (1, 4096, 128, 128), causal): ``as built`` (two
  parts an iteration, each side overlapping its products with its own
  math; three stages of Q and dO beside two P^T exchange buffers; a
  head's key blocks neighbours in the grid), ``one part an iteration``,
  ``4 stages, one exchange`` and ``heads the fast grid index`` (the
  first design's grid order), with the dK/dV pass's two probes;
* sLSTM backward at (1, 4096, 768), 4 heads: ``as built`` (the gate
  step's forward half off the chain, 1 / max(n, 1e-6) from it, the
  exchange's wait sleeping in try_wait), ``division on the chain`` and
  ``spinning wait`` (the mbarrier polled), with both probes.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from bwd_roles_ab import kernel_ms

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "bwd_layouts"
FB = "csrc/flash_attn_bwd_hd.cu"
SL = "csrc/slstm_scan.cu"
# name: (what it measures, [(source, old, new), ...])
LAYOUTS = {
    "as built": ("both", []),
    "one part an iteration": ("flash", [
        (FB, "constexpr bool kPair = DK == 192;",
         "constexpr bool kPair = false;")]),
    "4 stages, one exchange": ("flash", [
        (FB, "static constexpr int kXBufs = kPair<DK> ? 2 : 1;",
         "static constexpr int kXBufs = 1;")]),
    "heads the fast grid index": ("flash", [
        (FB, "constexpr bool kHeadMajor = DK == 192;",
         "constexpr bool kHeadMajor = false;")]),
    "division on the chain": ("slstm", [
        (SL, "  a.rn = 1.0f / nc;", "  a.rn = nc;"),
        (SL, "  dc += dq * a.rn;", "  dc += dq / a.rn;"),
        (SL, "  dn += -dq * a.q * a.rn * a.wn;",
         "  dn += -dq * a.q / a.rn * a.wn;")]),
    # the exchange's wait polling the mbarrier instead of sleeping in
    # try_wait (no trap on a fault: a measurement, not the function)
    "spinning wait": ("slstm", [
        (SL, "      mbar_wait(smem_u32(&bar[s]), (n / kBufs) & 1);",
         "      for (uint32_t d = 0; !d;)\n"
         "        asm volatile(\"{\\n.reg .pred p;\\n\"\n"
         "                     \"mbarrier.test_wait.parity.shared::cta.b64 "
         "p, [%1], %2;\\n\"\n"
         "                     \"selp.u32 %0, 1, 0, p;\\n}\\n\"\n"
         "                     : \"=r\"(d)\n"
         "                     : \"r\"(smem_u32(&bar[s])), "
         "\"r\"((n / kBufs) & 1)\n"
         "                     : \"memory\");")]),
}
# the changed kernels' ptxas lines: the 192 / 128 dK/dV pass in bf16
# without a softcap (and its probes), and the sLSTM backward (and its)
PTXAS = r"dkdv_roles_kernelI13__nv_bfloat16Li192ELi128ELb0|slstm_bwd_kernel"


def tree(name: str) -> Path:
    """A copy of src/repro_torch with the layout's changes."""
    dst = OUT / re.sub(r"\W+", "_", name) / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in LAYOUTS[name][1]:
        path = dst / "repro_torch" / rel
        text = path.read_text()
        if text.count(old) != 1:
            sys.exit(f"bwd_layouts: {old!r} is not in {rel} exactly once")
        path.write_text(text.replace(old, new))
    return dst


def ptxas_lines(log: str):
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and re.search(PTXAS, line):
            name = re.search(r"(dkdv_roles_kernel|slstm_bwd_kernel)\w*",
                             line).group(0)
            info = [x.strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x]
            yield f"{name}: " + "; ".join(info)
    for line in lines:
        if re.search(r"C75\d\d", line):
            yield line.strip()


MEASURE = """
import json, sys, torch
sys.path.insert(0, {tools!r})
import bwd_roles_ab as ab
from repro_torch.kernels.flash_attention import kernel as fk
what, out = {what!r}, {{}}
if what in ("flash", "both"):
    out["flash"] = ab.measure_mla(torch, fk)
if what in ("slstm", "both"):
    out["slstm"] = ab.measure_slstm(torch)
print(json.dumps(out))
"""


def main() -> None:
    srcs = {name: tree(name) for name in LAYOUTS}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import json; from repro_torch.kernels "
         "import build; print(json.dumps(build.build(('flash_attn_hd', "
         "'flash_attn_bwd_hd', 'slstm_scan'))))"],
        env=dict(os.environ, PYTHONPATH=str(src)), cwd=src.parent,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, src in srcs.items()}
    for name, proc in builds.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: the build failed\n{err[-8000:]}")
        logs = json.loads(out.strip().splitlines()[-1])
        for line in ptxas_lines(logs["flash_attn_bwd_hd"]
                                + logs["slstm_scan"]):
            print(f"{name}: ptxas {line}")
    rows = {name: [] for name in LAYOUTS}
    for rnd in (1, 2):
        for name, (what, _) in LAYOUTS.items():
            src = srcs[name]
            res = subprocess.run(
                [sys.executable, "-c", MEASURE.format(
                    tools=str(ROOT / "tools"), what=what)],
                env=dict(os.environ, PYTHONPATH=str(src)), cwd=src.parent,
                capture_output=True, text=True)
            if res.returncode != 0:
                sys.exit(f"{name}: measurement failed\n{res.stderr[-8000:]}")
            got = json.loads(res.stdout.strip().splitlines()[-1])
            rows[name].append(got)
            print(json.dumps({"layout": name, "round": rnd, **got}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name, runs in rows.items():
        parts = []
        if "flash" in runs[0]:
            parts.append("flash bwd 192/128 " + ", ".join(
                f"{r['flash']['ms']:.4f} ms (dK/dV "
                f"{kernel_ms(r['flash']['split'], 'dkdv_roles_kernel'):.4f}"
                ", probes "
                + ", ".join(f"{k} {v:.4f}" for k, v in
                            r["flash"].get("probes", {}).items()) + ")"
                for r in runs))
        if "slstm" in runs[0]:
            parts.append("sLSTM bwd " + ", ".join(
                f"{r['slstm']['us_per_step']:.4f} us a step (probes "
                + ", ".join(f"{k} {v:.4f}" for k, v in
                            r["slstm"].get("probes_us_per_step",
                                           {}).items()) + ")"
                for r in runs))
        print(f"{name}: " + "; ".join(parts))


if __name__ == "__main__":
    main()
