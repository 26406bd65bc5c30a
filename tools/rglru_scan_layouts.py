#!/usr/bin/env python3
"""The RG-LRU scan's chunked kernel in several layouts and probes, and
both variants across T.

    python3 tools/rglru_scan_layouts.py

Needs one CUDA card and nvcc.  From ``src/repro_torch/csrc/
rglru_scan.cu`` as it stands it writes one source per layout under
``build/rglru_scan_layouts/``, changing only the chunked kernel's
constants (warps a block = sub-chunks a window, steps a sub-chunk,
blocks a cluster, windows of inputs in shared memory), and probes of
the committed layout:

* ``ieee``: the function, with the gates' reciprocals and square root
  by IEEE division and sqrtf, whose slow-path branches the committed
  kernel's branch-free versions avoid;
* not the function: ``no-gates`` (a and b straight from the inputs,
  one multiply each: the data movement, syncs and carry chain),
  ``no-chain`` (no block waits for or sends a carry), ``copy`` (both
  cut: loads, syncs and stores alone) and ``no-loads`` (no input read:
  the gate math, chain and stores on whatever shared memory holds).

It builds them all at once with the port's nvcc flags, prints each
chunked kernel's ptxas registers and spills, the clusters the card
holds at once, and the committed layout's and the ``ieee`` probe's
instructions by kind (cuobjdump); then on recurrentgemma's prefill of
the pool (bf16 x, gate_a, gate_i (4, 2048, 2560), lam over decays,
from h0) it holds every layout to the plain loop within chip_smoke.py's
SCAN_TOL and times layouts and probes with CUDA events and
torch.profiler in two rounds, beside the byte bound.  Last it times
the committed library's two variants across T at the same B and W, the
measurement behind the wrapper's CHUNKED_MIN_T.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "rglru_scan_layouts"

# name: (warps a block, steps a sub-chunk, blocks a cluster, stages,
# probe)
LAYOUTS = {
    "4x8-c4-s2": (4, 8, 4, 2, None),
    "4x8-c8-s2": (4, 8, 8, 2, None),
    "4x4-c4-s3": (4, 4, 4, 3, None),
    "8x4-c4-s2": (8, 4, 4, 2, None),
    "probe-ieee": (4, 8, 4, 2, "ieee"),
    "probe-no-gates": (4, 8, 4, 2, "no-gates"),
    "probe-no-chain": (4, 8, 4, 2, "no-chain"),
    "probe-copy": (4, 8, 4, 2, "copy"),
    "probe-no-loads": (4, 8, 4, 2, "no-loads"),
}
T_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128, 512, 2048)

_GATES = """\
        const float av = expf(c_sp[k] * sigmoid_nb(to_float(pa.v[k])));
        const float mult = sqrt_normal(fmaxf(fmaf(-av, av, 1.0f), 1e-12f));
        const float bv = mult * (sigmoid_nb(to_float(pi.v[k])) *
                                 to_float(px.v[k]));
"""
_NO_GATES = """\
        const float av = c_sp[k] * to_float(pa.v[k]);
        const float bv = to_float(pi.v[k]) * to_float(px.v[k]);
"""
_WAIT = """\
      if (threadIdx.x == 0) mbar_expect_tx(smem_u32(&bar[m & 1]), 4 * kWc);
      mbar_wait(smem_u32(&bar[m & 1]), (m >> 1) & 1);
"""
_SEND = "    if (q == kSubChunks - 1 && w + 1 < nwin) {\n"


def variant_source(text: str, warps: int, steps: int, cluster: int,
                   stages: int, probe) -> str:
    def sub(old, new):
        nonlocal text
        if text.count(old) != 1:
            sys.exit(f"rglru_scan_layouts: {old!r} is not in the source "
                     f"exactly once")
        text = text.replace(old, new)
    sub("constexpr int kSubChunks = 4;",
        f"constexpr int kSubChunks = {warps};")
    sub("constexpr int kSteps = 8;", f"constexpr int kSteps = {steps};")
    sub("constexpr int kCluster = 4;", f"constexpr int kCluster = {cluster};")
    sub("constexpr int kStages = 2;", f"constexpr int kStages = {stages};")
    if probe in ("no-gates", "copy"):
        sub(_GATES, _NO_GATES)
    if probe in ("no-chain", "copy"):
        sub(_WAIT, "")
        sub(_SEND, "    if (false) {\n")
    if probe == "no-loads":
        sub("      const bool in = live && t < T;\n",
            "      const bool in = false;\n")
    if probe == "ieee":
        sub(_GATES, _GATES.replace("sigmoid_nb(", "sigmoid(")
            .replace("sqrt_normal(", "sqrtf("))
    return text


def _ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def sass_counts(name: str, nvcc: str) -> None:
    """Instructions of each chunked kernel of a layout's library by kind,
    from the toolkit's cuobjdump (the whole listing under
    build/rglru_scan_layouts/)."""
    out = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass",
                          str(OUT / f"{name}.so")], capture_output=True,
                         text=True)
    (OUT / f"{name}.sass").write_text(out.stdout + out.stderr)
    func, counts = None, {}
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and func:
            op = m.group(1).split(".")[0]
            counts[func][op] = counts[func].get(op, 0) + 1
    for func, ops in counts.items():
        if "chunked" in func:
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
            print(f"{name}: {func}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in top)
                  + f"; BRA {ops.get('BRA', 0)}, BSSY {ops.get('BSSY', 0)}, "
                  f"MUFU {ops.get('MUFU', 0)}, CALL "
                  f"{ops.get('CALL', 0)}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("rglru_scan_layouts: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import kernel as sk
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "rglru_scan.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, layout in LAYOUTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(source, *layout))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed:\n{log[-3000:]}")
            continue
        built[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        faults = build.ptxas_faults(log)
        for kernel, report in chip_smoke.ptxas_report(log, nvcc):
            if "chunked" in kernel:
                print(f"{name}: {kernel}: {report}; faults {faults}")

    for name, lib in built.items():
        n = ctypes.c_int(0)
        err = lib.rglru_scan_max_clusters(ctypes.byref(n))
        print(f"{name}: the card holds {n.value} clusters of the bf16 "
              f"chunked kernel at once (CUDA error {err})")

    for name in ("4x8-c4-s2", "probe-ieee"):
        if name in built:
            sass_counts(name, nvcc)

    B, T, W = chip_smoke.SERVE_SLOTS, chip_smoke.PROMPTS[0], 2560
    g = torch.Generator(device="cuda").manual_seed(0)
    lam = torch.rand((W,), generator=g, device="cuda") * 10 - 6
    x, ga, gi = (torch.randn((B, T, W), generator=g, device="cuda")
                 .bfloat16() for _ in range(3))
    h0 = torch.randn((B, W), generator=g, device="cuda")
    bound = 1e3 * (B * T * W * (3 * 2 + 4) + B * W * 4) \
        / chip_smoke.HBM_BYTES_PER_S
    plain = rglru_scan_ref(x, ga, gi, lam, h0)
    top = float(plain.abs().max())
    print(f"prefill shape {(B, T, W)} bf16 from h0: bound {bound:.4f} ms "
          f"(bytes)", flush=True)
    load = build.load
    try:
        for rnd in (1, 2):
            for name, lib in built.items():
                build.load = lambda _name, lib=lib: lib

                def run():
                    return sk.rglru_scan_cuda(x, ga, gi, lam, h0,
                                              variant="chunked")
                got = run()
                torch.cuda.synchronize()
                err = float((got - plain).abs().max()) / top
                ms = chip_smoke.cuda_ms(torch, run, 50)
                dev, _ = chip_smoke.scan_device_ms(torch, run, 20)
                probe = LAYOUTS[name][4]
                verdict = ("probe, not the function"
                           if probe and probe != "ieee" else
                           f"err/max|h| {err:.3e} "
                           f"{'ok' if err <= chip_smoke.SCAN_TOL else 'FAIL'}")
                print(f"round {rnd} {name}: {ms:.4f} ms ({_ms(dev)} on the "
                      f"profiler), {100 * bound / ms:.1f}% of the bound, "
                      f"{B * T * W * 10 / ms / 1e6:.1f} GB/s; {verdict}",
                      flush=True)
    finally:
        build.load = load

    print("both variants across T, committed library, bf16 from h0, "
          f"B {B}, W {W}: device ms a call from torch.profiler (20 calls), "
          f"and ms a call from CUDA events over 50 back to back, which "
          f"small T leaves to the host:", flush=True)
    for t in T_SWEEP:
        xs, gas, gis = x[:, :t], ga[:, :t], gi[:, :t]
        row = {}
        for v in sk.VARIANTS:
            def run():
                return sk.rglru_scan_cuda(xs, gas, gis, lam, h0, variant=v)
            got = run()
            torch.cuda.synchronize()
            err = float((got - plain[:, :t]).abs().max()) / max(
                float(plain[:, :t].abs().max()), 1e-30)
            if err > chip_smoke.SCAN_TOL:
                print(f"T {t} {v}: err/max|h| {err:.3e} FAIL")
            row[v], _ = chip_smoke.scan_device_ms(torch, run, 20)
            row[v + " events"] = chip_smoke.cuda_ms(torch, run, 50)
        faster = min(sk.VARIANTS, key=lambda v: row[v] or float("inf"))
        print(f"T {t}: " + ", ".join(f"{v} {_ms(ms)}"
                                     for v, ms in row.items())
              + f"; faster on the device {faster}; wrapper picks "
              f"{sk.scan_variant(B, t, W)}", flush=True)


if __name__ == "__main__":
    main()
