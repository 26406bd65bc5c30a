#!/usr/bin/env python3
"""The sLSTM recurrence kernel's variants at the prefill shape and across
T, and the `cluster` variant's exchange probe.

    python3 tools/slstm_scan_variants.py

Needs one CUDA card and nvcc.  Builds ``src/repro_torch/csrc/
slstm_scan.cu`` as the port does and prints each kernel's ptxas
registers and spills.  On xlstm-125m's prefill of the pool (bf16 pre_x
(4, 2048, 3072), r (4, 192, 768), from a state) it holds ``cluster`` and
``step`` to the plain loop within chip_smoke.py's SLSTM_TOL and times
them and the exchange probe (the `cluster` step loop without the
product and the gates, the exchange of h and its waits alone; not the
function) with CUDA events in two rounds, in us a step beside the
operations bound.  Last it times both variants across T at B 4 (device
time from torch.profiler and CUDA events back to back), the measurement
behind the wrapper's STEP_MAX_T.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: kernel code of slstm_scan_kernel_hd
KERNELS = {"cluster": 1, "probe": 2, "step": 0}
T_SWEEP = (1, 2, 3, 4, 6, 8, 16, 32, 64)


def _ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("slstm_scan_variants: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.slstm_scan import kernel as sk
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    log = build.build(("slstm_scan",))["slstm_scan"]
    for kernel, report in chip_smoke.ptxas_report(log, build._nvcc()):
        print(f"ptxas: {kernel}: {report}", flush=True)
    print(f"ptxas faults (spills, C75xx): {build.ptxas_faults(log)}",
          flush=True)

    cfg = get_config(chip_smoke.XLSTM_ARCH)
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    B, T = chip_smoke.SERVE_SLOTS, chip_smoke.PROMPTS[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    r = torch.randn((H, Dh, 4 * Dh), generator=g, device="cuda") \
        * (0.5 / Dh ** 0.5)
    n = torch.rand((B, D), generator=g, device="cuda") * 4 + 0.1
    c = n * (torch.rand((B, D), generator=g, device="cuda") * 2 - 1)
    h = torch.rand((B, D), generator=g, device="cuda") * 2 - 1
    m = torch.randn((B, D), generator=g, device="cuda") * 3
    st = (c, n, h, m)
    pre_x = torch.randn((B, T, 4 * D), generator=g, device="cuda").bfloat16()
    plain, _ = slstm_scan_ref(pre_x, r, st)
    top = float(plain.abs().max())
    bound = 1e3 * 2 * B * H * Dh * 4 * Dh * T / chip_smoke.FP32_FLOPS_PER_S
    print(f"prefill shape {(B, T, D)} bf16 from a state: operations bound "
          f"{bound:.4f} ms ({1e3 * bound / T:.4f} us a step)", flush=True)
    for rnd in (1, 2):
        for name, code in KERNELS.items():
            def run():
                return sk.slstm_scan_kernel(pre_x, r, st, code)
            got, _ = run()
            torch.cuda.synchronize()
            err = float((got - plain).abs().max()) / top
            ms = chip_smoke.cuda_ms(torch, run, 5 if code == 0 else 10)
            ok = err <= chip_smoke.SLSTM_TOL
            verdict = ("probe, not the function" if code == sk.PROBE
                       else f"err/max|h| {err:.3e} {'ok' if ok else 'FAIL'}")
            print(f"round {rnd} {name}: {ms:.4f} ms, {1e3 * ms / T:.4f} us "
                  f"a step, {ms / bound:.1f}x the bound; {verdict}",
                  flush=True)

    print(f"both variants across T, bf16 from a state, B {B}, D {D}: "
          f"device ms a call from torch.profiler (20 calls) and ms a call "
          f"from CUDA events over 50 back to back:", flush=True)
    for t in T_SWEEP:
        xs = pre_x[:, :t]
        row = {}
        for v in sk.VARIANTS:
            code = sk.VARIANTS.index(v)

            def run():
                return sk.slstm_scan_kernel(xs, r, st, code)
            got, _ = run()
            torch.cuda.synchronize()
            err = float((got - plain[:, :t]).abs().max()) / top
            if err > chip_smoke.SLSTM_TOL:
                print(f"T {t} {v}: err/max|h| {err:.3e} FAIL")
            row[v], _ = chip_smoke.scan_device_ms(torch, run, 20,
                                                  f"slstm_{v}")
            row[v + " events"] = chip_smoke.cuda_ms(torch, run, 50)
        faster = min(sk.VARIANTS, key=lambda v: row[v] or float("inf"))
        print(f"T {t}: " + ", ".join(f"{v} {_ms(ms)}"
                                     for v, ms in row.items())
              + f"; faster on the device {faster}; the wrapper takes "
              f"{sk.slstm_variant(B, t, D, H)}", flush=True)


if __name__ == "__main__":
    main()
