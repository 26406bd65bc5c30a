#!/usr/bin/env python3
"""The training path's two backward kernels of two source trees, side by
side on one card: the flash backward at Dh 256 and the RG-LRU scan's
backward, with the Dh-128 flash backward as a control.

    python3 tools/bwd_roles_ab.py [--base DIR]

Needs one CUDA card and nvcc.  Each tree (this checkout, and ``DIR``,
another checkout of the repository, for instance the parent commit
unpacked with ``git archive`` under ``build/``) is measured in a
process of its own that imports its ``src/repro_torch`` and builds its
kernels into its own ``build/``; the processes run in turns, base,
this, this, base, so that a drift of the card's clocks shows as a
spread and not as a difference.  Each process prints one JSON line:
the ptxas lines of every backward kernel it built, each shape's time
(CUDA events, mean of 10 or 20 calls after a warm-up), its device time
by kernel (torch.profiler over 5 calls), its error against the plain
version on the same inputs, and whether two launches agree bit for bit:

* flash backward, bf16, Dh 256: gemma2-9b's training microbatch (q
  (1, 4096, 16, 256), k, v (1, 4096, 8, 256), causal, softcap 50) and
  recurrentgemma-2b's (10 query heads over 1, window 2048);
* flash backward, bf16, Dh 128: yi-9b's (32 over 4, causal);
* the scan's backward, bf16 (1, 4096, 2560), no state, and five times
  each at widths of 640, 1280, 2464 and 2560 (a quarter, a half, the
  clusters the card holds at once, all of them).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
T = 4096
FLASH = {  # label: (Hq, Hkv, D, window, softcap)
    "gemma2 Dh256": (16, 8, 256, None, 50.0),
    "recurrentgemma Dh256": (10, 1, 256, 2048, 0.0),
    "yi Dh128": (32, 4, 128, None, 0.0),
}
SCAN = (1, 4096, 2560)
SCAN_WIDTHS = (640, 1280, 2464, 2560)


def _cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _by_kernel(torch, fn, reps=5):
    """Device ms per call of each kernel ``fn`` launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel)(<[^()]*>)?", e.name)
        name = (m.group(1) + re.sub(r"__nv_bfloat16, |\s", "",
                                    m.group(2) or "")) if m else e.name[:40]
        us = e.time_range.end - e.time_range.start
        out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return {k: round(v, 4) for k, v in out.items()}


def _rel(torch, got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def measure() -> dict:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    logs = build.build(("flash_attn_hd", "flash_attn_bwd_hd", "rglru_scan"))
    ptxas = [line.strip() for name in ("flash_attn_bwd_hd", "rglru_scan")
             for line in logs[name].splitlines()
             if re.search(r"Compiling entry|Used \d+ registers|bytes spill"
                          r"|C75\d\d", line)]
    out = {"src": str(Path(fk.__file__).resolve().parents[4]),
           "card": torch.cuda.get_device_name(0), "ptxas": ptxas}
    dev = "cuda"
    qpos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    for label, (Hq, Hkv, D, w, cap) in FLASH.items():
        g = torch.Generator(device=dev).manual_seed(29)
        q, k, v, do = (torch.randn(sh, generator=g, device=dev).bfloat16()
                       for sh in ((1, T, Hq, D), (1, T, Hkv, D),
                                  (1, T, Hkv, D), (1, T, Hq, D)))
        o, lse = fk._forward(q, k, v, qpos, w, cap, None, with_lse=True)

        def kernel():
            return fk.flash_attention_bwd_cuda(do, q, k, v, o, lse,
                                               qpos=qpos, window=w,
                                               softcap=cap)
        got, again = kernel(), kernel()
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(
            blockwise_attention(*plain, qpos=qpos, window=w, softcap=cap),
            plain, do)
        out[label] = dict(
            ms=_cuda_ms(torch, kernel, 10), split=_by_kernel(torch, kernel),
            fro_rel=[_rel(torch, a, b) for a, b in zip(got, want)],
            bit_identical=all(torch.equal(a, b) for a, b in zip(got, again)))
        del q, k, v, do, o, lse, got, again, plain, want
        torch.cuda.empty_cache()
    B, Ts, W = SCAN
    g = torch.Generator(device=dev).manual_seed(29)
    lam = torch.rand((W,), generator=g, device=dev) * 10 - 6
    x, ga, gi = (torch.randn((B, Ts, W), generator=g, device=dev).bfloat16()
                 for _ in range(3))
    dh = torch.randn((B, Ts, W), generator=g, device=dev)
    h = rglru_scan_cuda(x, ga, gi, lam)

    def scan():
        return rglru_scan_bwd_cuda(dh, x, ga, gi, lam, None, h)
    got, again = scan(), scan()
    want = rglru_scan_bwd_ref(dh, x, ga, gi, lam, None, h)
    out["scan bwd"] = dict(
        ms=_cuda_ms(torch, scan, 20), split=_by_kernel(torch, scan),
        err=[float((a.double() - b.double()).abs().max()
                   / b.double().abs().max())
             for a, b in zip(got, want) if a is not None],
        bit_identical=all(a is b or torch.equal(a, b)
                          for a, b in zip(got, again)))
    # the same T at narrower widths: fewer blocks, the same chain of
    # windows; a time that does not fall with the bytes is the chain's
    widths = {}
    for w in SCAN_WIDTHS:
        xs, gs, is_ = (t[..., :w].contiguous() for t in (x, ga, gi))
        dhs, lams = dh[..., :w].contiguous(), lam[:w].contiguous()
        hs = rglru_scan_cuda(xs, gs, is_, lams)
        widths[w] = [round(_cuda_ms(torch, lambda: rglru_scan_bwd_cuda(
            dhs, xs, gs, is_, lams, None, hs), 20), 4) for _ in range(5)]
    out["scan bwd"]["ms_by_width"] = widths
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="another checkout to compare with")
    ap.add_argument("--measure", action="store_true",
                    help="measure this process's tree and print JSON")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure()), flush=True)
        return
    trees = [ROOT] if args.base is None else [
        Path(args.base).resolve(), ROOT, ROOT, Path(args.base).resolve()]
    runs = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--measure"], env=env, cwd=tree,
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"{tree}: measurement failed\n{res.stdout}\n"
                     f"{res.stderr[-8000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for label in list(FLASH) + ["scan bwd"]:
        print(f"{label}: " + ", ".join(
            f"{'base' if Path(r['src']) != ROOT else 'this'} "
            f"{r[label]['ms']:.4f} ms" for r in runs))


if __name__ == "__main__":
    main()
