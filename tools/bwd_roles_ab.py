#!/usr/bin/env python3
"""The training path's backward kernels of two source trees, side by
side on one card: the flash backward at Dh 192 / Dv 128 and at Dh 256,
the sLSTM recurrence's backward and the RG-LRU scan's backward, with the
Dh-128 flash backward as a control.

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
* flash backward, bf16, Dh 192 / Dv 128: deepseek-v3's (q, k (1, 4096,
  128, 192), the RoPE columns joined, the key's shared by every head, v
  (1, 4096, 128, 128), causal), and where the tree has them the dK/dV
  pass's probes (its elementwise math left out, its copies left out),
  each pass's TFLOP/s in the summary;
* the sLSTM recurrence's backward at xlstm-125m's training microbatch
  (1, 4096, 768), 4 heads, bf16 pre_x, against the plain reverse loop,
  in us a step, and where the tree has them its probes (the exchange
  alone, the product and gate math alone);
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
MLA = (128, 128, 64, 128)      # heads, d_nope, d_rope, d_v
SLSTM = (1, 4096, 768, 4)      # B, T, D, heads
BF16_FLOPS_PER_S = 989e12


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


def kernel_ms(split, kernel):
    """The ms of ``kernel`` (a name's start) in a split by kernel, or
    None."""
    return next((v for k, v in split.items() if k.startswith(kernel)),
                None)


def measure_mla(torch, fk) -> dict:
    """The Dh 192 / Dv 128 backward at deepseek-v3's training shape."""
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.ref import join_rope

    H, Dn, Dr, Dv = MLA
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(30)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    q, k = join_rope(randn(1, T, H, Dn), randn(1, T, H, Dn),
                     randn(1, T, H, Dr), randn(1, T, 1, Dr))
    v, do = randn(1, T, H, Dv), randn(1, T, H, Dv)
    qpos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    scale = 1.0 / (Dn + Dr) ** 0.5
    o, lse = fk._forward(q, k, v, qpos, None, 0.0, scale, with_lse=True)

    def kernel():
        return fk.flash_attention_bwd_cuda(do, q, k, v, o, lse, qpos=qpos,
                                           scale=scale)
    got, again = kernel(), kernel()
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        blockwise_attention(*plain, qpos=qpos, window=None, scale=scale),
        plain, do)
    res = dict(
        ms=_cuda_ms(torch, kernel, 10), split=_by_kernel(torch, kernel),
        fro_rel=[_rel(torch, a, b) for a, b in zip(got, want)],
        bit_identical=all(torch.equal(a, b) for a, b in zip(got, again)))
    del got, again, plain, want
    probe = getattr(fk, "flash_attention_bwd_probe", None)
    if probe is not None:
        res["probes"] = {name: kernel_ms(_by_kernel(torch, lambda: probe(
            do, q, k, v, o, lse, qpos=qpos, scale=scale, probe=name)),
            "dkdv_roles_kernel") for name in fk.BWD_PROBES}
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return res


def measure_slstm(torch) -> dict:
    """The sLSTM backward at xlstm-125m's training microbatch."""
    from repro_torch.kernels.slstm_scan import kernel as sk
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref

    B, Ts, D, H = SLSTM
    Dh = D // H
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(31)
    r = torch.randn((H, Dh, 4 * Dh), generator=g, device=dev) \
        * (0.5 / Dh ** 0.5)
    pre_x = torch.randn((B, Ts, 4 * D), generator=g, device=dev).bfloat16()
    dhs = torch.randn((B, Ts, D), generator=g, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    saved = (torch.empty((B, Ts, 4 * D), **f32),
             *(torch.empty((B, Ts, D), **f32) for _ in range(3)))
    sk.slstm_scan_kernel(pre_x, r, None, sk.VARIANTS.index("cluster"), saved)

    def kernel():
        return sk.slstm_scan_bwd_cuda(dhs, r, saved)
    got, again = kernel()[0], kernel()[0]
    want = slstm_scan_bwd_ref(dhs, pre_x, r)[0]
    ms = _cuda_ms(torch, kernel, 10)
    res = dict(ms=ms, us_per_step=1e3 * ms / Ts,
               err=float((got.double() - want.double()).abs().max()
                         / want.double().abs().max()),
               bit_identical=torch.equal(got, again))
    probe = getattr(sk, "slstm_scan_bwd_probe", None)
    if probe is not None:
        res["probes_us_per_step"] = {
            name: 1e3 * _cuda_ms(torch, lambda: probe(dhs, r, saved, name),
                                 10) / Ts for name in sk.BWD_PROBES}
    return res


def measure() -> dict:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    logs = build.build(("flash_attn_hd", "flash_attn_bwd_hd", "rglru_scan",
                        "slstm_scan"))
    ptxas = [line.strip() for name in ("flash_attn_bwd_hd", "rglru_scan",
                                       "slstm_scan")
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
    out["dsv3 Dh192/128"] = measure_mla(torch, fk)
    out["slstm bwd"] = measure_slstm(torch)
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

    def who(r):
        return "base" if Path(r["src"]) != ROOT else "this"
    for label in list(FLASH) + ["dsv3 Dh192/128", "slstm bwd", "scan bwd"]:
        print(f"{label}: " + ", ".join(
            f"{who(r)} {r[label]['ms']:.4f} ms" for r in runs))
    # the Dh 192 / Dv 128 passes' rates: the dK/dV pass 4 (Dh + Dv) flops
    # a visible pair and head, dQ 2 (2 Dh + Dv)
    H, Dn, Dr, Dv = MLA
    Dh, pairs = Dn + Dr, T * (T + 1) // 2 * H
    for r in runs:
        m = r["dsv3 Dh192/128"]
        rates = []
        for name, kernel, flops in (
                ("dK/dV", "dkdv_roles_kernel", 4 * (Dh + Dv)),
                ("dQ", "dq_wgmma_kernel", 2 * (2 * Dh + Dv))):
            ms = kernel_ms(m["split"], kernel)
            if ms:
                tf = pairs * flops / ms / 1e9
                rates.append(f"{name} {ms:.4f} ms {tf:.1f} TFLOP/s "
                             f"({100 * tf * 1e12 / BF16_FLOPS_PER_S:.1f}% of "
                             f"989)")
        probes = ", ".join(f"{k} {v:.4f} ms" for k, v in
                           m.get("probes", {}).items() if v)
        s = r["slstm bwd"]
        sp = ", ".join(f"{k} {v:.3f}" for k, v in
                       s.get("probes_us_per_step", {}).items())
        print(f"{who(r)}: Dh 192 / Dv 128 " + "; ".join(rates)
              + (f"; dK/dV probes {probes}" if probes else "")
              + f"; sLSTM bwd {s['us_per_step']:.3f} us a step"
              + (f" (probes, us a step: {sp})" if sp else ""))


if __name__ == "__main__":
    main()
