#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and holds each against its
   plain PyTorch version on the card, at the main path's shapes and at
   ragged ones, timing kernel, plain version and library call.
2. Drives the main path, HDArrayRuntime -> planner -> TorchExecutor ->
   kernels, at the paper's problem sizes (benchmarks/paper_programs.py)
   with 4 logical ranks on the one card:
   * Jacobi (20480, 24080) float32, 10 ping-pong sweeps, bit-identical
     to 10 serial plain sweeps on the card;
   * the quickstart sequence at GEMM n = 10240: GEMM, a second GEMM
     that moves nothing, reduce(sum) over a column partition, and a
     weighted (2, 1, 1, 1) repartition, against a float64 product.
   Every kernel launch counter is set to 0 just before each path and
   read just after.
3. Prints one JSON line of kernel measurements, the card's name and
   power limit, and as the last line ``{"ok": true, "device": ...}``.

It exits non-zero, and prints no result, without a CUDA device or
without the repository's ``src/repro_torch`` beside it.  float32
products run in IEEE float32: TF32 is switched off for every matmul
and convolution the script times.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12            # outside the tensor cores

NPROC = 4
JACOBI_SHAPE = (20480, 24080)       # benchmarks/paper_programs.py:121
SWEEPS = 10
GEMM_N = 10240                      # benchmarks/paper_programs.py:78
GEMM_F32_TOL = 5e-5                 # Frobenius-relative, vs float64
# bf16 inputs are exact in the float64 product; the bound is the bf16
# rounding of the output (2**-9 relative at most, about 1.1e-3 RMS)
GEMM_BF16_TOL = 4e-3
# |reduce - float64 sum| / sum|C|.  The reduce must equal, bit for bit,
# the float32 fold of C written out below (numpy's sum over each rank's
# column band, then np.add across ranks in rank order); this bound
# holds that fold to the float64 sum.  Summing m = n * n random values
# of rms s = sqrt(n) pairwise in float32 errs by about
# eps * s * sqrt(m * log2(m)), under 1e-10 of sum|C| (0.8 * m * s) at
# n = 10240; 1e-9 is ten times that, while dropping one row of C moves
# the total by about sqrt(n) * s, 1e-6 of sum|C|
REDUCE_TOL = 1e-9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(torch, label: str, fn, top: int = 4) -> None:
    """Run ``fn`` once under torch.profiler and print its host wall
    time, the device's busy time in it (the union of every kernel, copy
    and memset interval on the card) and the device time of the ``top``
    busiest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + end - start, n + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    print(f"{label} (profiled): wall {wall_ms:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}%)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / 1e3:9.3f} ms  x{n:<4d} {name[:90]}")


def fro_rel(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def kernel_phase(torch):
    """Each kernel against its plain version on the card."""
    from repro_torch.kernels.gemm_hd.kernel import gemm_cuda
    from repro_torch.kernels.gemm_hd.ops import gemm as gemm_op
    from repro_torch.kernels.gemm_hd.ref import gemm_ref
    from repro_torch.kernels.stencil_hd.kernel import jacobi_cuda
    from repro_torch.kernels.stencil_hd.ops import jacobi_step
    from repro_torch.kernels.stencil_hd.ref import jacobi_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    # -- Jacobi: bit-identical everywhere -------------------------------
    # The path sweeps rank 0's slab (its interior band plus one halo row
    # each side) and writes the band's interior straight into the
    # destination array through its row pitch; the cases below also
    # check that nothing outside the window is written.
    M, N = JACOBI_SHAPE
    full = torch.randn((M, N), generator=g, device=dev)
    dst = torch.zeros((M, N), device=dev)
    band = -(-(M - 2) // NPROC)          # rank 0's interior rows
    slab = full[0:band + 2]
    win = ((1, band + 1), (1, N - 1))
    out = dst[1:band + 1, 1:N - 1]
    small = torch.randn((300, 64), generator=g, device=dev)
    small_dst = torch.zeros((310, 90), device=dev)
    jac_err = 0.0
    for name, x, w, o, o_buf in (
            ("37x53", torch.randn((37, 53), generator=g, device=dev),
             None, None, None),
            ("300x64", small, None, None, None),
            ("300x64 window (17:250, 5:40) into a pitch-90 band", small,
             ((17, 250), (5, 40)), small_dst[4:237, 3:38], small_dst),
            (f"full {JACOBI_SHAPE}", full, None, None, None),
            (f"rank 0 slab {tuple(slab.shape)} into the destination band",
             slab, win, out, dst)):
        k = jacobi_cuda(x, window=w, out=o)
        (i0, i1), (j0, j1) = w or ((0, x.shape[0]), (0, x.shape[1]))
        r = jacobi_ref(x)[i0:i1, j0:j1]
        torch.cuda.synchronize()
        err = float((k - r).abs().max())
        print(f"jacobi {name}: bit-identical={torch.equal(k, r)} "
              f"max_abs_err={err}")
        check(torch.equal(k, r), f"jacobi kernel differs from plain at {name}")
        if o_buf is not None:
            written = int(o_buf.ne(0).sum())
            check(written == int(o.ne(0).sum()),
                  f"jacobi {name} wrote outside its window")
        jac_err = max(jac_err, err)
    sm, sn = slab.shape
    wm, wn = out.shape
    jac = dict(
        name="jacobi_hd", route="cuda",
        source="src/repro_torch/csrc/jacobi_hd.cu",
        replaces="src/repro/kernels/stencil_hd/kernel.py:49",
        max_abs_err=jac_err,
        ms=cuda_ms(torch, lambda: jacobi_cuda(slab, window=win, out=out), 20),
        plain_ms=cuda_ms(torch, lambda: jacobi_step(
            slab, window=win, out=out, impl="ref"), 5),
        bound_ms=1e3 * max((sm * sn + wm * wn) * 4 / HBM_BYTES_PER_S,
                           5 * wm * wn / FP32_FLOPS_PER_S),
        bound_by="bytes", library_ms=None,
        shape=[sm, sn])
    del full, dst, slab, out

    # -- GEMM: against the float64 product ------------------------------
    n = GEMM_N
    band = n // NPROC
    # The path multiplies rank 1's row band of A by all of B and writes
    # straight into rank 1's row band of C.  Every build of the kernel
    # (f32 or bf16 in, f32 or bf16 out) runs below; the ragged
    # "into a band" case writes through a row pitch wider than N and
    # checks that nothing outside the band is written.
    a_full = torch.randn((n, n), generator=g, device=dev)
    b = torch.randn((n, n), generator=g, device=dev)
    c_full = torch.zeros((n, n), device=dev)
    a = a_full[band:2 * band]
    c = c_full[band:2 * band]
    cases = [("main f32 into C's band", a, b, 1.0, dict(out=c), c_full,
              GEMM_F32_TOL)]
    for (m_, k_, n_) in ((33, 512, 17), (130, 257, 99), (64, 48, 32)):
        x = torch.randn((m_, k_), generator=g, device=dev)
        y = torch.randn((k_, n_), generator=g, device=dev)
        xb, yb = x.bfloat16(), y.bfloat16()
        shape = f"{m_}x{k_}x{n_}"
        cases += [
            (f"{shape} f32", x, y, 1.5, {}, None, GEMM_F32_TOL),
            (f"{shape} bf16", xb, yb, 1.5, {}, None, GEMM_BF16_TOL),
            # bf16 inputs are exact in the float64 product: a float32
            # output keeps the float32 bound
            (f"{shape} bf16 -> f32", xb, yb, 1.5,
             dict(out_dtype=torch.float32), None, GEMM_F32_TOL),
            (f"{shape} f32 -> bf16", x, y, 1.5,
             dict(out_dtype=torch.bfloat16), None, GEMM_BF16_TOL)]
    x = torch.randn((130, 257), generator=g, device=dev)
    y = torch.randn((257, 99), generator=g, device=dev)
    wide = torch.zeros((136, 119), device=dev)
    cases.append(("130x257x99 f32 into a pitch-119 band", x, y, 1.5,
                  dict(out=wide[3:133, 7:106]), wide, GEMM_F32_TOL))
    cases.append(("main bf16", a.bfloat16(), b.bfloat16(), 1.0, {}, None,
                  GEMM_BF16_TOL))
    gemm_err = None
    for name, x, y, alpha, kw, o_buf, tol in cases:
        k = gemm_cuda(x, y, alpha=alpha, **kw)
        r = gemm_ref(x, y, alpha=alpha, out_dtype=k.dtype)
        o = alpha * (x.double() @ y.double())
        torch.cuda.synchronize()
        e64, eplain = fro_rel(torch, k, o), fro_rel(torch, k, r)
        maxabs = float((k.float() - r.float()).abs().max())
        print(f"gemm {name} alpha={alpha}: fro_rel_vs_f64={e64:.3e} "
              f"fro_rel_vs_plain={eplain:.3e} max_abs_vs_plain={maxabs:.3e} "
              f"(bound {tol:g})")
        check(e64 <= tol, f"gemm {name}: {e64} > {tol} against float64")
        check(eplain <= tol, f"gemm {name}: {eplain} > {tol} against plain")
        check(k.dtype == kw.get("out_dtype", x.dtype),
              f"gemm {name} returned {k.dtype}")
        if o_buf is not None:
            check(int(o_buf.ne(0).sum()) == int(k.ne(0).sum()),
                  f"gemm {name} wrote outside its band")
        if name.startswith("main f32"):
            gemm_err = maxabs
    m_, k_ = a.shape
    n_ = b.shape[1]
    gemm = dict(
        name="gemm_hd", route="cuda", source="src/repro_torch/csrc/gemm_hd.cu",
        replaces="src/repro/kernels/gemm_hd/kernel.py:40",
        max_abs_err=gemm_err,
        ms=cuda_ms(torch, lambda: gemm_cuda(a, b, out=c), 5),
        plain_ms=cuda_ms(torch, lambda: gemm_op(a, b, out=c, impl="ref"), 5),
        bound_ms=1e3 * max(2 * m_ * n_ * k_ / FP32_FLOPS_PER_S,
                           (m_ * k_ + k_ * n_ + m_ * n_) * 4 / HBM_BYTES_PER_S),
        bound_by="operations",
        library_ms=cuda_ms(torch, lambda: torch.mm(a, b, out=c), 5),
        shape=[m_, k_, n_])
    del a_full, a, b, c_full, c, cases
    torch.cuda.empty_cache()
    return jac, gemm


def reset_launches():
    from repro_torch.kernels.gemm_hd.kernel import gemm_cuda
    from repro_torch.kernels.stencil_hd.kernel import jacobi_cuda
    jacobi_cuda.launches = 0
    gemm_cuda.launches = 0


def read_launches():
    from repro_torch.kernels.gemm_hd.kernel import gemm_cuda
    from repro_torch.kernels.stencil_hd.kernel import jacobi_cuda
    return {"jacobi_hd": jacobi_cuda.launches, "gemm_hd": gemm_cuda.launches}


def jacobi_path(torch):
    from repro_torch.core import Box, HDArrayRuntime, IDENTITY_2D, stencil
    from repro_torch.kernels.hd import make_jacobi_kernel
    from repro_torch.kernels.stencil_hd.ref import jacobi_ref

    M, N = JACOBI_SHAPE
    t0 = time.perf_counter()
    init = np.random.default_rng(0).standard_normal((M, N), dtype=np.float32)
    rt = HDArrayRuntime(NPROC)            # backend "torch" on the card
    A, B = rt.create("A", (M, N)), rt.create("B", (M, N))
    pd = rt.partition_row((M, N))
    pw = rt.partition_row((M, N), region=Box.make((1, M - 1), (1, N - 1)))
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    ab, ba = make_jacobi_kernel("A", "B"), make_jacobi_kernel("B", "A")
    fp = stencil(2, 1)
    prog = [dict(kernel_name="jab", part_id=pw, kernel=ab, arrays=[A, B],
                 uses={"A": fp}, defs={"B": IDENTITY_2D}) if i % 2 == 0 else
            dict(kernel_name="jba", part_id=pw, kernel=ba, arrays=[A, B],
                 uses={"B": fp}, defs={"A": IDENTITY_2D})
            for i in range(SWEEPS)]
    ex = rt.executor
    torch.cuda.synchronize()
    print(f"jacobi path set-up (data, upload, scatter): "
          f"{time.perf_counter() - t0:.3f} s")
    h2d, d2h = ex.h2d_transfers, ex.d2h_transfers
    reset_launches()
    t0 = time.perf_counter()
    rt.run_pipeline(prog)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    steady = (ex.h2d_transfers - h2d, ex.d2h_transfers - d2h)
    kinds = sorted({k for _n, _b, arrs in rt.comm_log[-SWEEPS:]
                    for _a, k, _b in arrs})
    halo_bytes = sum(b for _n, b, _a in rt.comm_log[-SWEEPS:])
    print(f"jacobi path: {SWEEPS} sweeps x {NPROC} ranks at {JACOBI_SHAPE}: "
          f"{1e3 * dt / SWEEPS:.3f} ms/step (host clock), launches "
          f"{launches}, kinds {kinds}, halo bytes {halo_bytes}, "
          f"h2d/d2h during the pipeline {steady}, copies {ex.copy_counts}")
    check(launches["jacobi_hd"] == SWEEPS * NPROC,
          f"jacobi launches {launches['jacobi_hd']} != {SWEEPS * NPROC}")
    check(steady == (0, 0), f"steady host<->device transfers {steady}")
    check(kinds == ["halo", "none"], f"jacobi comm kinds {kinds}")
    x = torch.from_numpy(init).cuda()
    for _ in range(SWEEPS):
        x = jacobi_ref(x)
    got = rt.read_coherent(A)             # the last sweep defines A
    same = np.array_equal(got, x.cpu().numpy())
    print(f"jacobi path vs {SWEEPS} serial plain sweeps: bit-identical={same}")
    check(same, "jacobi path differs from serial plain sweeps")
    device_breakdown(torch, "jacobi path, 2 more sweeps",
                     lambda: rt.run_pipeline(prog[:2]))
    rt.close()
    del x, got, init
    torch.cuda.empty_cache()
    return launches, 1e3 * dt / SWEEPS


def gemm_path(torch):
    from repro_torch.core import COL_ALL, HDArrayRuntime, IDENTITY_2D, ROW_ALL
    from repro_torch.kernels.hd import make_gemm_kernel

    n = GEMM_N
    rng = np.random.default_rng(1)
    Ah = rng.standard_normal((n, n), dtype=np.float32)
    Bh = rng.standard_normal((n, n), dtype=np.float32)
    rt = HDArrayRuntime(NPROC)
    part = rt.partition_row((n, n))
    hA, hB, hC = (rt.create(s, (n, n)) for s in "abc")
    rt.write(hA, Ah, part)
    rt.write(hB, Bh, part)
    rt.write(hC, np.zeros((n, n), np.float32), part)
    mm = make_gemm_kernel("a", "b", "c")
    step = dict(uses={"a": ROW_ALL, "b": COL_ALL}, defs={"c": IDENTITY_2D})
    ex = rt.executor
    torch.cuda.synchronize()
    h2d, d2h = ex.h2d_transfers, ex.d2h_transfers
    reset_launches()
    t0 = time.perf_counter()
    plan1 = rt.apply_kernel("gemm", part, mm, [hA, hB, hC], **step)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan2 = rt.apply_kernel("gemm", part, mm, [hA, hB, hC], **step)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    steady = (ex.h2d_transfers - h2d, ex.d2h_transfers - d2h)
    kinds1 = {a: k for _n, _b, arrs in rt.comm_log[-2:-1] for a, k, _b in arrs}
    print(f"gemm path: step 1 {1e3 * (t1 - t0):.3f} ms ({plan1.bytes_total} B "
          f"moved, kinds {kinds1}), step 2 {1e3 * (t2 - t1):.3f} ms "
          f"({plan2.bytes_total} B moved, cached plan {plan2.cached}) "
          f"(host clock), launches {launches}, h2d/d2h {steady}")
    check(launches["gemm_hd"] == 2 * NPROC,
          f"gemm launches {launches['gemm_hd']} != {2 * NPROC}")
    check(kinds1.get("b") == "all_gather", f"gemm step 1 kinds {kinds1}")
    check(plan2.bytes_total == 0, "the second gemm moved bytes")
    check(steady == (0, 0), f"gemm steps crossed host<->device {steady}")
    # a third step rewrites the same C (the kernel is deterministic)
    device_breakdown(torch, "gemm path, 1 more step", lambda: rt.apply_kernel(
        "gemm", part, mm, [hA, hB, hC], **step))

    C = rt.read(hC, part)
    c64 = torch.from_numpy(Ah).cuda().double() @ torch.from_numpy(Bh).cuda().double()
    err = fro_rel(torch, torch.from_numpy(C).cuda(), c64)
    print(f"gemm path C vs float64 product: fro_rel={err:.3e} "
          f"(bound {GEMM_F32_TOL:g})")
    check(err <= GEMM_F32_TOL, f"gemm path C error {err}")

    p_col = rt.partition_col((n, n))
    total = rt.reduce(hC, "sum", p_col)
    fold = None
    for p in range(NPROC):
        (r0, r1), (c0, c1) = rt.parts[p_col].region(p).bounds
        part_sum = np.sum(C[int(r0):int(r1), int(c0):int(c1)])
        fold = part_sum if fold is None else np.add(fold, part_sum)
    want = float(c64.sum())
    scale = float(c64.abs().sum())
    red_err = abs(float(total) - want) / scale
    print(f"reduce(sum) over COL: {float(total)!r} ({np.asarray(total).dtype})"
          f", the float32 fold of C {float(fold)!r}, float64 {want!r}: "
          f"|diff|/sum|C| = {red_err:.3e} (bound {REDUCE_TOL:g}), "
          f"planned {rt.comm_log[-1][1]} B {rt.comm_log[-1][2]}")
    check(np.asarray(total).dtype == np.float32 and total == fold,
          f"reduce {total!r} is not the float32 fold of C {fold!r}")
    check(red_err <= REDUCE_TOL, f"reduce error {red_err}")

    p_w = rt.partition_row((n, n), weights=(2, 1, 1, 1))
    plan_w = rt.repartition(hC, part, p_w)
    C2 = rt.read(hC, p_w)
    same = np.array_equal(C2, C)
    print(f"weighted (2,1,1,1) repartition: {plan_w.bytes_total} B moved, "
          f"rank 0 rows {rt.parts[p_w].region(0).bounds[0]}, "
          f"reads back unchanged={same}")
    check(same, "weighted repartition changed C")
    rt.close()
    del c64
    torch.cuda.empty_cache()
    return launches, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(build.SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    jac, gemm = kernel_phase(torch)
    jac_launches, jac_step_ms = jacobi_path(torch)
    gemm_launches, gemm_step1_ms, gemm_step2_ms = gemm_path(torch)
    jac["launches"] = jac_launches["jacobi_hd"]
    gemm["launches"] = gemm_launches["gemm_hd"]
    check(jac_launches["gemm_hd"] == 0 and gemm_launches["jacobi_hd"] == 0,
          "a path launched the other path's kernel")
    print(f"main path: jacobi {jac_step_ms:.3f} ms/sweep, gemm step 1 "
          f"{gemm_step1_ms:.3f} ms, step 2 {gemm_step2_ms:.3f} ms "
          f"(host clock, {NPROC} ranks on one card)")
    print(json.dumps({"kernels": [jac, gemm]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
