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
   * Jacobi (20480, 24080) float32, 60 ping-pong sweeps under four
     schedules, each on a fresh runtime and each bit-identical to 60
     serial plain sweeps on the card: (a) apply_kernel in a loop,
     every step one CUDA graph; (b) run_pipeline, the steady window
     after the witness one captured cycle; (c) the §4.2 overlap
     schedule's run_pipeline (copies on a comm stream); (d) overlap
     apply_kernel, interior sweeps beside the halo copies.  Each prints
     ms per sweep, launches (executions), copies, h2d/d2h (0 in the
     run) and a device breakdown of two more sweeps;
   * the quickstart sequence at GEMM n = 10240: GEMM, a second GEMM
     that moves nothing (both fused, C bit-identical to the unfused
     product), reduce(sum) over a column partition, and a weighted
     (2, 1, 1, 1) repartition, against a float64 product.
3. Frees those buffers, holds the flash-attention kernel against its
   plain versions (bf16 at the serving path's prefill shape, small
   shapes with windows, softcaps, ragged and fully masked rows, odd
   head dims, and float32), timing it beside SDPA, and its backward
   kernels, ``wgmma`` (``ffma`` in float32), against float64 dense
   autograd (small shapes, bf16, fp16 and float32, GQA groups of 8 and
   1, Dh 64 and 128) and the plain blockwise backward at the training
   shape, timing it (and each of its launches) beside SDPA's backward;
   then drives
   the second path, models -> serve Engine, with yi-9b at full width (48
   layers, random weights from a seeded generator) in bfloat16: three
   admits of 2048, 1536 and 1024 tokens into a 4-slot pool of 4096
   positions, 16 decode steps after each, every request finished, and
   the first prompt admitted again, whose greedy continuation must
   repeat.
4. Drives the resilience layer (``ft/``, ``ckpt/``, the recoverable
   pipeline, ``RecoveryEngine``, ``ReplicaPool``), after the paths
   above so that they run as they did before it:
   (g) the same yi-9b weights behind a ReplicaPool of 2 replicas x 2
   instances (2 slots x 2048 each, prefix-aware routing, checkpoints
   every 4 decode steps): 6 seeded requests of 1024, 768, 512, 1024,
   768 and 512 tokens, 16 new tokens each, served without a fault and
   again with instance 1 of replica 0 silent for 6 ticks (membership
   fails it over: planned shrink, checkpoint restore, decode replay;
   then rejoins it); the streams must be equal, replica 0's
   recovery_log an instance_loss then an instance_join, and a decode
   step on the restored cache finite;
   (e) the Jacobi program under a RecoveryPolicy (checkpoints every 20
   sweeps, a transient fault at 25, rank 2 lost at 33's commit, back
   at 45): bit-identical to the serial plain sweeps, recovery_log a
   rank_loss with live [0, 1, 3] then a rank_join with [0, 1, 2, 3],
   at least 2 recoveries, 1 shrink and 1 grow;
   (f) the Jacobi program on rows weighted (2, 1, 1, 1) under a
   Rebalancer fed by per-rank CUDA-event times: it fires, the new
   weights are within 10% of even, the median max/min rank-time ratio
   after is below the threshold, the values bit-identical, the
   migration bytes in comm_log.
5. Trains, last, with every earlier buffer freed: (h) yi-9b at full
   width (d_model 4096, 32/4 heads of 128, d_ff 11008, vocab 64000),
   its depth cut to 8 of 48 layers, float32 masters, fp32 AdamW
   moments, bf16 compute: a gate on one microbatch's gradients, taken
   with the flash kernels and again with the plain blockwise
   attention, leaf by leaf; then 6 steps of TokenPipeline batches
   (seq_len 4096, global batch 2, 2 microbatches) through
   make_train_step, printing ms per step, tokens/s, peak memory, a
   device breakdown of a 7th step and the flash forward and backward
   launches (forward 2 per layer and microbatch, the checkpointed
   layer's recompute included; backward 1).  Then the training driver
   on the card as the reference's system test runs it: setup
   ("deepseek-7b", reduced), 40 steps, checkpoints every 10, a fault
   at step 20: a recovery, finite losses, the mean of the last 5 below
   that of the first 5.
   Every kernel launch counter, the total and each variant's, is set to
   0 just before each path (each Jacobi schedule, each phase) and read
   just after; counts are executions, a launch captured into a graph
   counting at each replay.  Every GEMM-path launch must be the
   ``pipelined`` variant, every yi-9b and qwen3 prefill launch the
   ``wgmma`` one, every gemma2 prefill launch ``mma_sync``, and every
   training backward the ``wgmma`` one.
6. Serves the other two ported families last, each at full width and
   full depth in bfloat16 alone on the card, through load_engine and
   the Engine with the yi-9b traffic above (admits of 2048, 1536, 1024
   tokens into 4 slots x 4096, 16 decode steps each, the first prompt
   again): gemma2-9b (alternating windows of 4096 and global, softcaps
   50 and 30; Dh 256, so every prefill launches flash's mma_sync
   variant, 42 per prefill; the re-admitted prompt must repeat) and
   qwen3-moe-30b-a3b (128 experts top-8 under the reference's capacity
   factor 1.25; 48 wgmma launches per prefill).  Under that capacity
   one slot's tokens can drop another's, so in place of the re-admit
   gate one prompt, admitted alone into a fresh Engine and decoded 16
   steps, twice, must leave bit-identical KV caches (every layer's
   input at every step; the streams, random weights' one token over
   and over, are compared too but show little);
   and layer 0's MoE at full width on the first admit's hidden state
   must lie within 2e-2 (relative Frobenius) of a float32 evaluation
   of the same routing.  Each prints its parameters against the bytes
   allocated, max_memory_allocated, prefill ms per admit, median
   decode ms, tokens/s and a device breakdown of one prefill and one
   decode step.  The flash phase (3.) also holds mma_sync at gemma2's
   heads against float64 (a window under T and softcap 50) and at
   gemma2's prefill shape against the plain blockwise version (its
   window of 4096, and one of 1000 that binds there), timed beside
   compiled flex_attention with the softcap as a score_mod and the
   window as a block mask (the library's one call for the function)
   and SDPA without the softcap (not the same function).
7. Prints one JSON line of kernel measurements, the card's name and
   power limit, and as the last line ``{"ok": true, "device": ...}``.

It exits non-zero, and prints no result, without a CUDA device or
without the repository's ``src/repro_torch`` beside it.  float32
products run in IEEE float32: TF32 is switched off for every matmul
and convolution the script times.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12            # outside the tensor cores
BF16_FLOPS_PER_S = 989e12           # tensor cores, dense

NPROC = 4
JACOBI_SHAPE = (20480, 24080)       # benchmarks/paper_programs.py:121
# >= 40 sweeps hold the overlapped schedules to serial plain sweeps over
# many cross-stream hand-offs, and the captured window of schedule (b)
# (from step 10, after the two-period witness) holds 50 of 60
SWEEPS = 60
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

# (e) recovery: checkpoints every 20 sweeps (two 1.97 GB arrays each,
# the newest RECOVERY_KEEP kept on disk); a transient fault at sweep
# 25, rank 2 lost at sweep 33's commit, rank 2 back at sweep 45
RECOVERY_INTERVAL = 20
RECOVERY_KEEP = 2
RECOVERY_FAULTS = (dict(step=25),
                   dict(step=33, site="commit", kind="rank", rank=2),
                   dict(step=45, kind="join", rank=2))
# (f) rebalancing: rank 0 sweeps 2/5 of the rows.  A quarter slab
# sweeps in about 0.36 ms, under the Rebalancer's default 1 ms floor
REBALANCE_WEIGHTS = (2, 1, 1, 1)
REBALANCE_MIN_DURATION = 1e-4
# (g) the serving cluster: yi-9b behind 2 replicas x 2 instances
POOL_SLOTS, POOL_MAX_SEQ = 2, 2048
POOL_PROMPTS = (1024, 768, 512, 1024, 768, 512)
POOL_SHARED = 512                   # the 4th prompt's prefix of the 1st
POOL_NEW_TOKENS = 16
POOL_CKPT_INTERVAL = 4
POOL_FAIL_TICK, POOL_DOWN_FOR = 2, 6

SERVE_ARCH = "yi-9b"
# the other families served last, each at full width and depth alone on
# the card: gemma2's Dh 256 takes flash's mma_sync variant, qwen3's 128
# wgmma
GEMMA2_ARCH, QWEN3_ARCH = "gemma2-9b", "qwen3-moe-30b-a3b"
# one bf16 MoE layer against a float32 evaluation of the same routing:
# the bf16 expert products round their operands and outputs (2**-9
# relative each), a few 1e-3 in the Frobenius norm; 2e-2 bounds it
MOE_LAYER_TOL = 2e-2
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 4096
PROMPTS = (2048, 1536, 1024)        # each >= FLASH_MIN_T: every prefill
DECODE_STEPS = 16                   # reaches the flash kernel
# flash attention against its plain version: bf16/fp16 a few 16-bit
# ulps from rounding p (normalized in the dense version, per kv tile
# in the kernel and the blockwise version); float32 the reference's
# own bound (tests/test_pallas_parity.py)
FLASH_TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 2e-5}
# at the serving shape, with about 1000 visible keys per row, |o| is
# near 0.04: 2e-2 would pass half of it.  Kernel and blockwise version
# both round p per kv tile, and differ by 3.9e-3 at most there (H100
# 80GB HBM3, 700 W); 1e-2 leaves room above that
FLASH_MAIN_TOL = 1e-2
# the flash backward against float64 dense autograd on the same rounded
# inputs.  float32: the reference's bound for its custom VJP (rtol =
# atol = 2e-4, tests/test_flash_attention.py).  16-bit: p and dz are
# rounded to the operand type before their products, and dq, dk, dv at
# the end (2**-9 relative each in bf16), a Frobenius-relative error of
# a few 1e-3; 2e-2 bounds it
BWD_F32_TOL = 2e-4
BWD_FRO_TOL = 2e-2
# at the training shape the kernel also takes delta = sum dO * o from
# its bf16 output o, where the plain blockwise backward keeps its
# float32 output; the two differ by the same few bf16 roundings
BWD_MAIN_TOL = 2e-2
BWD_SHAPES = (  # B, T, S, Hq, Hkv, D, window, softcap, qpos
    (2, 100, 130, 8, 1, 64, None, 0.0, "tail"),
    (2, 100, 130, 8, 1, 64, 16, 0.0, "tail"),
    (1, 257, 300, 8, 8, 128, None, 8.0, "tail"),
    (2, 200, 200, 16, 2, 128, 40, 5.0, "tail"),
    (2, 96, 80, 4, 2, 128, 5, 0.0, "ragged"),
    (1, 130, 130, 8, 1, 64, None, 0.0, "ragged"))

# (h) training: yi-9b at full width, depth cut to 8 of 48 layers (float32
# masters, grads and two fp32 moments take 16 bytes a parameter: 1.91 B
# parameters are 30.5 GB, all 48 layers would need about 147 GB)
TRAIN_ARCH, TRAIN_LAYERS = "yi-9b", 8
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 2, 2, 6
# the gate on one microbatch's gradients, kernels against the plain
# blockwise attention on the same float32 masters, bf16 compute: the
# two attentions round p and dz at other points (the kernel to bf16
# before each product), a few bf16 ulps at each layer's attention,
# carried back through 8 layers; Frobenius-relative per leaf
TRAIN_GRAD_TOL = 5e-2
# the training driver's fault path, as the reference's system test
FAULT_ARCH, FAULT_STEPS, FAULT_EVERY, FAULT_AT = "deepseek-7b", 40, 10, 20


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


def device_breakdown(torch, label: str, fn, top: int = 4,
                     host_top: int = 0) -> None:
    """Run ``fn`` once under torch.profiler and print its host wall
    time, the device's busy time in it (the union of every kernel, copy
    and memset interval on the card), the device time of the ``top``
    busiest kernels by name and, with ``host_top``, the host ops with
    the most self time."""
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
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        print(f"  host ops by self time ({len(prof.events())} events):")
        for a in ops[:host_top]:
            print(f"  {a.self_cpu_time_total / 1e3:9.3f} ms host x{a.count:<5d} "
                  f"{a.key[:80]}")


def ptxas_report(log: str, nvcc: str):
    """(kernel, report) for each kernel in an ``nvcc -Xptxas -v`` log:
    the kernel's name as the toolkit's ``cu++filt`` prints it, and its
    registers and spills on one line."""
    import re

    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append((m.group(1), []))
        elif out and ("Used" in line or "spill" in line):
            out[-1][1].append(line.split(":", 1)[-1].strip())
    syms = [sym for sym, _ in out]
    # names only: a name that does not demangle stays as ptxas wrote it
    names = subprocess.run([str(Path(nvcc).with_name("cu++filt")), "-p",
                            *syms], capture_output=True, text=True,
                           check=True).stdout.splitlines() if syms else []
    check(len(names) == len(syms), f"cu++filt gave {len(names)} names for "
          f"{len(syms)} kernels")
    return [(name.replace("<unnamed>::", ""), "; ".join(lines))
            for name, (_, lines) in zip(names, out)]


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
    print(f"gemm at {gemm['shape']}: pipelined {gemm['ms']:.4f} ms, plain "
          f"{gemm['plain_ms']:.4f} ms, torch.mm {gemm['library_ms']:.4f} ms, "
          f"bound {gemm['bound_ms']:.4f} ms")
    del a_full, a, b, c_full, c, cases
    torch.cuda.empty_cache()
    return jac, gemm


def flash_work(torch, qpos, S: int, B: int, Hq: int, Hkv: int, Dh: int,
               Dv: int, itemsize: int):
    """(flops, bytes) that causal attention needs for these query
    positions: 4 * Dh flops (q.k and p.v) per visible (query, key) pair
    and head; q and o once, and the k and v rows some query sees."""
    seen = torch.clamp(qpos.long() + 1, 0, S)          # visible keys
    pairs = int(seen.sum())
    rows = int(seen.amax(dim=1).sum())                # kv rows read
    T = qpos.shape[1]
    flops = 2 * Hq * (Dh + Dv) * pairs
    nbytes = itemsize * (B * T * Hq * (Dh + Dv) + rows * Hkv * (Dh + Dv))
    return flops, nbytes


def flash_phase(torch):
    """The flash-attention kernel against its plain versions on the
    card, each in its working type, then its time beside the plain
    version's and SDPA's at the serving path's prefill shape; the same
    for the mma_sync variant at gemma2's, beside flex_attention with the
    softcap (SDPA without it is not the same function).  Returns the two
    measurements."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_variant)
    from repro_torch.kernels.flash_attention.ref import dense_attention
    from repro_torch.models.lm import BIG_WINDOW

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(dtype, B, T, S, Hq, Hkv, Dh, Dv=None):
        """q, and k and v as strided views of one interleaved buffer,
        as the cache's layout might hold them."""
        Dv = Dv or Dh
        q = torch.randn((B, T, Hq, Dh), generator=g, device=dev).to(dtype)
        kv = torch.randn((B, S, 2, Hkv, max(Dh, Dv)), generator=g,
                         device=dev).to(dtype)
        return q, kv[:, :, 0, :, :Dh], kv[:, :, 1, :, :Dv]

    def compare(name, dtype, q, k, v, qpos, plain, tol=None, **kw):
        got = flash_attention_cuda(q, k, v, qpos=qpos, **kw)
        want = plain(q, k, v, qpos=qpos, **kw)
        torch.cuda.synchronize()
        tol = tol or FLASH_TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        bad = int((err > tol + tol * want.float().abs()).sum())
        print(f"flash {name} {str(dtype).split('.')[-1]}: max_abs_err="
              f"{float(err.max()):.3e} outside rtol=atol={tol:g}: {bad}")
        check(bad == 0 and got.dtype == dtype,
              f"flash kernel differs from plain at {name}")
        return got, float(err.max())

    # -- the serving path's prefill shape: the first admit's qpos and
    # the window every prefill of a global-attention model passes ------
    cfg = get_config(SERVE_ARCH)
    B, T, S = SERVE_SLOTS, PROMPTS[0], SERVE_MAX_SEQ
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = inputs(torch.bfloat16, B, T, S, Hq, Hkv, Dh)
    qpos = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
    _, main_err = compare(f"main {tuple(q.shape)} x k,v {tuple(k.shape)} "
                          f"strides {k.stride()} window=BIG_WINDOW",
                          torch.bfloat16, q, k, v, qpos, blockwise_attention,
                          tol=FLASH_MAIN_TOL, window=BIG_WINDOW)

    # -- small shapes, each feature, against the dense oracle -----------
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for name, shape, kw in (
                ("window=16", (2, 100, 130, 4, 2, 64), dict(window=16)),
                ("softcap=8", (2, 100, 130, 4, 2, 64), dict(softcap=8.0)),
                ("Dh=Dv=64", (2, 257, 300, 8, 2, 64), {}),
                ("Dh=Dv=128, T and S off the tiles",
                 (2, 200, 300, 8, 2, 128), {}),
                ("Dh=Dv=128 window=40 softcap=5",
                 (1, 257, 513, 8, 2, 128), dict(window=40, softcap=5.0)),
                ("Dh=Dv=256", (1, 130, 200, 4, 1, 256), {}),
                ("Dh=192 Dv=128", (2, 70, 90, 4, 2, 192, 128), {})):
            q, k, v = inputs(dtype, *shape)
            Bs, Ts, Ss = shape[:3]
            qp = torch.arange(Ss - Ts, Ss, dtype=torch.int32,
                              device=dev).repeat(Bs, 1)
            compare(name, dtype, q, k, v, qp, dense_attention, **kw)
        q, k, v = inputs(dtype, 2, 96, 80, 4, 2, 128)
        qp = torch.randint(-1, 90, (2, 96), generator=g, device=dev,
                           dtype=torch.int32)
        qp[:, :9] = -1                                # padding rows
        qp[1, 20:30] = 200                            # window 5: none seen
        out, _ = compare("ragged qpos with -1 and fully masked rows, "
                         "window=5", dtype, q, k, v, qp, dense_attention,
                         window=5)
        masked = out[:, :9].abs().sum() + out[1, 20:30].abs().sum()
        check(float(masked) == 0.0, "fully masked flash rows are not 0")

    # -- time at the main shape -----------------------------------------
    q, k, v = inputs(torch.bfloat16, B, T, S, Hq, Hkv, Dh)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    kernel = lambda: flash_attention_cuda(           # noqa: E731
        q, k, v, qpos=qpos, window=BIG_WINDOW)
    lib_err = float((sdpa().transpose(1, 2).float() - kernel().float())
                    .abs().max())
    print(f"flash vs SDPA (is_causal, enable_gqa) at the main shape: "
          f"max_abs_diff={lib_err:.3e}")
    check(lib_err <= FLASH_TOL["bfloat16"] * 4, "SDPA computes another "
          "function than the kernel at the main shape")
    flops, nbytes = flash_work(torch, qpos, S, B, Hq, Hkv, Dh, Dh, 2)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    flash = dict(
        name="flash_attn_hd", route="cuda",
        source="src/repro_torch/csrc/flash_attn_hd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        max_abs_err=main_err,
        ms=cuda_ms(torch, kernel, 20),
        plain_ms=cuda_ms(torch, lambda: blockwise_attention(
            q, k, v, qpos=qpos, window=BIG_WINDOW), 3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=cuda_ms(torch, sdpa, 20),
        shape=[list(q.shape), list(k.shape)])
    print(f"flash at {tuple(q.shape)} x {tuple(k.shape)}: {flops:.4e} flops, "
          f"{nbytes:.4e} bytes; kernel ({flash_variant(q.dtype, Dh, Dh)}) "
          f"{flash['ms']:.4f} ms ({flops / flash['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * flash['bound_ms'] / flash['ms']:.1f}% of the bound), "
          f"bound {flash['bound_ms']:.4f} ms ({flash['bound_by']}), plain "
          f"{flash['plain_ms']:.4f} ms, SDPA {flash['library_ms']:.4f} ms")
    del q, k, v, qt, kt, vt

    # -- mma_sync at gemma2's heads (16/8 of Dh 256): its local window
    # under T with the softcap against float64, then the first admit's
    # prefill shape against the plain blockwise version, at gemma2's
    # window (which, like its odd layers' BIG_WINDOW, never binds in a
    # 4096-position cache) and at one that binds there, off the tiles
    g2 = get_config(GEMMA2_ARCH)
    Hq2, Hkv2, D2, cap = g2.n_heads, g2.n_kv_heads, g2.head_dim, \
        g2.attn_softcap
    check(flash_variant(torch.bfloat16, D2, D2) == "mma_sync",
          f"{GEMMA2_ARCH}'s Dh {D2} does not take the mma_sync variant")

    def oracle(q, k, v, qpos, **kw):
        return dense64(torch, q.double(), k.double(), v.double(), qpos, **kw)

    for dtype in (torch.bfloat16, torch.float16):
        q, k, v = inputs(dtype, 2, 200, 330, Hq2, Hkv2, D2)
        q = q * 30                 # logits of about 30: the cap bends them
        qp = torch.arange(130, 330, dtype=torch.int32, device=dev).repeat(2, 1)
        compare(f"mma_sync Dh=Dv={D2} {Hq2}/{Hkv2} heads q x 30 window=40 "
                f"softcap={cap:g} (float64 dense)", dtype, q, k, v, qp,
                oracle, window=40, softcap=cap)
    q2, k2, v2 = inputs(torch.bfloat16, B, T, S, Hq2, Hkv2, D2)
    mma_err = 0.0
    for w in (g2.window, 1000):
        _, err = compare(f"mma_sync {GEMMA2_ARCH} prefill {tuple(q2.shape)} x "
                         f"k,v {tuple(k2.shape)} strides {k2.stride()} "
                         f"window={w} softcap={cap:g}", torch.bfloat16, q2,
                         k2, v2, qpos, blockwise_attention,
                         tol=FLASH_MAIN_TOL, window=w, softcap=cap)
        mma_err = max(mma_err, err)
    q2t, k2t, v2t = (x.transpose(1, 2) for x in (q2, k2, v2))
    flops, nbytes = flash_work(torch, qpos, S, B, Hq2, Hkv2, D2, D2, 2)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    # the library's one call for this function; with q x 30 the cap
    # bends the logits, so agreement there shows the same function
    flex = flex_softcap(torch, k2, v2, qpos, g2.window, cap)
    q30 = q2 * 30
    lib_err = float((flex(q30.transpose(1, 2).contiguous()).transpose(1, 2)
                     .float() - flash_attention_cuda(
                         q30, k2, v2, qpos=qpos, window=g2.window,
                         softcap=cap).float()).abs().max())
    q2h = q2.transpose(1, 2).contiguous()
    print(f"flash mma_sync vs flex_attention (softcap score_mod, window "
          f"block mask, enable_gqa) at {GEMMA2_ARCH}'s prefill shape, q x 30: "
          f"max_abs_diff={lib_err:.3e}")
    check(lib_err <= FLASH_TOL["bfloat16"] * 4, "flex_attention computes "
          "another function than the mma_sync kernel")
    del q30
    flash_mma = dict(
        name="flash_attn_hd", variant="mma_sync", route="cuda",
        source="src/repro_torch/csrc/flash_attn_hd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        max_abs_err=mma_err,
        ms=cuda_ms(torch, lambda: flash_attention_cuda(
            q2, k2, v2, qpos=qpos, window=g2.window, softcap=cap), 10),
        plain_ms=cuda_ms(torch, lambda: blockwise_attention(
            q2, k2, v2, qpos=qpos, window=g2.window, softcap=cap), 3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=cuda_ms(torch, lambda: flex(q2h), 10),
        sdpa_without_softcap_ms=cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q2t, k2t, v2t, is_causal=True, enable_gqa=True), 10),
        shape=[list(q2.shape), list(k2.shape)], window=g2.window,
        softcap=cap)
    print(f"flash mma_sync at {tuple(q2.shape)} x {tuple(k2.shape)} window "
          f"{g2.window} softcap {cap:g}: {flops:.4e} flops, {nbytes:.4e} "
          f"bytes; kernel {flash_mma['ms']:.4f} ms "
          f"({flops / flash_mma['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * flash_mma['bound_ms'] / flash_mma['ms']:.1f}% of the "
          f"bound), bound {flash_mma['bound_ms']:.4f} ms "
          f"({flash_mma['bound_by']}), plain {flash_mma['plain_ms']:.4f} ms, "
          f"flex_attention {flash_mma['library_ms']:.4f} ms; SDPA without "
          f"the softcap, NOT the same function, "
          f"{flash_mma['sdpa_without_softcap_ms']:.4f} ms")
    del q2, k2, v2, q2t, k2t, v2t, q2h, flex
    torch.cuda.empty_cache()
    return flash, flash_mma


def flex_softcap(torch, k, v, qpos, window: int, softcap: float):
    """One PyTorch call for causal GQA attention at ``qpos`` with a
    ``window`` and a tanh ``softcap``: compiled flex_attention, whose
    score_mod caps the scaled logits and whose block mask is the
    window, on head-major copies of k and v.  Returns it as a function
    of a head-major q (B, Hq, T, Dh), output (B, Hq, T, Dv)."""
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    inductor_config.compile_threads = 1        # no compile workers
    qp = qpos.long()

    def mask_mod(b, h, qi, ki):
        p = qp[b, qi]
        return (p >= 0) & (ki <= p) & (ki > p - window)

    def score_mod(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    B, T = qp.shape
    mask = create_block_mask(mask_mod, B, None, T, k.shape[1],
                             device=k.device)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda qt: fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                         enable_gqa=True)


def dense64(torch, q, k, v, qpos, window=None, softcap=0.0):
    """Dense GQA attention in float64 whose masked logits are -1e300,
    not -inf: a fully masked row's softmax is finite (then zeroed), so
    its backward carries no NaN into dk and dv."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kk, vv = (x.repeat_interleave(Hq // Hkv, 2) for x in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, kk) / D ** 0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=q.device)
    qp = qpos.long()[:, None, :, None]
    seen = (kpos <= qp) & (qp >= 0)
    if window is not None:
        seen &= kpos > qp - window
    p = torch.softmax(torch.where(seen, s, -1e300), dim=-1)
    p = torch.where(seen.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhts,bshd->bthd", p, vv)


def bwd_blocks(torch, qpos, S: int, Hq: int, rows: int = 64,
               keys: int = 128):
    """The wgmma dK and dV kernels' work at these query positions, as
    their producers walk it: (blocks, tile steps in all, the longest
    block's steps).  A block is (keys keys, query head, batch); a step
    is one 64-row query tile some row of which sees one of its keys."""
    B, T = qpos.shape
    n = -(-T // rows)
    pad = torch.full((B, n * rows), -1, dtype=torch.long, device=qpos.device)
    pad[:, :T] = qpos.long()
    tiles = pad.view(B, n, rows)
    valid = tiles >= 0
    hi = torch.where(valid, torch.clamp(tiles, max=S - 1), -1).amax(-1)
    k0 = torch.arange(0, S, keys, device=qpos.device)
    # causal (no window): a tile sees the block when its last row does
    steps = (hi[:, None, :] >= k0[None, :, None]).sum(-1)   # (B, blocks)
    return (B * Hq * len(k0), int(steps.sum()) * Hq, int(steps.max()))


def bwd_split(torch, fn, reps: int = 5):
    """Device ms per launch of each kernel of the wgmma backward, from
    torch.profiler over ``reps`` calls of ``fn``."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = {"prep_kernel": "pre-pass", "dq_wgmma_kernel": "dQ",
             "gqa_sum_kernel": "GQA sum"}
    split = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"dkv_wgmma_kernel<[^>]*, (true|false)>", e.name)
        label = ("dK" if m.group(1) == "true" else "dV") if m else next(
            (v for k, v in names.items() if k in e.name), None)
        if label is None:
            continue
        us, count = split.get(label, (0.0, 0))
        split[label] = (us + e.time_range.end - e.time_range.start, count + 1)
    return {k: us / 1e3 / count for k, (us, count) in split.items()}


def flash_bwd_phase(torch):
    """The flash backward kernels, wgmma (ffma in float32), against
    float64 dense autograd at small shapes and against the plain
    blockwise backward at the training shape, then their time beside
    the plain backward's and SDPA's backward at that shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.models.lm import BIG_WINDOW

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(dtype, B, T, S, Hq, Hkv, D, kind):
        q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dtype)
                       for sh in ((B, T, Hq, D), (B, S, Hkv, D),
                                  (B, S, Hkv, D), (B, T, Hq, D)))
        if kind == "tail":
            qpos = torch.arange(S - T, S, dtype=torch.int32,
                                device=dev).repeat(B, 1)
        else:                   # ragged, padding rows, rows seeing nothing
            qpos = torch.randint(-1, S + 10, (B, T), generator=g,
                                 device=dev, dtype=torch.int32)
            qpos[:, :9] = -1
            qpos[-1, 20:30] = S + 200
        return q, k, v, do, qpos

    def kernel_grads(q, k, v, do, qpos, **kw):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fk.flash_attention_cuda(*leaves, qpos=qpos, **kw)
        check(out.grad_fn is not None, "flash forward with grad has no "
              "grad_fn")
        out.backward(do)
        return [x.grad for x in leaves]

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for B, T, S, Hq, Hkv, D, window, softcap, kind in BWD_SHAPES:
            variant = fk.bwd_variant(dtype, D, D)
            q, k, v, do, qpos = inputs(dtype, B, T, S, Hq, Hkv, D, kind)
            kw = dict(window=window, softcap=softcap)
            leaves = [x.double().requires_grad_() for x in (q, k, v)]
            dense64(torch, *leaves, qpos, **kw).backward(do.double())
            auto = kernel_grads(q, k, v, do, qpos, **kw)
            out, lse = fk._forward(q, k, v, qpos, window, softcap, None,
                                   with_lse=True)
            got = fk.flash_attention_bwd_cuda(do, q, k, v, out, lse,
                                              qpos=qpos, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, auto)),
                  f"flash backward through autograd differs from a direct "
                  f"launch at {(B, T, S, Hq, Hkv, D)}")
            errs = []
            for name, x, w in zip("qkv", got, leaves):
                check(x.dtype == dtype and bool(torch.isfinite(x).all()),
                      f"flash backward {variant} d{name} not finite {dtype}")
                if dtype == torch.float32:
                    e = (x.double() - w.grad).abs()
                    bad = int((e > BWD_F32_TOL * (1 + w.grad.abs())).sum())
                    check(bad == 0, f"flash backward d{name} float32 "
                          f"differs from float64 at {(B, T, S, Hq, Hkv, D)}")
                    errs.append(float(e.max()))
                else:
                    e = fro_rel(torch, x, w.grad)
                    check(e <= BWD_FRO_TOL, f"flash backward {variant} "
                          f"d{name} {dtype} at {(B, T, S, Hq, Hkv, D)}: {e}")
                    errs.append(e)
            print(f"flash bwd {variant} {str(dtype).split('.')[-1]} "
                  f"B,T,S,Hq,Hkv,D={(B, T, S, Hq, Hkv, D)} window={window} "
                  f"softcap={softcap} qpos={kind}: "
                  + ("max_abs_err" if dtype == torch.float32 else "fro_rel")
                  + " dq,dk,dv=" + ", ".join(f"{e:.3e}" for e in errs))

    # -- the training shape: one layer of yi-9b at 4096 tokens ----------
    cfg_T, Hq, Hkv, D = TRAIN_SEQ, 32, 4, 128
    q, k, v, do, qpos = inputs(torch.bfloat16, 1, cfg_T, cfg_T, Hq, Hkv, D,
                               "tail")
    out, lse = fk._forward(q, k, v, qpos, BIG_WINDOW, 0.0, None,
                           with_lse=True)

    def kernel():
        return fk.flash_attention_bwd_cuda(do, q, k, v, out, lse, qpos=qpos,
                                           window=BIG_WINDOW)

    got = kernel()
    again = kernel()
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    out_p = blockwise_attention(*plain, qpos=qpos, window=BIG_WINDOW)
    want = torch.autograd.grad(out_p, plain, do, retain_graph=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "two wgmma backward launches differ at the training shape")
    main_err, rels = 0.0, []
    for name, x, w in zip("qkv", got, want):
        rels.append(fro_rel(torch, x, w))
        main_err = max(main_err, float((x.float() - w.float()).abs().max()))
        check(rels[-1] <= BWD_MAIN_TOL, f"flash backward d{name} at the "
              f"training shape: {rels[-1]} against the plain backward")
    print(f"flash bwd main bf16 q {tuple(q.shape)} k,v {tuple(k.shape)} "
          f"causal: fro_rel dq,dk,dv vs plain blockwise = "
          + ", ".join(f"{e:.3e}" for e in rels)
          + f" (bound {BWD_MAIN_TOL:g}), max_abs_err={main_err:.3e}, two "
          f"launches bit-identical")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    do_t = do.transpose(1, 2)
    lib = torch.autograd.grad(o_s, (qt, kt, vt), do_t, retain_graph=True)
    lib_err = max(fro_rel(torch, a.transpose(1, 2), b)
                  for a, b in zip(lib, got))
    print(f"flash bwd vs SDPA backward at the training shape: fro_rel "
          f"{lib_err:.3e}")
    check(lib_err <= 2 * BWD_MAIN_TOL, "SDPA's backward computes another "
          "function than the kernel at the training shape")
    seen = torch.clamp(qpos.long() + 1, 0, cfg_T)
    pairs = int(seen.sum())
    flops = pairs * Hq * (6 * D + 4 * D)
    nbytes = 2 * (4 * cfg_T * Hq * D + 4 * cfg_T * Hkv * D) + 4 * Hq * cfg_T
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    split = bwd_split(torch, kernel)
    blocks, steps, longest = bwd_blocks(torch, qpos, cfg_T, Hq)
    bwd = dict(
        name="flash_attn_bwd_hd", route="cuda",
        source="src/repro_torch/csrc/flash_attn_bwd_hd.cu",
        replaces="src/repro/kernels/flash_attention/jnp_impl.py:130",
        max_abs_err=main_err,
        ms=cuda_ms(torch, kernel, 10),
        plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            out_p, plain, do, retain_graph=True), 3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o_s, (qt, kt, vt), do_t, retain_graph=True), 10),
        wgmma_split_ms={k: round(x, 4) for k, x in split.items()},
        shape=[list(q.shape), list(k.shape)])
    print(f"flash bwd at {tuple(q.shape)} x {tuple(k.shape)}: {flops:.4e} "
          f"flops (10 D a pair and head), {nbytes:.4e} bytes; bound "
          f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}), plain "
          f"{bwd['plain_ms']:.4f} ms, SDPA backward "
          f"{bwd['library_ms']:.4f} ms")
    print(f"  wgmma: {bwd['ms']:.4f} ms ({flops / bwd['ms'] / 1e9:.1f} "
          f"TFLOP/s at 10 D, {100 * bwd['bound_ms'] / bwd['ms']:.1f}% of the "
          f"bound)")
    print(f"  wgmma per launch (torch.profiler, ms): "
          + ", ".join(f"{k} {x:.4f}" for k, x in split.items())
          + f"; dK, dV grid {blocks} blocks, {steps} tile steps, the "
          f"longest {longest} ({100 * longest * 132 / steps:.1f}% of an "
          f"SM's even share, from the tile counts)")
    del q, k, v, do, out, lse, got, again, plain, out_p, want
    del qt, kt, vt, o_s, lib
    torch.cuda.empty_cache()
    return bwd


def _wrappers():
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.gemm_hd.kernel import gemm_cuda
    from repro_torch.kernels.stencil_hd.kernel import jacobi_cuda
    return {"jacobi_hd": jacobi_cuda, "gemm_hd": gemm_cuda,
            "flash_attn_hd": flash_attention_cuda,
            "flash_attn_bwd_hd": flash_attention_bwd_cuda}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "by_variant"):
            fn.by_variant = dict.fromkeys(fn.by_variant, 0)


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_variants():
    """Launches per variant of each kernel (the Jacobi source has one)."""
    return {name: dict(getattr(fn, "by_variant", {"f32": fn.launches}))
            for name, fn in _wrappers().items()}


def jacobi_program(rt, init, weights=None):
    """The ping-pong Jacobi program on ``rt``: A and B written with
    ``init`` over a row partition (``weights`` per rank, even without),
    SWEEPS steps over the interior.  Returns A, the steps and the data
    partition."""
    from repro_torch.core import Box, IDENTITY_2D, stencil
    from repro_torch.kernels.hd import make_jacobi_kernel

    M, N = JACOBI_SHAPE
    A, B = rt.create("A", (M, N)), rt.create("B", (M, N))
    pd = rt.partition_row((M, N), weights=weights)
    pw = rt.partition_row((M, N), region=Box.make((1, M - 1), (1, N - 1)),
                          weights=weights)
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    ab, ba = make_jacobi_kernel("A", "B"), make_jacobi_kernel("B", "A")
    fp = stencil(2, 1)
    prog = [dict(kernel_name="jab", part_id=pw, kernel=ab, arrays=[A, B],
                 uses={"A": fp}, defs={"B": IDENTITY_2D}) if i % 2 == 0 else
            dict(kernel_name="jba", part_id=pw, kernel=ba, arrays=[A, B],
                 uses={"B": fp}, defs={"A": IDENTITY_2D})
            for i in range(SWEEPS)]
    return A, prog, pd


def sweep_launches(rt, prog, plans, split: bool) -> int:
    """Jacobi kernel executions the program's steps make: one per rank
    and step, or, where a step sweeps under the exact halo split, one
    per interior and boundary box."""
    from repro_torch.executors import halo_split

    n = 0
    for st, plan in zip(prog, plans):
        regions = rt.parts[st["part_id"]].regions
        cut = halo_split(plan, regions, st["uses"], st["defs"]) \
            if split else None
        boxes = list(regions) if cut is None else \
            [b for half in cut for rank in half for b in rank]
        n += sum(1 for b in boxes if not b.is_empty())
    return n


def apply_loop(rt, prog):
    return [rt.apply_kernel(st["kernel_name"], st["part_id"], st["kernel"],
                            st["arrays"], st["uses"], st["defs"])
            for st in prog]


def pipeline(rt, prog):
    return rt.run_pipeline(prog)


# (label, overlap, how the steps are run, whether they sweep under the
# halo split)
JACOBI_SCHEDULES = (
    ("(a) apply_kernel loop, every step fused", False, apply_loop, True),
    ("(b) run_pipeline, steady window captured", False, pipeline, True),
    ("(c) overlap run_pipeline", True, pipeline, False),
    ("(d) overlap apply_kernel loop, halo split", True, apply_loop, True),
)


def jacobi_data(torch):
    """The Jacobi path's seeded data and SWEEPS serial plain sweeps of
    it on the card (the last sweep defines A)."""
    from repro_torch.kernels.stencil_hd.ref import jacobi_ref

    M, N = JACOBI_SHAPE
    t0 = time.perf_counter()
    init = np.random.default_rng(0).standard_normal((M, N), dtype=np.float32)
    x = torch.from_numpy(init).cuda()
    for _ in range(SWEEPS):
        x = jacobi_ref(x)
    want = x.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    print(f"jacobi path: data and {SWEEPS} serial plain sweeps "
          f"{time.perf_counter() - t0:.3f} s")
    return init, want


def jacobi_path(torch, init, want):
    """The Jacobi program at the paper's size under each schedule of
    JACOBI_SCHEDULES, each on a fresh runtime from the same data and
    each bit-identical to SWEEPS serial plain sweeps on the card."""
    from repro_torch.core import HDArrayRuntime

    launches, ms = {}, {}
    for label, overlap, drive, split in JACOBI_SCHEDULES:
        tag = label[:3]
        t0 = time.perf_counter()
        rt = HDArrayRuntime(NPROC, overlap=overlap)   # torch on the card
        A, prog, _pd = jacobi_program(rt, init)
        ex = rt.executor
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        h2d, d2h = ex.h2d_transfers, ex.d2h_transfers
        mem = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        plans = drive(rt, prog)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        graph_mb = (torch.cuda.memory_allocated() - mem) / 2 ** 20
        got = read_launches()
        launches[tag] = got
        ms[tag] = 1e3 * dt / SWEEPS
        steady = (ex.h2d_transfers - h2d, ex.d2h_transfers - d2h)
        st = rt.planner.stats
        kinds = sorted({k for _n, _b, arrs in rt.comm_log[-SWEEPS:]
                        for _a, k, _b in arrs})
        halo_bytes = sum(b for _n, b, _a in rt.comm_log[-SWEEPS:])
        sched = rt._scheduler
        print(f"jacobi {label}: {SWEEPS} sweeps x {NPROC} ranks at "
              f"{JACOBI_SHAPE}: {ms[tag]:.3f} ms/sweep (host clock, set-up "
              f"{setup:.3f} s apart), launches {got}, copies "
              f"{ex.copy_counts}, h2d/d2h during the run {steady}, kinds "
              f"{kinds}, halo bytes {halo_bytes}, fused_steps "
              f"{st.fused_steps}, scan_captures {st.scan_captures}, "
              f"dispatches/step {st.python_dispatches_per_step}, graphs "
              f"{len(ex._graphs)} holding {graph_mb:.3f} MiB"
              + (f", steps_overlapped {sched.steps_overlapped}, halo_splits "
                 f"{sched.halo_splits}" if sched is not None else ""))
        expect = sweep_launches(rt, prog, plans, split)
        check(got["jacobi_hd"] == expect,
              f"jacobi {tag} launches {got['jacobi_hd']} != {expect}")
        check(split or expect == SWEEPS * NPROC,
              f"jacobi {tag} expected {expect} launches unsplit")
        check(got["gemm_hd"] == got["flash_attn_hd"] == 0,
              f"jacobi {tag} launched another kernel: {got}")
        check(steady == (0, 0), f"jacobi {tag} steady host<->device "
              f"transfers {steady}")
        check(kinds == ["halo", "none"], f"jacobi {tag} comm kinds {kinds}")
        check(sum(ex.copy_counts.values()) == ex.messages_executed > 0,
              f"jacobi {tag} copies {ex.copy_counts}")
        if tag == "(a)":
            check(st.fused_steps == SWEEPS and st.scan_captures == 0,
                  f"(a) fused {st.fused_steps}, captures {st.scan_captures}")
        elif tag == "(b)":
            captured = SWEEPS - st.fused_steps
            print(f"jacobi (b): the captured window holds {captured} of "
                  f"{SWEEPS} sweeps")
            check(st.scan_captures >= 1
                  and st.python_dispatches_per_step == 0.0
                  and captured >= 0.8 * SWEEPS,
                  f"(b) captures {st.scan_captures}, {captured} sweeps "
                  f"captured, dispatches {st.python_dispatches_per_step}")
        else:
            check(sched.steps_overlapped == SWEEPS and st.fused_steps == 0,
                  f"{tag} overlapped {sched.steps_overlapped}")
            check((sched.halo_splits == SWEEPS) == split,
                  f"{tag} halo splits {sched.halo_splits}")
        same = np.array_equal(rt.read_coherent(A), want)
        print(f"jacobi {tag} vs {SWEEPS} serial plain sweeps: "
              f"bit-identical={same}")
        check(same, f"jacobi {tag} differs from serial plain sweeps")
        # the same schedule again, every graph captured already
        t0 = time.perf_counter()
        drive(rt, prog)
        torch.cuda.synchronize()
        print(f"jacobi {tag} again: "
              f"{1e3 * (time.perf_counter() - t0) / SWEEPS:.3f} ms/sweep "
              f"(host clock)")
        device_breakdown(torch, f"jacobi {tag}, 2 more sweeps",
                         lambda: drive(rt, prog[:2]))
        fused = st.fused_steps
        device_breakdown(torch, f"jacobi {tag}, 20 more sweeps",
                         lambda: drive(rt, prog[:20]))
        if tag == "(b)":
            print(f"jacobi (b): {20 - (st.fused_steps - fused)} of those 20 "
                  f"sweeps ran in the captured window")
        rt.close()
        torch.cuda.empty_cache()
    return launches, ms


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
    variants = read_variants()
    steady = (ex.h2d_transfers - h2d, ex.d2h_transfers - d2h)
    kinds1 = {a: k for _n, _b, arrs in rt.comm_log[-2:-1] for a, k, _b in arrs}
    print(f"gemm path: step 1 {1e3 * (t1 - t0):.3f} ms ({plan1.bytes_total} B "
          f"moved, kinds {kinds1}), step 2 {1e3 * (t2 - t1):.3f} ms "
          f"({plan2.bytes_total} B moved, cached plan {plan2.cached}) "
          f"(host clock), launches {launches}, by variant "
          f"{variants['gemm_hd']}, h2d/d2h {steady}")
    check(launches["gemm_hd"] == 2 * NPROC,
          f"gemm launches {launches['gemm_hd']} != {2 * NPROC}")
    check(variants["gemm_hd"] == {"tiled": 0, "pipelined": 2 * NPROC},
          f"gemm path launches by variant {variants['gemm_hd']}: every one "
          f"must be the pipelined kernel")
    check(kinds1.get("b") == "all_gather", f"gemm step 1 kinds {kinds1}")
    check(plan2.bytes_total == 0, "the second gemm moved bytes")
    check(steady == (0, 0), f"gemm steps crossed host<->device {steady}")
    check(rt.planner.stats.fused_steps == 2,
          f"gemm fused steps {rt.planner.stats.fused_steps} != 2")
    C = rt.read(hC, part)
    # the same product unfused: the executor's two-phase kernel path
    ex.run_kernel(mm, rt.parts[part].regions, [hA, hB, hC], defs=("c",))
    same = np.array_equal(rt.read(hC, part), C)
    print(f"gemm path: fused C bit-identical to the unfused product={same}")
    check(same, "the fused gemm steps differ from the unfused product")
    # a third step rewrites the same C (the kernel is deterministic) and
    # captures the no-traffic step's graph; the fourth replays it
    rt.apply_kernel("gemm", part, mm, [hA, hB, hC], **step)
    device_breakdown(torch, "gemm path, 1 more step (graph replay)",
                     lambda: rt.apply_kernel("gemm", part, mm,
                                             [hA, hB, hC], **step))
    check(len(ex._graphs) == 1, f"gemm graphs {list(ex._graphs)}")

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
    return launches, variants, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def recovery_phase(torch, init, want):
    """(e) The Jacobi program under a RecoveryPolicy: checkpoints every
    RECOVERY_INTERVAL sweeps, a transient fault, the loss of rank 2 at
    a commit (the mesh shrinks 4 -> 3), and its rejoin (3 -> 4)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import HDArrayRuntime
    from repro_torch.ft import FaultInjector, FaultSpec, RecoveryPolicy

    ckdir = ROOT / "build" / "smoke_ckpt_jacobi"
    shutil.rmtree(ckdir, ignore_errors=True)
    t_phase = time.perf_counter()
    rt = HDArrayRuntime(NPROC)                 # torch on the card
    A, prog, pd = jacobi_program(rt, init)
    ex = rt.executor
    cm = CheckpointManager(str(ckdir), keep=RECOVERY_KEEP)
    inj = FaultInjector([FaultSpec(**f) for f in RECOVERY_FAULTS])
    pol = RecoveryPolicy(checkpoint=cm, interval=RECOVERY_INTERVAL,
                         injector=inj, data_parts={"A": pd, "B": pd})
    torch.cuda.synchronize()
    h2d, d2h = ex.h2d_transfers, ex.d2h_transfers
    free_gb = shutil.disk_usage(ckdir).free / 1e9
    reset_launches()
    t0 = time.perf_counter()
    rt.run_pipeline(prog, recovery=pol)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = read_launches()
    st = rt.planner.stats
    log = rt.recovery_log
    kinds = [r["kind"] for r in log]
    lives = [r["live"] for r in log]
    migration = sum(r["migration_bytes"] for r in log)
    # the program's sweeps, the replayed ones, and the one torn at its
    # commit (run, then discarded)
    executed = SWEEPS + st.steps_replayed + 1
    print(f"jacobi (e) recovery: {SWEEPS} sweeps x {NPROC} ranks at "
          f"{JACOBI_SHAPE}, faults {inj.log}: {dt:.3f} s, "
          f"{1e3 * dt / SWEEPS:.3f} ms per program sweep (host clock, "
          f"checkpoints and restores included), {executed} sweeps "
          f"executed, steps replayed {st.steps_replayed}, recoveries "
          f"{st.recoveries}, shrinks {st.elastic_shrinks}, grows "
          f"{st.elastic_grows}, recovery_log {list(zip(kinds, lives))}, "
          f"migration bytes {migration}, checkpoint {cm.stats}, h2d/d2h "
          f"{(ex.h2d_transfers - h2d, ex.d2h_transfers - d2h)}, fused_steps "
          f"{st.fused_steps}, graphs {len(ex._graphs)}, launches {got}, "
          f"disk free before {free_gb:.1f} GB")
    check(kinds == ["rank_loss", "rank_join"],
          f"(e) recovery_log kinds {kinds}")
    check(lives == [[0, 1, 3], [0, 1, 2, 3]], f"(e) live sets {lives}")
    check(st.recoveries >= 2 and st.elastic_shrinks == 1
          and st.elastic_grows == 1,
          f"(e) recoveries {st.recoveries}, shrinks {st.elastic_shrinks}, "
          f"grows {st.elastic_grows}")
    check(cm.stats["saves"] >= 1 and cm.stats["restores"] >= 2,
          f"(e) checkpoint {cm.stats}")
    # each executed sweep launches the kernel at least once per live
    # rank (three while rank 2 is out)
    check(got["jacobi_hd"] >= executed * (NPROC - 1),
          f"(e) jacobi launches {got['jacobi_hd']} < {executed} x "
          f"{NPROC - 1}")
    check(got["gemm_hd"] == got["flash_attn_hd"] == 0,
          f"(e) launched another kernel: {got}")
    same = np.array_equal(rt.read_coherent(A), want)
    print(f"jacobi (e) vs {SWEEPS} serial plain sweeps: bit-identical={same}")
    check(same, "(e) recovery changed the values")
    rt.close()
    shutil.rmtree(ckdir)
    torch.cuda.empty_cache()
    print(f"jacobi (e) phase {time.perf_counter() - t_phase:.3f} s")
    return got


def _ratio(times) -> float:
    work = [t for t in times if t > 0]
    return max(work) / min(work)


def rebalance_phase(torch, init, want):
    """(f) The Jacobi program on rows weighted (2, 1, 1, 1) under a
    Rebalancer fed by per-rank CUDA-event times."""
    from repro_torch.core import HDArrayRuntime
    from repro_torch.ft import Rebalancer

    t_phase = time.perf_counter()
    rt = HDArrayRuntime(NPROC)                 # torch on the card
    A, prog, pd = jacobi_program(rt, init, weights=REBALANCE_WEIGHTS)
    ex = rt.executor
    reb = Rebalancer(data_parts={"A": pd, "B": pd},
                     min_duration=REBALANCE_MIN_DURATION)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rt.run_pipeline(prog, rebalance=reb)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = read_launches()
    st = rt.planner.stats
    recs = [r for r in rt.recovery_log if r["kind"] == "rebalance"]
    hist = st.rank_step_times
    first, last = (recs[0]["step"], recs[-1]["step"]) if recs else (0, 0)
    before = [_ratio(t) for s, t in hist if s <= first]
    after = [_ratio(t) for s, t in hist if s > last]
    weights = recs[-1]["weights"] if recs else ()
    reparts = [b for name, b, _a in rt.comm_log
               if name.startswith("__repartition_")]
    print(f"jacobi (f) rebalance: {SWEEPS} sweeps on weights "
          f"{REBALANCE_WEIGHTS}: {dt:.3f} s, {1e3 * dt / SWEEPS:.3f} ms per "
          f"sweep (host clock), {st.rebalances} rebalance(s) at steps "
          f"{[r['step'] for r in recs]}, weights "
          f"{[tuple(round(w, 4) for w in r['weights']) for r in recs]}, "
          f"rank times (ms) at the first fire "
          f"{[round(1e3 * t, 4) for t in dict(hist).get(first, ())]}, "
          f"max/min ratio before {[round(r, 3) for r in before]} after "
          f"{[round(r, 3) for r in after]}, {len(hist)} timed steps, "
          f"scan_captures {st.scan_captures}, migration bytes "
          f"{[r['migration_bytes'] for r in recs]} (comm_log repartitions "
          f"{reparts}), launches {got}")
    check(recs and st.rebalances >= 1, "(f) the rebalancer never fired")
    even = 1.0 / NPROC
    check(max(abs(w - even) for w in weights) <= 0.1 * even,
          f"(f) weights {weights} not within 10% of even")
    check(after and float(np.median(after)) < reb.threshold,
          f"(f) max/min rank time ratio after {after} not below "
          f"{reb.threshold}")
    check(sum(reparts) == sum(r["migration_bytes"] for r in recs) > 0,
          f"(f) migration bytes {reparts} not in comm_log")
    check(got["jacobi_hd"] >= SWEEPS * NPROC,
          f"(f) jacobi launches {got['jacobi_hd']} < {SWEEPS * NPROC}")
    check(got["gemm_hd"] == got["flash_attn_hd"] == 0,
          f"(f) launched another kernel: {got}")
    same = np.array_equal(rt.read_coherent(A), want)
    print(f"jacobi (f) vs {SWEEPS} serial plain sweeps: bit-identical={same}")
    check(same, "(f) rebalancing changed the values")
    rt.close()
    torch.cuda.empty_cache()
    print(f"jacobi (f) phase {time.perf_counter() - t_phase:.3f} s")
    return got


def pool_prompts(vocab: int):
    """POOL_PROMPTS seeded token prompts; the 4th starts with the 1st's
    first POOL_SHARED tokens."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, vocab, n) for n in POOL_PROMPTS]
    prompts[3][:POOL_SHARED] = prompts[0][:POOL_SHARED]
    return prompts


def run_pool(torch, bundle, params, prompts, fail: bool):
    """Serve ``prompts`` on the ReplicaPool of phase (g); with ``fail``,
    instance 1 of replica 0 stops heartbeating once the first decode
    ticks have run.  Returns the streams, the pool and its seconds."""
    from repro_torch.serve import ReplicaPool, ServeConfig

    ckdir = ROOT / "build" / "smoke_ckpt_pool"
    shutil.rmtree(ckdir, ignore_errors=True)
    pool = ReplicaPool(bundle, params,
                       ServeConfig(slots=POOL_SLOTS, max_seq=POOL_MAX_SEQ,
                                   prefix_reuse=True),
                       replicas=2, instances=2, policy="prefix_aware",
                       checkpoint_interval=POOL_CKPT_INTERVAL,
                       ckpt_dir=str(ckdir))
    rids = [pool.submit(p, max_new=POOL_NEW_TOKENS) for p in prompts]
    t0 = time.perf_counter()
    while pool.pending:
        if fail and pool.tick == POOL_FAIL_TICK:
            pool.inject_instance_failure(0, 1, down_for=POOL_DOWN_FOR)
        pool.step()
        check(pool.tick < 200, "(g) the pool did not drain in 200 ticks")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [pool.result(r) for r in rids], pool, dt, ckdir


def close_pool(pool, ckdir) -> None:
    for rep in pool.replicas.values():
        rep.rt.close()
    shutil.rmtree(ckdir)


def pool_logits_finite(torch, rep) -> bool:
    """One decode step of a replica's model on a copy of its restored
    cache (every slot, at its slot position): finite logits."""
    eng = rep.engine
    cache = {"main": {k: v.clone() for k, v in eng.cache["main"].items()}}
    batch = {"token": torch.zeros((POOL_SLOTS, 1), dtype=torch.long,
                                  device=eng.device),
             "pos": torch.tensor(eng.slot_pos, device=eng.device)}
    logits, _ = eng.bundle.decode(eng.params, batch, cache)
    return bool(torch.isfinite(logits).all())


def pool_phase(torch, bundle, params):
    """(g) yi-9b behind a 2-replica x 2-instance ReplicaPool: the
    prompts served without a fault, then again with instance 1 of
    replica 0 failing over (planned shrink, checkpoint restore, decode
    replay) and rejoining, driven by heartbeats alone."""
    from repro_torch.models.layers import FLASH_MIN_T

    t_phase = time.perf_counter()
    cfg = bundle.cfg
    prompts = pool_prompts(cfg.vocab)
    flash = _wrappers()["flash_attn_hd"]
    reset_launches()
    want, pool, dt0, ckdir = run_pool(torch, bundle, params, prompts, False)
    ref_stats = pool.replica_stats()
    close_pool(pool, ckdir)
    torch.cuda.empty_cache()
    launches_ref = read_launches()
    flash_ref = read_variants()["flash_attn_hd"]
    reset_launches()
    got, pool, dt1, ckdir = run_pool(torch, bundle, params, prompts, True)
    launches = read_launches()
    variants = read_variants()
    rep0 = pool.replicas[0]
    log = rep0.recovery_log
    kinds = [r["kind"] for r in log]
    m = pool.export_metrics()
    recs = m["requests"]
    flash_prefills = sum(1 for r in recs
                         if r["prompt_len"] - r["prefix_hit_len"]
                         >= FLASH_MIN_T)
    ck = [rep.cm.stats for rep in pool.replicas.values()]
    mem = torch.cuda.max_memory_allocated() / 1e9
    print(f"serving (g) pool: {len(prompts)} requests of "
          f"{list(POOL_PROMPTS)} tokens (4th shares {POOL_SHARED} with the "
          f"1st), {POOL_NEW_TOKENS} new each, 2 replicas x 2 instances, "
          f"{POOL_SLOTS} slots x {POOL_MAX_SEQ}: without the fault "
          f"{dt0:.3f} s, with it {dt1:.3f} s ({pool.tick} ticks); TTFT s "
          f"{m['ttft_s']}, per-token s {m['token_latency_s']}, throughput "
          f"{m['throughput_tok_s']} tok/s; prefix hits "
          f"{[r['prefix_hit_len'] for r in recs]}; events "
          f"{[(e['kind'], e.get('tick')) for e in m['events']]}; replica 0 "
          f"recovery_log {[(r['kind'], r['live'], r['migration_bytes'], r.get('steps_replayed')) for r in log]}; "
          f"checkpoints per replica {ck}; flash launches {launches['flash_attn_hd']} "
          f"({variants['flash_attn_hd']}) in {flash_prefills} prefills of "
          f">= {FLASH_MIN_T} tokens, {launches_ref['flash_attn_hd']} without "
          f"the fault; peak allocated {mem:.2f} GB")
    print(f"serving (g) replica stats without the fault {ref_stats}, with "
          f"it {pool.replica_stats()}")
    check(got == want, "(g) failover changed a token stream")
    check(kinds == ["instance_loss", "instance_join"],
          f"(g) replica 0 recovery_log kinds {kinds}")
    check(log[0]["steps_replayed"] >= 0 and rep0.live == [0, 1],
          f"(g) replica 0 live {rep0.live}")
    check(flash_prefills >= 1 and launches["flash_attn_hd"]
          == cfg.n_layers * flash_prefills
          == launches_ref["flash_attn_hd"],
          f"(g) flash launches {launches['flash_attn_hd']} and "
          f"{launches_ref['flash_attn_hd']} != {cfg.n_layers} x "
          f"{flash_prefills}")
    check(variants["flash_attn_hd"]["wgmma"] == launches["flash_attn_hd"],
          f"(g) flash variants {variants['flash_attn_hd']}")
    check(launches["jacobi_hd"] == launches["gemm_hd"] == 0,
          f"(g) launched another kernel: {launches}")
    check(all(0 <= t < cfg.vocab for st in got for t in st),
          "(g) a generated token is outside the vocabulary")
    finite = pool_logits_finite(torch, rep0)
    print(f"serving (g) logits of a decode step on replica 0's restored "
          f"cache finite: {finite}")
    check(finite, "(g) non-finite logits after failover")
    close_pool(pool, ckdir)
    torch.cuda.empty_cache()
    print(f"serving (g) phase {time.perf_counter() - t_phase:.3f} s")
    return ({k: launches[k] + launches_ref[k] for k in launches},
            {k: n + flash_ref[k]
             for k, n in variants["flash_attn_hd"].items()})


def logits_finite(torch, eng) -> bool:
    """Whether the engine's model gives finite logits for one prefill of
    the whole pool (every slot a prompt of PROMPTS[1] tokens) and one
    decode step after it, through the bundle's public steps on a cache
    of the engine's size: outside the timed run, so the engine that is
    timed is the one a user calls."""
    bundle = eng.bundle
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, eng.cfg.vocab,
                                         (SERVE_SLOTS, PROMPTS[1])))
    cache = bundle.init_cache(SERVE_SLOTS, SERVE_MAX_SEQ)
    pre, cache = bundle.prefill(eng.params, {"tokens": toks.to(eng.device)},
                                cache)
    batch = {"token": pre.argmax(dim=-1),
             "pos": torch.full((SERVE_SLOTS,), PROMPTS[1], dtype=torch.int32,
                               device=eng.device)}
    dec, cache = bundle.decode(eng.params, batch, cache)
    ok = bool(torch.isfinite(pre).all()) and bool(torch.isfinite(dec).all())
    print(f"logits of one pool prefill {tuple(pre.shape)} and one decode "
          f"step {tuple(dec.shape)} all finite: {ok}")
    del cache
    torch.cuda.empty_cache()
    return ok


def serve_prompts(vocab: int):
    """The serving phases' prompts of PROMPTS tokens, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in PROMPTS]


def serve_path(torch, arch: str, variant: str, label: str,
               readmit_repeats: bool = True):
    """``arch`` at full width and depth behind the slot Engine: admits,
    decode steps, finishes, and the first prompt again, every prefill
    launching the flash kernel's ``variant`` once per layer.  With
    ``readmit_repeats`` the re-admitted prompt must repeat its greedy
    continuation.  Returns (launches, launches by variant, bundle,
    params); the engine and its cache are freed."""
    from repro_torch.kernels.flash_attention.kernel import VARIANTS
    from repro_torch.launch.serve import load_engine
    from repro_torch.models.lm import _window_array

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = load_engine(arch, reduced=False, slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ, seed=0)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = cfg.param_count()
    kv_bytes = 2 * cfg.n_layers * SERVE_SLOTS * SERVE_MAX_SEQ \
        * cfg.n_kv_heads * cfg.head_dim * 2
    ffn = (f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
           f"{cfg.moe.d_expert_ff} (capacity factor "
           f"{cfg.moe.capacity_factor})" if cfg.moe else f"d_ff {cfg.d_ff}")
    print(f"{label}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads d_head {cfg.head_dim} {ffn} "
          f"vocab {cfg.vocab}, windows {sorted(set(_window_array(cfg)))}, "
          f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, bfloat16: "
          f"param_count() {n_params} -> {2 * n_params / 1e9:.2f} GB of "
          f"weights, KV cache {kv_bytes / 1e9:.2f} GB ({SERVE_SLOTS} slots x "
          f"{SERVE_MAX_SEQ}); allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; set-up (random "
          f"weights from a seeded generator) "
          f"{time.perf_counter() - t0:.2f} s")

    flash = _wrappers()["flash_attn_hd"]
    prompts = serve_prompts(cfg.vocab)
    prefill_ms, per_prefill, decode_ms, decode_tokens = [], [], [], 0

    def admit(prompt):
        n0, w0 = flash.launches, flash.by_variant[variant]
        torch.cuda.synchronize()
        t = time.perf_counter()
        sid = eng.add_request(prompt)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t))
        per_prefill.append(flash.launches - n0)
        check(flash.by_variant[variant] - w0 == flash.launches - n0,
              f"a {label} prefill launched another flash variant than "
              f"{variant}")
        return sid

    def decode(n):
        nonlocal decode_tokens
        n0 = flash.launches
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = eng.step()
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t))
            decode_tokens += len(out)
        check(flash.launches == n0, f"a {label} decode step launched flash "
              f"attention")

    reset_launches()
    t_run = time.perf_counter()
    sids = []
    for prompt in prompts:
        sids.append(admit(prompt))
        decode(DECODE_STEPS)
    streams = [eng.finish(sid) for sid in sids]
    sid = admit(prompts[0])
    decode(len(PROMPTS) * DECODE_STEPS)
    again = eng.finish(sid)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = read_launches()
    variants = read_variants()
    n_gen = len(streams[0]) - PROMPTS[0]
    print(f"{label}: prefill ms per admit {[round(x, 3) for x in prefill_ms]} "
          f"(prompts {list(PROMPTS)} then {PROMPTS[0]} again; host clock, "
          f"synchronized); decode ms per step: median "
          f"{float(np.median(decode_ms)):.3f}, min {min(decode_ms):.3f}, "
          f"max {max(decode_ms):.3f} over {len(decode_ms)} steps; "
          f"{decode_tokens} decode tokens in {sum(decode_ms) / 1e3:.3f} s = "
          f"{decode_tokens / (sum(decode_ms) / 1e3):.1f} tokens/s; whole run "
          f"{t_run:.3f} s; flash launches per prefill {per_prefill}; "
          f"launches {launches}, flash by variant {variants['flash_attn_hd']}")
    check(per_prefill == [cfg.n_layers] * (len(PROMPTS) + 1),
          f"{label}: flash launches per prefill {per_prefill} != "
          f"{cfg.n_layers}")
    check(launches["jacobi_hd"] == 0 and launches["gemm_hd"] == 0
          and launches["flash_attn_bwd_hd"] == 0,
          f"{label}: launched another path's kernel")
    check(variants["flash_attn_hd"] == {
        v: launches["flash_attn_hd"] if v == variant else 0
        for v in VARIANTS},
        f"{label}: flash launches by variant {variants['flash_attn_hd']}: "
        f"every one must be the {variant} kernel")
    check(logits_finite(torch, eng), f"non-finite logits on the {label}")
    same = again == streams[0]
    print(f"{label}: re-admitted prompt repeats its greedy continuation of "
          f"{n_gen} tokens: {same}")
    check(same or not readmit_repeats,
          f"{label}: the same prompt gave another greedy continuation")
    check(all(0 <= t < cfg.vocab for st in streams + [again] for t in st),
          f"{label}: a generated token is outside the vocabulary")

    eng.add_request(prompts[2])
    device_breakdown(torch, f"{label}: one prefill ({PROMPTS[1]} tokens, "
                     f"the whole {SERVE_SLOTS}-slot pool)",
                     lambda: eng.add_request(prompts[1]))
    device_breakdown(torch, f"{label}: one decode step ({SERVE_SLOTS} slots, "
                     f"2 live)", eng.step, host_top=8)
    print(f"{label}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, weights "
          f"{2 * n_params / 1e9:.3f} GB by param_count()")
    bundle, params = eng.bundle, eng.params
    del eng
    torch.cuda.empty_cache()
    return launches, variants, bundle, params


def lone_prompt_repeats(torch, bundle, params, prompt, steps: int) -> None:
    """One prompt admitted alone into a fresh Engine on ``params`` and
    decoded ``steps`` steps, twice: every bit of both KV caches (each
    layer's keys and values of every position, so every layer's input
    at every step) must be equal, and the streams too, a secondary
    check (random weights tend to decode one token over and over, so
    equal streams alone show little).  Each run starts from
    the same pool state (every slot empty), because under MoE capacity
    the empty slots' rows compete for experts too."""
    from repro_torch.serve import Engine, ServeConfig

    streams, caches = [], []
    for _ in range(2):
        eng = Engine(bundle, params, ServeConfig(max_seq=SERVE_MAX_SEQ,
                                                 slots=SERVE_SLOTS), seed=0)
        sid = eng.add_request(prompt)
        for _ in range(steps):
            eng.step()
        streams.append(eng.finish(sid))
        caches.append(eng.cache["main"])
        del eng
    same = streams[0] == streams[1]
    bits = all(torch.equal(caches[0][n], caches[1][n]) for n in ("k", "v"))
    print(f"{bundle.cfg.name}: one prompt of {len(prompt)} tokens admitted "
          f"alone into a fresh engine and decoded {steps} steps, twice: KV "
          f"caches bit-identical {bits}; streams equal (secondary) {same} "
          f"({streams[0][len(prompt):]})")
    check(same and bits, f"{bundle.cfg.name}: the lone prompt's run "
          f"changed between two runs from the same pool state")
    del caches
    torch.cuda.empty_cache()


def moe_layer_check(torch, bundle, params, prompt) -> None:
    """Layer 0's MoE feed-forward at full width on the hidden state of
    the first admit's prefill (the whole pool: the prompt in slot 0,
    empty slots of token 0 beside it), in bf16, against a float32
    evaluation of the same routing (the same ids and weights, the same
    capacity drops, every expert in float32, one expert at a time)."""
    import repro_torch.models.layers as LY
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import rms_norm

    cfg, mo = bundle.cfg, bundle.cfg.moe
    pl = params["main"][0]
    toks = np.zeros((SERVE_SLOTS, len(prompt)), np.int64)
    toks[0] = prompt
    with torch.no_grad():
        x = lm._embed(params["emb"], torch.from_numpy(toks).cuda(), cfg,
                      torch.bfloat16)
        a, _ = LY.attention(pl["attn"], rms_norm(x, pl["norms"]["pre_attn"]),
                            cfg=cfg, window=lm.BIG_WINDOW)
        h = rms_norm(x + a, pl["norms"]["pre_mlp"])
        got, _ = MOE.moe_ffn(pl["ffn"], h, mo, aux=False)
        ms = cuda_ms(torch, lambda: MOE.moe_ffn(pl["ffn"], h, mo,
                                                aux=False), 5)
        B, T, D = h.shape
        hf = h.reshape(-1, D)
        w, ids, _ = MOE._route(pl["ffn"]["router"], hf, mo.top_k)
        N, k = hf.shape[0], mo.top_k
        C = max(1, int(mo.capacity_factor * N * k / mo.num_experts))
        flat, wf = ids.reshape(-1), w.reshape(-1)
        want = torch.zeros((N, D), dtype=torch.float32, device=h.device)
        kept = 0
        for e in range(mo.num_experts):
            pairs = (flat == e).nonzero()[:, 0][:C]      # token-major, first C
            kept += pairs.numel()
            t = pairs // k
            xe = hf[t].float()
            g = xe @ pl["ffn"]["w_gate"][e].float()
            u = xe @ pl["ffn"]["w_up"][e].float()
            y = (torch.nn.functional.silu(g) * u) @ pl["ffn"]["w_down"][e].float()
            want.index_add_(0, t, wf[pairs, None] * y)
        err = float((got.float().reshape(N, D) - want).norm() / want.norm())
    print(f"{cfg.name}: layer 0's MoE on the first admit's hidden state "
          f"({B} x {T} tokens, C = {C}, {kept} of {N * k} pairs kept): bf16 "
          f"against float32 on the same routing, relative Frobenius error "
          f"{err:.3e} (gate {MOE_LAYER_TOL:g}); {ms:.3f} ms a call")
    check(err <= MOE_LAYER_TOL, f"{cfg.name}: the bf16 MoE layer is "
          f"{err:.3e} from the float32 evaluation of its routing")


def train_phase(torch):
    """(h) yi-9b at full width and 8 layers, trained on the card: the
    gradient gate, then TRAIN_STEPS steps through make_train_step.
    Returns its launches and launches by variant."""
    import dataclasses
    import functools

    import repro_torch.models.layers as LY
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        make_train_step, value_and_grad)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    L = cfg.n_layers
    t0 = time.perf_counter()
    bundle = build(cfg, torch.bfloat16, "cuda")
    params = bundle.init(0, dtype=torch.float32)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"(h) {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {L} of 48 layers: {n_params / 1e9:.3f} B float32 "
          f"parameters ({4 * n_params / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f} s")
    pipe = TokenPipeline(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0))

    def batch_at(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in pipe.batch_at(i).items()}

    # -- the gate: one microbatch, kernels against the plain attention --
    grad_fn = value_and_grad(make_loss_fn(bundle, TrainConfig()))
    mb = {k: v[0::TRAIN_MICRO] for k, v in batch_at(0).items()}
    reset_launches()
    loss_k, _, g_k = grad_fn(params, mb)
    torch.cuda.synchronize()
    got = read_launches()
    check(got["flash_attn_hd"] == 2 * L and got["flash_attn_bwd_hd"] == L,
          f"(h) one microbatch launched {got}")
    real = LY.flash_attention
    LY.flash_attention = functools.partial(ops.flash_attention,
                                           impl="blockwise")
    try:
        loss_p, _, g_p = grad_fn(params, mb)
    finally:
        LY.flash_attention = real
    torch.cuda.synchronize()
    check(read_launches() == got, "(h) the plain attention launched a "
          "flash kernel")
    worst, worst_leaf = 0.0, None
    names = [f"emb/{n}" for n in params["emb"]] + [
        f"layer {i}/{n}" for i, layer in enumerate(params["main"])
        for d in layer.values() for n in d]
    leaves_k = (list(g_k["emb"].values())
                + [t for layer in g_k["main"] for d in layer.values()
                   for t in d.values()])
    leaves_p = (list(g_p["emb"].values())
                + [t for layer in g_p["main"] for d in layer.values()
                   for t in d.values()])
    for name, a, b in zip(names, leaves_k, leaves_p):
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
              f"(h) gradient of {name} is not finite or is zero")
        e = fro_rel(torch, a, b)
        if e > worst:
            worst, worst_leaf = e, name
    print(f"(h) one microbatch (1 x {TRAIN_SEQ}): loss kernels "
          f"{float(loss_k):.6f}, plain {float(loss_p):.6f}; {len(names)} "
          f"leaves finite and non-zero; worst fro_rel of a leaf's gradient "
          f"{worst:.3e} ({worst_leaf}), bound {TRAIN_GRAD_TOL:g}")
    check(worst <= TRAIN_GRAD_TOL, f"(h) kernel gradients differ from the "
          f"plain attention's: {worst} at {worst_leaf}")
    del g_k, g_p, leaves_k, leaves_p
    torch.cuda.empty_cache()

    # -- TRAIN_STEPS steps ------------------------------------------------
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=1000,
                             moment_dtype="fp32")     # as launch.train.setup
    step_fn = make_train_step(bundle, ocfg,
                              TrainConfig(microbatches=TRAIN_MICRO))
    state = adamw.init_opt_state(ocfg, params)
    batches = [batch_at(i) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[i])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    launches, variants = read_launches(), read_variants()
    peak = torch.cuda.max_memory_allocated()
    steady = sum(ms[1:]) / len(ms[1:])
    print(f"(h) {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{TRAIN_MICRO} microbatches: losses "
          f"{[round(x, 4) for x in losses]}; ms per step "
          f"{[round(x, 3) for x in ms]} (host clock after synchronize), "
          f"steps 2-{TRAIN_STEPS} mean {steady:.3f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / steady * 1e3:.1f} tokens/s; "
          f"max_memory_allocated {peak / 1e9:.3f} GB; launches {launches}, "
          f"flash by variant {variants['flash_attn_hd']}, backward "
          f"{variants['flash_attn_bwd_hd']}")
    check(all(np.isfinite(losses)), f"(h) a loss is not finite: {losses}")
    want_fwd = 2 * L * TRAIN_MICRO * TRAIN_STEPS
    want_bwd = L * TRAIN_MICRO * TRAIN_STEPS
    check(launches["flash_attn_hd"] == want_fwd
          and variants["flash_attn_hd"]["wgmma"] == want_fwd,
          f"(h) flash forward launched {launches['flash_attn_hd']}, want "
          f"{want_fwd} wgmma (forward and checkpoint recompute)")
    check(launches["flash_attn_bwd_hd"] == want_bwd
          and variants["flash_attn_bwd_hd"]["wgmma"] == want_bwd,
          f"(h) flash backward launched {launches['flash_attn_bwd_hd']}, "
          f"want {want_bwd} wgmma")
    check(launches["jacobi_hd"] == launches["gemm_hd"] == 0,
          "(h) training launched a Jacobi or GEMM kernel")
    check(int(state.step) == TRAIN_STEPS, "(h) the optimizer step count")
    device_breakdown(torch, f"(h) train step {TRAIN_STEPS + 1}",
                     lambda: step_fn(params, state, batches[TRAIN_STEPS]),
                     top=8)
    stats = dict(ms=ms, losses=losses, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
                 / steady * 1e3, peak_gb=peak / 1e9)
    del bundle, params, state, batches, step_fn
    torch.cuda.empty_cache()
    return launches, variants, stats


def train_fault_phase(torch):
    """The training driver on the card with a fault, as the reference's
    test_system.py:22-34: a recovery, finite losses, loss decreasing."""
    from repro_torch.launch.train import setup, train

    ckdir = ROOT / "build" / "smoke_ckpt_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    run = setup(FAULT_ARCH, reduced=True, seq_len=32, global_batch=4,
                lr=5e-3, ckpt_dir=str(ckdir), total_steps=FAULT_STEPS)
    out = train(run, FAULT_STEPS, ckpt_every=FAULT_EVERY,
                inject_faults=[FAULT_AT], verbose=False)
    secs = time.perf_counter() - t0
    launches = read_launches()
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    print(f"(h) fault path: setup({FAULT_ARCH!r}, reduced) on "
          f"{run.bundle.device}, {FAULT_STEPS} steps, checkpoints every "
          f"{FAULT_EVERY}, fault at {FAULT_AT}: recoveries "
          f"{out['recoveries']}, {len(out['losses'])} losses, mean of the "
          f"first 5 {first:.4f}, last 5 {last:.4f}, {secs:.2f} s, "
          f"checkpoints {run.ckpt.stats['saves']} saves and "
          f"{run.ckpt.stats['restores']} restores, launches {launches}")
    check(out["recoveries"] == [FAULT_AT], "(h) the fault did not recover")
    check(bool(np.isfinite(out["losses"]).all()), "(h) a loss is not finite")
    check(last < first, f"(h) the loss did not decrease: {first} -> {last}")
    shutil.rmtree(ckdir, ignore_errors=True)
    return launches


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    # flex_attention's timing compiles with inductor and triton: their
    # caches stay in the checkout's build directory
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
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
    # a library built earlier brings the log of its build along
    for name in build.SOURCES:
        for kernel, report in ptxas_report(logs[name], build._nvcc()):
            print(f"  {name}: {kernel}: {report}")
        faults = build.ptxas_faults(logs[name])
        check(not faults, f"ptxas spills or serialises wgmmas in {name}: "
              + "; ".join(faults))

    jac, gemm = kernel_phase(torch)
    init, want = jacobi_data(torch)
    jac_launches, jac_ms = jacobi_path(torch, init, want)
    gemm_launches, gemm_variants, gemm_step1_ms, gemm_step2_ms = \
        gemm_path(torch)
    check(gemm_launches["jacobi_hd"] == 0 and gemm_launches["flash_attn_hd"]
          == 0, "the GEMM path launched another kernel")
    print(f"main path: jacobi ms/sweep by schedule "
          f"{ {k: round(v, 4) for k, v in jac_ms.items()} }, gemm step 1 "
          f"{gemm_step1_ms:.3f} ms, step 2 {gemm_step2_ms:.3f} ms "
          f"(host clock, {NPROC} ranks on one card)")
    torch.cuda.empty_cache()
    print(f"before the serving phase: {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB allocated")
    flash, flash_mma = flash_phase(torch)
    flash_bwd = flash_bwd_phase(torch)
    serve_launches, serve_variants, bundle, params = serve_path(
        torch, SERVE_ARCH, "wgmma", "serving path")
    # the resilience phases come last, so that every earlier phase runs
    # as it did before they were added: (g) on the Engine's weights,
    # then (e) and (f) on the Jacobi data once the weights are freed
    pool_launches, pool_variants = pool_phase(torch, bundle, params)
    del bundle, params
    torch.cuda.empty_cache()
    jac_launches["(e)"] = recovery_phase(torch, init, want)
    jac_launches["(f)"] = rebalance_phase(torch, init, want)
    del init, want
    torch.cuda.empty_cache()
    # training last, so that every earlier phase runs as it did before
    train_launches, train_variants, _ = train_phase(torch)
    fault_launches = train_fault_phase(torch)
    # the other families' serving last, so that every earlier phase runs
    # as it did before; each alone on the card (qwen3's weights are 61 GB)
    torch.cuda.empty_cache()
    g2_launches, g2_variants, bundle, params = serve_path(
        torch, GEMMA2_ARCH, "mma_sync", "gemma2 serving")
    del bundle, params
    torch.cuda.empty_cache()
    q3_launches, q3_variants, bundle, params = serve_path(
        torch, QWEN3_ARCH, "wgmma", "qwen3 serving", readmit_repeats=False)
    prompt = serve_prompts(bundle.cfg.vocab)[0]
    lone_prompt_repeats(torch, bundle, params, prompt, DECODE_STEPS)
    moe_layer_check(torch, bundle, params, prompt)
    del bundle, params
    torch.cuda.empty_cache()
    # the Jacobi path is its six schedules; the count is their sum
    jac["launches"] = sum(n["jacobi_hd"] for n in jac_launches.values())
    jac["launches_by_schedule"] = {k: n["jacobi_hd"]
                                   for k, n in jac_launches.items()}
    jac["launches_by_variant"] = {"f32": jac["launches"]}
    gemm["launches"] = gemm_launches["gemm_hd"]
    gemm["launches_by_variant"] = gemm_variants["gemm_hd"]
    flash["launches_by_path"] = {"engine": serve_launches["flash_attn_hd"],
                                 "(g) pool": pool_launches["flash_attn_hd"],
                                 "(h) train": train_launches["flash_attn_hd"],
                                 "(h) fault path":
                                     fault_launches["flash_attn_hd"],
                                 "gemma2 engine": g2_launches["flash_attn_hd"],
                                 "qwen3 engine": q3_launches["flash_attn_hd"]}
    flash["launches"] = sum(flash["launches_by_path"].values())
    flash["launches_by_variant"] = {
        k: n + pool_variants[k] + train_variants["flash_attn_hd"][k]
        + g2_variants["flash_attn_hd"][k] + q3_variants["flash_attn_hd"][k]
        for k, n in serve_variants["flash_attn_hd"].items()}
    flash_mma["launches"] = g2_variants["flash_attn_hd"]["mma_sync"]
    flash["mma_sync_gemma2"] = flash_mma
    flash_bwd["launches_by_path"] = {
        "(h) train": train_launches["flash_attn_bwd_hd"],
        "(h) fault path": fault_launches["flash_attn_bwd_hd"]}
    flash_bwd["launches"] = sum(flash_bwd["launches_by_path"].values())
    flash_bwd["launches_by_variant"] = train_variants["flash_attn_bwd_hd"]
    print(json.dumps({"kernels": [jac, gemm, flash, flash_bwd]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
