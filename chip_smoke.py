#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and holds each against its
   plain PyTorch version on the card, at the main path's shapes and at
   ragged ones, timing kernel, plain version and library call (for the
   Jacobi sweep a conv2d of the 4-neighbour stencil, TF32 off, which
   computes the interior only).
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
   head dims, Dh 192 / Dv 128 on the wgmma variant and Dh 96 / Dv 64
   on mma_sync, and float32), timing it beside SDPA (at yi-9b's
   prefill shape and at llama-3.2-vision's, 32/8 heads), the wgmma
   variant at deepseek-v3's MLA prefill (q (4, 2048, 128, 128) and
   q_rope (4, 2048, 128, 64), k (4, 4096, 128, 128) built from a latent
   as the naive form builds it, the shared RoPE key k_rope (4, 4096, 1,
   64) a strided view of the cache, v (4, 4096, 128, 128), scale
   1/sqrt(192)) against the blockwise version within 1e-2 and bit for
   bit against its launch on the concatenated operands, the RoPE
   operands at small shapes against float64, timed beside the
   concatenated launch, its 0.695 ms operations bound and one PyTorch
   call (SDPA's memory-efficient backend, else flex_attention; the
   output names it), and its backward
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
   that of the first 5.  Then the two Dh-256 families' backward
   kernels and training: the flash backward at Dh 256 at gemma2's
   training shape (q (1, 4096, 16, 256), k, v (1, 4096, 8, 256),
   softcap 50, causal and with a window of 1000 that binds) and at
   recurrentgemma's (10 over 1 head, window 2048) against the plain
   blockwise backward, two launches bit-identical, timed beside its
   bound and compiled flex_attention's backward, with the ptxas lines
   of its Dh-256 kernels; the RG-LRU scan's backward at (1, 4096, 2560)
   and (4, 2048, 2560) bf16, from a state and without, against float64
   autograd and its plain reverse loop, two launches bit-identical,
   timed beside its byte bound; then gemma2-9b at full width with 8 of
   its 42 layers (4 local, 4 global) and recurrentgemma-2b at full
   width and depth, each alone, with the yi-9b traffic for 4 steps
   after the gradient gate against the plain versions (blockwise
   attention, the plain scan): per microbatch flash 2 and its backward
   1 per attention layer, the scan's `chunked` 2 and its backward 1 per
   recurrent layer.  Then the flash backward at Dh 192 / Dv 128 at
   deepseek-v3's training microbatch (q, k (1, 4096, 128, 192), the
   RoPE columns joined as MLA's naive form joins them under grad, v
   (1, 4096, 128, 128), causal) against the plain backward and float64
   (heads 0-7), two launches bit-identical, timed beside its bound and
   SDPA's backward, each pass's TFLOP/s and the dK/dV pass's two probes
   (elementwise math left out, copies left out); the sLSTM recurrence's
   backward at (1, 4096, 768) and (4, 2048, 768) against float64 and its
   plain reverse loop, timed in us a step beside its two probes (the
   exchange alone, the product and gate math alone).  deepseek-v3 and
   xlstm-125m train last of all (7.).
   Every kernel launch counter, the total and each variant's, is set to
   0 just before each path (each Jacobi schedule, each phase) and read
   just after; counts are executions, a launch captured into a graph
   counting at each replay.  Every GEMM-path launch must be the
   ``pipelined`` variant, every yi-9b, qwen3 and gemma2 prefill launch
   the ``wgmma`` one (gemma2's at Dh 256), and every training backward
   the ``wgmma`` one (gemma2's and recurrentgemma's at Dh 256).
6. Serves the other two ported families last, each at full width and
   full depth in bfloat16 alone on the card, through load_engine and
   the Engine with the yi-9b traffic above (admits of 2048, 1536, 1024
   tokens into 4 slots x 4096, 16 decode steps each, the first prompt
   again): gemma2-9b (alternating windows of 4096 and global, softcaps
   50 and 30; Dh 256, so every prefill launches flash's wgmma variant
   at Dh 256, 42 per prefill and no mma_sync; the re-admitted prompt
   must repeat) and
   qwen3-moe-30b-a3b (128 experts top-8 under the reference's capacity
   factor 1.25; 48 wgmma launches per prefill).  Under that capacity
   one slot's tokens can drop another's, so in place of the re-admit
   gate one prompt, admitted alone into a fresh Engine and decoded 16
   steps, twice, must leave bit-identical KV caches (every layer's
   input at every step; the streams, random weights' one token over
   and over, are compared too but show little);
   and layer 0's MoE at full width on the first admit's hidden state
   must lie within 2e-2 (relative Frobenius) of a float32 evaluation
   of the same routing, and through the expert-parallel dispatch
   (``moe_ffn(..., impl="ep")``) on a (1, 1) ("data", "model")
   DeviceMesh over a one-rank NCCL group it must equal the sort
   dispatch bit for bit (both ms per call printed; no card or no NCCL
   fails the run).  Each prints its parameters against the bytes
   allocated, max_memory_allocated, prefill ms per admit, median
   decode ms, tokens/s and a device breakdown of one prefill and one
   decode step.  The flash phase (3.) also holds wgmma at gemma2's
   heads of 256 against float64 (a window under T and softcap 50) and at
   gemma2's prefill shape against the plain blockwise version (its
   window of 4096, and one of 1000 that binds there), timed beside
   compiled flex_attention with the softcap as a score_mod and the
   window as a block mask (the library's one call for the function)
   and SDPA without the softcap (not the same function), and prints
   the ptxas registers and spills of its Dh-256 kernels.
   Last, recurrentgemma-2b: first its RG-LRU scan kernel, both
   variants, against float64 and its plain float32 loop within 2e-4 of
   max|h| (bf16, a prefill of the pool, 4 x 2048 x 2560, from a state
   and without, on chunked and sequential; a decode step from a state
   on sequential), the chunked kernel's branch-free reciprocal and
   square root against IEEE on every float32 it can meet, both
   variants timed beside the loop and the byte bound, the decode call
   by CUDA events and torch.profiler; then the family at full width
   and depth (26 layers, 18 RG-LRU and 8 local-attention on the
   sliding-window ring of 2048, MQA 10/1 at Dh 256), in bf16, with the
   traffic above: every prefill launches flash's wgmma 8 times and the
   scan's chunked variant 18 times, every decode step the scan's
   sequential variant 18 times and no flash.  The first prompt's
   decode crosses position 2048, so the ring wraps.  Its Engine, like
   the reference's, resets only ``pos`` when it reuses a slot, so a
   re-admitted prompt starts from the last occupant's state: the
   lone-prompt gate from fresh engines, over every cache leaf, takes
   the re-admit gate's place.  Weights and cache are printed from the
   bytes of their tensors.  Last, xlstm-125m: first its sLSTM kernel,
   ``cluster`` on a prefill of the pool (4 x 2048 x 768, bf16, from a
   state and without) and ``step`` on a decode step written over its
   state, against float64 and its plain loop within 1e-3 of max|h|,
   timed beside the loop, the operations bound and the exchange probe
   (the ``cluster`` step loop without the product and the gates); then
   the model at full width and depth: every prefill launches
   ``cluster`` twice, every decode step ``step`` twice, and no other
   kernel; the lone-prompt gate as for recurrentgemma.  Last, the two
   families with a second input, each alone at full width and depth in
   bf16, every admit with the same pool-shaped float32 extra inputs
   from ``numpy.random.default_rng(0)``: llama-3.2-vision-11b (40
   layers, 32/8 heads of 128, 8 dense cross-attentions over 1601 image
   tokens of width 4096, ``image_embeds`` (4, 1601, 4096)) with the
   yi-9b traffic: every prefill launches flash's wgmma 40 times, no
   decode step launches it, no other kernel runs, and the re-admitted
   prompt must repeat; the flash phase (3.) holds wgmma at its prefill
   shape (q (4, 2048, 32, 128), k and v (4, 4096, 8, 128) strided
   views) against the plain blockwise version, timed beside SDPA.
   Then whisper-base (6 encoder and 6 decoder layers, d_model 512,
   ``frames`` (4, 1500, 512)) with Whisper's own traffic: 4 slots x
   448 positions (its decoder context), prompts of 224, 96 and 4
   tokens, 16 decode steps each, the first prompt again: no kernel
   launches at all (its prompts stay under FLASH_MIN_T, its encoder
   and cross-attentions are dense, as in the reference), and the
   re-admitted prompt must repeat.  Then deepseek-v3-671b at full
   width (d_model 7168, 128 heads, MLA with q_lora 1536, kv_lora 512,
   d_nope 128, d_rope 64, d_v 128, 256 experts top-8 of 2048 plus 1
   shared under capacity factor 1.25, vocab 129280, dense d_ff 18432),
   its depth cut from 61 to 5 layers (the published 3 dense layers, 2
   moe layers) plus the MTP head's parameters, about 54.6 GB, with the
   yi-9b traffic: every prefill is MLA's naive form and launches flash
   ``wgmma`` 5 times, decode (the absorbed form) launches no kernel, no
   path launches ``mma_sync``;
   the lone-prompt gate and the first moe layer's checks (shared expert
   included, the ep dispatch bit for bit the sort) as for qwen3; then
   one MLA layer at B 1 and T 1024 from a cache holding 1024 rows, its
   naive form (the kernel) against its
   absorbed form (dense einsums) within 2e-2 Frobenius-relative.  Last,
   ``make_flash_kernel`` on the torch backend: one fp16 sequence of
   4096 tokens as HDArrays, its query rows over 4 ranks, at 32/8 heads
   of 128 and 128/128 heads of 192/128 (both ``wgmma``), each
   within 1e-2 of the blockwise version over the whole sequence, 4
   launches of its variant each.
7. Trains, last, deepseek-v3 at full width, depth cut to its 2 leading
   dense layers and the MTP head (3.71 B parameters), then xlstm-125m
   at full width and depth, each alone for 4 steps after its gate (in
   float32 compute for xlstm): per microbatch flash 2 a layer and 1 for
   the MTP block and its backward 1 each; the sLSTM's `cluster` 2 and
   its backward 1 per sLSTM layer.  The allocator maps expandable
   segments from there on.  Then the last three families, each alone,
   4 steps after its gate, through launch.train.setup with a depth cut
   and the family's extra inputs (launch.train._extra_inputs, bf16):
   llama-3.2-vision-11b with 10 of its 40 layers (two super-blocks,
   two cross-attentions over (1601, 4096) image embeddings a sample)
   and qwen3-moe-30b-a3b with 4 of its 48 under the published capacity
   factor 1.25, both with the yi-9b traffic (per microbatch flash 2 and
   its backward 1 a self-attention layer, all wgmma; the dense
   cross-attentions none), qwen3's gate on the kernels' routing (its
   drops and the pairs the plain pass routes otherwise printed, a layer
   each), its free routing within twice the plain path's own spread;
   whisper-base whole with its own traffic (448-token decoder
   sequences, 1500 frames, a global batch of 32 in 2 microbatches): no
   kernel launches, and its gate holds one sample's float32 loss and
   gradients on the card to the same model on the host within 1e-3.
   The flash phase (3.) also holds the Dh-128 backward at
   llama-vision's 32/8 heads to the plain backward and times it beside
   SDPA's.
8. (i) The H100 cost model (``repro_torch.roofline``) beside the card.
   At the start a host process (no card) counts each (h) train step on
   fake tensors, one device (the (1, 1) mesh), the same cut
   configuration and traffic, with the kernels' work formulas in the
   plain versions' place (``op_costs.card_kernels``), and a second one
   runs the dry-run's production cells ``python -m
   repro_torch.launch.dryrun --arch whisper-base --shape decode_32k
   --mesh single`` and the same for qwen3-moe-30b-a3b at its exact
   config (the expert-parallel moe dispatch, 8 experts a column), each
   on a fake process group of 256 ranks, then four reduced cells at 32
   x 64 tokens whose models once asked this host's torch for ops it
   cannot place (deepseek-v3-671b ``train_4k``: ``roll``;
   recurrentgemma-2b ``prefill_32k`` and ``decode_32k``: a shard turned
   partial; xlstm-125m ``train_4k``: ``flip``).  Last, for
   each of the eight families it prints FLOPs, bytes, t_compute,
   t_memory, the measured ms per step of (h) in this run (the mean of
   steps 2 on), the share of the card's bound the step reaches
   (max(t_compute, t_memory) / measured) and mfu (``model_flops`` over
   the measured time at 989 TFLOP/s), and fails if a modelled time
   passes 1.05 x the measured one; counts one yi-9b (8-layer) step of
   one 4096-token microbatch on the card under ``op_costs.OpCosts``,
   the kernels reporting their work, and fails unless its FLOPs are
   within 1% of the host's fake count of the same step; prints the
   production cells' and the reduced cells' records and fails unless
   each status is ok.
   Before it, (j): the flash backward's ``ffma`` pair, which takes
   every type and head dims the forward takes that ``wgmma`` does not,
   at the reduced launcher's bf16 Dh 16 (8 x 1024, 4/1 heads), reduced
   MLA's 24 / 16, float32 at 192 / 128 (T 2048), bf16 at 96 and 32,
   fp16 at 40 / 72, a window with a softcap and a GQA group of 4,
   through autograd and twice directly (bit-identical) against the
   plain blockwise backward, and timed at the reduced launcher's shape
   and at bf16 Dh 96 (1, 4096, 32/8 heads) beside its operations bound,
   the plain backward and SDPA's backward; then the training launcher
   at its default, reduced configs and 1024 tokens, every architecture
   (``launch.train.setup(arch, reduced=True, seq_len=1024)``, global
   batch 8): the gradient gate against the plain versions (5e-2;
   xlstm's in float32), 3 steps, the first step's loss within 2e-3 of
   the port's CPU step on the same weights and batch, and every
   self-attention family's backward launched, only as ``ffma``.
9. Prints one JSON line of kernel measurements (flash's launches by
   path, the deepseek-v3 engine and the HDArray flash kernel among
   them), the card's name and power limit, and as the last line
   ``{"ok": true, "device": ...}``.

It exits non-zero, and prints no result, without a CUDA device or
without the repository's ``src/repro_torch`` beside it.  float32
products run in IEEE float32: TF32 is switched off for every matmul
and convolution the script times.
"""
from __future__ import annotations

import atexit
import ctypes
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
# the card: gemma2's Dh 256 and qwen3's 128 take flash's wgmma variant
GEMMA2_ARCH, QWEN3_ARCH = "gemma2-9b", "qwen3-moe-30b-a3b"
# served last: 18 RG-LRU layers (the scan kernel) and 8 attention layers
# on the ring cache (flash's wgmma variant at Dh 256, window 2048)
RG_ARCH = "recurrentgemma-2b"
# served last, at full width with its depth cut to the published 3 dense
# layers and 2 of its 58 moe layers (and the MTP head's parameters):
# about 54.6 GB in bf16 (param_count's terms: embeddings 3.71 GB, a dense
# layer 1.17, a moe layer 23.0, MTP 1.37); a third moe layer would need
# 77.6.  Every prefill is MLA's naive form: flash wgmma at Dh 192 /
# Dv 128, 128 heads, the RoPE parts as operands of their own
DSV3_ARCH, DSV3_LAYERS = "deepseek-v3-671b", 5
# one MLA layer's naive form (the kernel) against its absorbed form
# (dense einsums) in bf16, Frobenius-relative: tests/test_torch_mla.py's
# MLA_FORMS_BF16_TOL (the two forms part by 4.5e-3 to 5.0e-3 on the
# reduced layer)
MLA_FORMS_BF16_TOL = 2e-2
# make_flash_kernel on the torch backend: one sequence of HD_FLASH_T
# tokens, its query rows partitioned over NPROC ranks, at llama-vision's
# heads and at MLA's naive form's (both wgmma)
HD_FLASH_T = 4096
HD_FLASH_SHAPES = ((32, 8, 128, 128), (128, 128, 192, 128))
# the RG-LRU scan kernel against float64 and its plain float32 loop,
# relative to max|h|: with decays up to a = 0.998 (lam -6) the float32
# recurrence carries about 1 / (1 - a) = 500 roundings of 2**-24 at
# worst, 3e-5; the kernel's accurate expf, log1pf and sqrtf differ from
# torch's by an ulp or two; 2e-4 bounds both
SCAN_TOL = 2e-4
# served last: 10 mLSTM blocks (plain PyTorch, as the reference's einsums)
# and 2 sLSTM blocks, each one launch of the sLSTM kernel a step
XLSTM_ARCH = "xlstm-125m"
# the sLSTM kernel against float64 and its plain float32 loop, relative to
# max|h| (|h| <= 1 from a state the recurrence can reach).  Each step's
# rounding feeds back through the recurrent weights, so the float32 loop
# itself drifts from float64 along T, by 0.9-1.6e-4 of max|h| at T 2048
# from pre_x ~ N(0, 1) (the model's pre-activations) at xlstm-125m's
# width on an H100 (slstm_phase prints it); kernel and plain loop drift
# that much each, in other directions (other summation orders); 1e-3
# bounds both, while a gate read from its head's own outputs parts by
# over 1e-2 in one step
SLSTM_TOL = 1e-3
# the sLSTM backward against float64 and its plain reverse loop, relative
# to each gradient's largest: SLSTM_TOL, but at (1, 4096, 768) from a
# state SLSTM_BWD_STATE_TOL.  There the float32 loop itself parts from
# float64 by 2.33e-3 (dh0) to 2.89e-3 (d pre_x), the kernel by 1.79e-3
# to 2.96e-3 (dn0) and from the loop by up to 1.28e-3 (dc0; d pre_x
# 2.45e-3 with its bf16 rounding), the same in every run (NVIDIA H100
# 80GB HBM3, 700 W): no float32 loop meets 1e-3 there; in the other
# three cases the loop stays within 4.3e-4 and the kernel within 5e-4
SLSTM_BWD_STATE_TOL = 4e-3
# one bf16 MoE layer against a float32 evaluation of the same routing:
# the bf16 expert products round their operands and outputs (2**-9
# relative each), a few 1e-3 in the Frobenius norm; 2e-2 bounds it
MOE_LAYER_TOL = 2e-2
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 4096
PROMPTS = (2048, 1536, 1024)        # each >= FLASH_MIN_T: every prefill
DECODE_STEPS = 16                   # reaches the flash kernel
# served last, with the yi-9b traffic and image embeddings a slot: 40
# self-attention layers (flash's wgmma at Dh 128, 32/8 heads) and 8
# dense cross-attentions over 1601 image tokens
VLM_ARCH = "llama-3.2-vision-11b"
# served last, with Whisper's own traffic: its decoder context of 448
# tokens (n_text_ctx, openai/whisper's ModelDimensions, arXiv:2212.04356),
# prompts of 224 (a previous-text prompt at its limit), 96 and 4 (the
# bare start-of-transcript sequence), 1500 frames (30 s) a slot; every
# prefill stays under FLASH_MIN_T, and the encoder and cross-attentions
# are dense, so no kernel launches
WHISPER_ARCH = "whisper-base"
WHISPER_MAX_SEQ, WHISPER_PROMPTS = 448, (224, 96, 4)
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
    (1, 130, 130, 8, 1, 64, None, 0.0, "ragged"),
    # Dh 256: gemma2's 16/8 heads with softcap 50 and window 40,
    # recurrentgemma's 10/1 with a window, ragged rows with padding and
    # fully masked rows
    (2, 100, 130, 16, 8, 256, 40, 50.0, "tail"),
    (1, 200, 200, 10, 1, 256, 64, 0.0, "tail"),
    (2, 96, 80, 4, 2, 256, 5, 0.0, "ragged"),
    # MLA's Dh 192 / Dv 128 (D as the pair; wgmma in bf16 and fp16, the
    # ffma pair in float32): deepseek-v3's heads over as many, a tail and
    # ragged rows with padding and fully masked rows
    (2, 100, 130, 4, 4, (192, 128), None, 0.0, "tail"),
    (2, 96, 80, 4, 4, (192, 128), None, 0.0, "ragged"))

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
# (h) the Dh-256 families trained with the yi-9b traffic (TRAIN_SEQ,
# TRAIN_BATCH, TRAIN_MICRO), FAMILY_TRAIN_STEPS steps each, alone on the
# card: gemma2-9b at full width, depth cut to 8 of 42 layers (4 local
# and 4 global, alternating as published: 3.420 B parameters, 54.7 GB
# at 16 bytes a parameter; all 42 would need 162.5 GB), recurrentgemma-2b
# at full width and depth (26 layers, 18 RG-LRU and 8 local attention:
# 3.314 B parameters, 53.0 GB)
GEMMA2_TRAIN_LAYERS, FAMILY_TRAIN_STEPS = 8, 4
# recurrentgemma-2b's gradient gate at full depth: two plain paths that
# differ only in the blockwise attention's block sizes (512 x 1024 and
# 256 x 256) part by 5.15e-2 at the worst leaf (3.9e-2 at the median),
# and each bf16 path lies 8.55e-2 from the float32 model at its worst
# leaf (NVIDIA H100 80GB HBM3, 700 W; tools/rg_grad_spread.py): at 26
# layers TRAIN_GRAD_TOL's 5e-2 sits under the model's own bf16 spread
# (gemma2's 8 layers part by 2.1e-2).  So the gate measures that spread
# in the run (the plain path again with 256 x 256 blocks) and holds the
# kernels' distance from the plain path to RG_TRAIN_GRAD_TOL and to
# twice the spread; a wrong window, gate or softcap term parts by O(1)
RG_TRAIN_GRAD_TOL = 1e-1
# (h) deepseek-v3 trained at full width with its depth cut to 2 layers,
# both leading dense ones (MLA and the 18432-wide FFN), and the MTP head:
# untied embeddings 2 x 0.927 B, three MLA + dense-FFN blocks (two in the
# stack, one in the MTP head) 3 x 0.5835 B, mtp_proj 0.103 B: 3.71 B
# parameters, 59.3 GB at 16 bytes a parameter.  One routed layer alone
# is 11.27 B parameters (180 GB), so training takes no moe layer; a third
# dense layer would bring the state to 68.6 GB.  Per microbatch flash
# launches 2 a checkpointed layer + 1 for the MTP block, its backward 3
DSV3_TRAIN_LAYERS = 2
# (h) xlstm-125m's gradient gate computes in float32 (its steps in bf16):
# in bf16 the model's own gradients are not reproducible at init.  In the
# reference too: scaling r_in by 1 + 2**-20 moves its bf16 gradients by
# 0.37 at the worst leaf, its float32 ones by 2.4e-5 (d_model 128,
# tests/test_torch_xlstm_spread.py).  On the card two plain paths that
# differ only in the sLSTM loop's precision part by O(1) in bf16, by
# 1e-2 in float32; the backward of each mLSTM chunk multiplies that
# change at q, k and the gates (its normaliser max(|den|, exp(-m)) and
# stabiliser), not at v (tools/xlstm_grad_spread.py; PERF.md §6).  So
# the sLSTM kernels are held in bf16 layer by layer on a training
# microbatch's own inputs (slstm_train_check), the model in float32
XLSTM_GATE_DTYPE = "float32"
# (h) the last three families, each alone after every earlier phase:
# llama-3.2-vision-11b at full width with 10 of its 40 layers, two
# super-blocks of cross_every 5 and their two cross-attentions (untied
# embeddings 2 x 0.5253 B, ten blocks x 0.2181 B, two cross-attentions x
# 0.0671 B: 3.366 B parameters, 53.9 GB at 16 bytes a parameter; all 40
# would need 165 GB), and qwen3-moe-30b-a3b with 4 of its 48 layers
# under the published capacity factor 1.25 (embeddings 2 x 0.3112 B,
# each layer 18.87 M of attention, 604.0 M of experts, 0.26 M of router:
# 3.115 B parameters, 49.8 GB; a fifth layer would make 59.8 GB), both
# with the yi-9b traffic; whisper-base whole (97 M parameters) with its
# own: decoder sequences of its n_text_ctx, 448 tokens, 1500 frames a
# sample, a global batch of 32 in 2 microbatches
VLM_TRAIN_LAYERS, QWEN3_TRAIN_LAYERS = 10, 4
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_MICRO = 32, 2
# whisper's path launches no kernel (its 448 tokens are under
# FLASH_MIN_T, its encoder and cross-attentions dense), so its gate holds
# one sample's float32 loss and gradients on the card to the same float32
# model on the host: the two sum in other orders, a few float32 ulps a
# product carried back through 12 layers; fro_rel per leaf
HOST_GATE_TOL = 1e-3
# the scan's backward at the training microbatch and at the pool's
# prefill shape, from a state and without
SCAN_BWD_SHAPES = ((1, 4096, 2560), (4, 2048, 2560))
# channels of that phase whose lam (-25) makes a = 1 in float32
CLAMPED = 4


# (i) the cost model: a modelled step may not take longer than this
# share of the measured one (the model is a bound: max(t_compute,
# t_memory) above the measurement is a fault of the count); the card's
# count of one step against the host's fake count of it
MODEL_OVER_MEASURED = 1.05
CARD_COUNT_TOL = 1e-2
DRYRUN_CELLS = (("whisper-base", "decode_32k"),
                ("qwen3-moe-30b-a3b", "decode_32k"))
# (i) reduced cells (the config's ``reduced()`` at 32 x 64 tokens) traced
# under this host's torch: the four whose models once asked DTensor for
# what torch 2.11 cannot place (roll, a shard turned partial, flip)
DRYRUN_REDUCED_CELLS = (("deepseek-v3-671b", "train_4k"),
                        ("recurrentgemma-2b", "prefill_32k"),
                        ("recurrentgemma-2b", "decode_32k"),
                        ("xlstm-125m", "train_4k"))
# (j) the training launcher at its default, reduced configs (d_model 64,
# 4 heads of 16; MLA 24 / 16 with its RoPE part joined) and 1024
# tokens, where every self-attention layer takes flash (FLASH_MIN_T), in
# bf16: its backward is the ffma pair.  Every architecture, as the
# reference's launcher trains each of them there on the CPU; the
# launcher's global batch of 8 in one microbatch
REDUCED_SEQ = 1024
REDUCED_BATCH = 8
REDUCED_STEPS = 3
# the first step on the card against the port's CPU step on the same
# weights and batch: two bf16 programs that round at other points (the
# kernels against the CPU's plain attention), its loss within
# REDUCED_LOSS_RTOL and its gradient's global norm within
# REDUCED_GNORM_RTOL.  On the CPU the port and the reference part by
# 3.7e-5 / 8.3e-4 (yi-9b) and 1.8e-4 / 3.3e-3 (deepseek-v3) in loss /
# norm at global batch 2 (tests/test_torch_launch_train_1024.py).  At
# init the loss alone is a weak check: faults planted on the CPU move
# it by 7.0e-4 (the MTP roll dropped) to 7.2e-3 (no causal mask), the
# norm by 2.1e-2 to 0.21; the attention kernels are held to their plain
# versions at these shapes in flash_bwd_ffma_phase.  The norm is held
# for every family but xlstm, whose bf16 gradients are not reproducible
REDUCED_LOSS_RTOL = 2e-3
REDUCED_GNORM_RTOL = 1e-2
# the ffma pair against the plain blockwise backward at the widths the
# forward takes and wgmma does not: fro_rel of dq, dk and dv within
# BWD_MAIN_TOL.  (dtype, B, T, S, Hq, Hkv, Dh, Dv, window, softcap, qpos)
FFMA_SHAPES = (
    # the reduced launcher's (yi-9b's 4 heads over 1), reduced MLA's
    ("bfloat16", 8, 1024, 1024, 4, 1, 16, 16, None, 0.0, "tail"),
    ("bfloat16", 8, 1024, 1024, 4, 4, 24, 16, None, 0.0, "tail"),
    # float32 at deepseek-v3's widths, a few heads
    ("float32", 1, 2048, 2048, 4, 4, 192, 128, None, 0.0, "tail"),
    ("bfloat16", 1, 2048, 2048, 8, 2, 96, 96, None, 0.0, "tail"),
    ("bfloat16", 2, 1024, 1024, 8, 8, 32, 32, None, 0.0, "ragged"),
    ("float16", 2, 1024, 1024, 4, 2, 40, 72, None, 0.0, "tail"),
    # reduced gemma2's window and softcap; a GQA group of 4 with a window
    ("bfloat16", 2, 1024, 1024, 4, 2, 16, 16, 16, 50.0, "tail"),
    ("bfloat16", 1, 1024, 1024, 12, 3, 48, 48, 100, 0.0, "ragged"))
# timed: the reduced launcher's shape and bf16 Dh 96 at 32/8 heads.
# (dtype, B, T, Hq, Hkv, D), causal, T = S
FFMA_TIMED = (("bfloat16", REDUCED_BATCH, REDUCED_SEQ, 4, 1, 16),
              ("bfloat16", 1, 4096, 32, 8, 96))


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


def cuda_ms(torch, fn, reps: int, warm: bool = True,
            queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call (none without ``warm``), from CUDA events.  With ``queued`` the
    stream first spins for about 50 ms (``torch.cuda._sleep``), so the
    host has queued every call before the first runs: a call whose
    device work is shorter than its host work is timed on the device."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
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
    # the library's one call: a float32 convolution with the 4-neighbour
    # 0.25 kernel (cuDNN; main turns TF32 off) computes the slab's
    # interior, the same sweep without the edges that pass through; its
    # sums run in another order, so it is not bit-identical to the kernel
    stencil = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                            [0.0, 0.25, 0.0]], device=dev).view(1, 1, 3, 3)

    def library():
        return torch.nn.functional.conv2d(slab.view(1, 1, sm, sn), stencil)
    check(not torch.backends.cudnn.allow_tf32, "cuDNN's TF32 is on")
    lib_err = float((library()[0, 0] - out).abs().max())
    lib_ms = cuda_ms(torch, library, 20)
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
        bound_by="bytes", library_ms=lib_ms,
        library="conv2d, the 4-neighbour 0.25 kernel, cuDNN with TF32 off "
                "(the interior only; not bit-identical)",
        library_max_abs_err=lib_err, shape=[sm, sn])
    print(f"jacobi at the rank 0 slab {[sm, sn]}: kernel {jac['ms']:.4f} ms, "
          f"conv2d (interior, TF32 off) {lib_ms:.4f} ms, within "
          f"{lib_err:.3e} of the kernel's interior; bound "
          f"{jac['bound_ms']:.4f} ms (bytes)")
    check(lib_err <= 1e-5 * float(slab.abs().max()),
          "conv2d computes another sweep than the Jacobi kernel")
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
               Dv: int, itemsize: int, window=None, shared_k: int = 0):
    """(flops, bytes) that causal attention needs for these query
    positions (and window): 2 (Dh + Dv) flops (q.k and p.v) per visible
    (query, key) pair and head; q and o once, and the k and v rows some
    query sees, the last ``shared_k`` of K's Dh columns (MLA's RoPE key)
    once a row for every kv head: the formula the kernel reports to the
    cost model (``roofline/kernel_work.py``)."""
    from repro_torch.roofline import kernel_work
    flops, nbytes, _ = kernel_work.flash_fwd(
        B, qpos.shape[1], S, Hq, Hkv, Dh, Dv, itemsize,
        *kernel_work.visible(qpos, S, window), shared_k)
    return int(flops), int(nbytes)


def flash_phase(torch, ptxas):
    """The flash-attention kernel against its plain versions on the
    card, each in its working type, then its time beside the plain
    version's and SDPA's at the serving path's prefill shape; the same
    for the wgmma variant at gemma2's (Dh 256), beside flex_attention
    with the softcap (SDPA without it is not the same function), with
    the ptxas report of its Dh-256 kernels (``ptxas``: flash_attn_hd's
    (kernel, report) pairs); then MLA's shape (``mla_flash_check``)
    beside the ptxas report of its Dh 192 / Dv 128 kernels.  Returns the
    two measurements."""
    import re

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
    # (Dh 192 / Dv 128 takes the wgmma variant, Dh 96 / Dv 64 holds
    # mma_sync, in bf16 and fp16)
    by_variant = flash_attention_cuda.by_variant
    mma0 = by_variant["mma_sync"]
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
                ("Dh=192 Dv=128", (2, 70, 90, 4, 2, 192, 128), {}),
                ("Dh=96 Dv=64", (2, 70, 90, 4, 2, 96, 64), {})):
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
    check(by_variant["mma_sync"] - mma0 == 2, f"the small shapes launched "
          f"mma_sync {by_variant['mma_sync'] - mma0} times, not twice "
          f"(Dh 96 / Dv 64 in bf16 and fp16)")

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

    # -- wgmma at gemma2's heads (16/8 of Dh 256): its local window
    # under T with the softcap against float64, then the first admit's
    # prefill shape against the plain blockwise version, at gemma2's
    # window (which, like its odd layers' BIG_WINDOW, never binds in a
    # 4096-position cache) and at one that binds there, off the tiles;
    # fully masked rows exactly 0
    g2 = get_config(GEMMA2_ARCH)
    Hq2, Hkv2, D2, cap = g2.n_heads, g2.n_kv_heads, g2.head_dim, \
        g2.attn_softcap
    check(flash_variant(torch.bfloat16, D2, D2) == "wgmma",
          f"{GEMMA2_ARCH}'s Dh {D2} does not take the wgmma variant")
    reports = [(name, rep) for name, rep in ptxas
               if re.search(r"fa_wgmma_kernel(<.*\b256\b|I.*Li256E)", name)]
    check(len(reports) == 4, f"{len(reports)} Dh-256 wgmma kernels in the "
          f"build log, not 4 (bf16 and fp16, with and without the softcap)")
    for name, rep in reports:
        print(f"flash wgmma Dh {D2} ptxas: {name}: {rep}")
    wg0 = by_variant["wgmma"]

    def oracle(q, k, v, qpos, **kw):
        return dense64(torch, q.double(), k.double(), v.double(), qpos, **kw)

    for dtype in (torch.bfloat16, torch.float16):
        q, k, v = inputs(dtype, 2, 200, 330, Hq2, Hkv2, D2)
        q = q * 30                 # logits of about 30: the cap bends them
        qp = torch.arange(130, 330, dtype=torch.int32, device=dev).repeat(2, 1)
        compare(f"wgmma Dh=Dv={D2} {Hq2}/{Hkv2} heads q x 30 window=40 "
                f"softcap={cap:g} (float64 dense)", dtype, q, k, v, qp,
                oracle, window=40, softcap=cap)
        qp = qp.clone()
        qp[:, :7] = -1                             # padding rows
        qp[1, 50:60] = 400                         # window 4: keys > S
        out, _ = compare(f"wgmma Dh=Dv={D2} ragged qpos, fully masked "
                         f"rows, window=4 softcap={cap:g} (float64 dense)",
                         dtype, q, k, v, qp, oracle, window=4, softcap=cap)
        masked = out[:, :7].abs().sum() + out[1, 50:60].abs().sum()
        check(float(masked) == 0.0, "fully masked Dh-256 flash rows are not 0")
    q2, k2, v2 = inputs(torch.bfloat16, B, T, S, Hq2, Hkv2, D2)
    err256 = 0.0
    for w in (g2.window, 1000):
        _, err = compare(f"wgmma {GEMMA2_ARCH} prefill {tuple(q2.shape)} x "
                         f"k,v {tuple(k2.shape)} strides {k2.stride()} "
                         f"window={w} softcap={cap:g}", torch.bfloat16, q2,
                         k2, v2, qpos, blockwise_attention,
                         tol=FLASH_MAIN_TOL, window=w, softcap=cap)
        err256 = max(err256, err)
    check(by_variant["wgmma"] - wg0 == 6, "a Dh-256 check launched another "
          "variant than wgmma")
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
    print(f"flash wgmma Dh {D2} vs flex_attention (softcap score_mod, window "
          f"block mask, enable_gqa) at {GEMMA2_ARCH}'s prefill shape, q x 30: "
          f"max_abs_diff={lib_err:.3e}")
    check(lib_err <= FLASH_TOL["bfloat16"] * 4, "flex_attention computes "
          "another function than the Dh-256 wgmma kernel")
    del q30
    flash_256 = dict(
        name="flash_attn_hd", variant="wgmma", route="cuda",
        source="src/repro_torch/csrc/flash_attn_hd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:80",
        max_abs_err=err256,
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
        softcap=cap, ptxas=dict(reports))
    print(f"flash wgmma Dh {D2} at {tuple(q2.shape)} x {tuple(k2.shape)} "
          f"window {g2.window} softcap {cap:g}: {flops:.4e} flops, "
          f"{nbytes:.4e} bytes; kernel {flash_256['ms']:.4f} ms "
          f"({flops / flash_256['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * flash_256['bound_ms'] / flash_256['ms']:.1f}% of the "
          f"bound), bound {flash_256['bound_ms']:.4f} ms "
          f"({flash_256['bound_by']}), plain {flash_256['plain_ms']:.4f} ms, "
          f"flex_attention {flash_256['library_ms']:.4f} ms; SDPA without "
          f"the softcap, NOT the same function, "
          f"{flash_256['sdpa_without_softcap_ms']:.4f} ms")
    del q2, k2, v2, q2t, k2t, v2t, q2h, flex

    # -- wgmma at recurrentgemma's ring prefill, as the engine calls it:
    # 10 query heads over 1 kv head of Dh 256, k and v this call's own
    # contiguous projection (S = T), window 2048, no softcap; the pool's
    # qpos, the admitted slot's from 0 and the other slots' from the
    # positions they hold after their prompts and decode steps
    rg = get_config(RG_ARCH)
    Hq3, Hkv3, D3 = rg.n_heads, rg.n_kv_heads, rg.head_dim
    check(flash_variant(torch.bfloat16, D3, D3) == "wgmma",
          f"{RG_ARCH}'s Dh {D3} does not take the wgmma variant")
    q3 = torch.randn((B, T, Hq3, D3), generator=g, device=dev).bfloat16()
    k3, v3 = (torch.randn((B, T, Hkv3, D3), generator=g, device=dev)
              .bfloat16() for _ in range(2))
    held = torch.tensor((0,) + tuple(p + DECODE_STEPS for p in PROMPTS),
                        dtype=torch.int32, device=dev)[:B]
    qpos3 = held[:, None] + torch.arange(T, dtype=torch.int32, device=dev)
    wg0, n0 = by_variant["wgmma"], flash_attention_cuda.launches
    _, err_rg = compare(f"wgmma {RG_ARCH} ring prefill {tuple(q3.shape)} x "
                        f"k,v {tuple(k3.shape)} qpos from {held.tolist()} "
                        f"window={rg.window}", torch.bfloat16, q3, k3, v3,
                        qpos3, blockwise_attention, tol=FLASH_MAIN_TOL,
                        window=rg.window)
    check(by_variant["wgmma"] - wg0 == 1
          and flash_attention_cuda.launches - n0 == 1,
          f"{RG_ARCH}'s ring prefill check launched "
          f"{flash_attention_cuda.launches - n0} flash kernels, "
          f"{by_variant['wgmma'] - wg0} of them wgmma, not 1")
    flops, nbytes = flash_work(torch, qpos3, T, B, Hq3, Hkv3, D3, D3, 2,
                               window=rg.window)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    flash_256["recurrentgemma"] = dict(
        max_abs_err=err_rg,
        ms=cuda_ms(torch, lambda: flash_attention_cuda(
            q3, k3, v3, qpos=qpos3, window=rg.window), 10),
        plain_ms=cuda_ms(torch, lambda: blockwise_attention(
            q3, k3, v3, qpos=qpos3, window=rg.window), 3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=[list(q3.shape), list(k3.shape)], window=rg.window)
    r = flash_256["recurrentgemma"]
    print(f"flash wgmma Dh {D3} at {RG_ARCH}'s ring prefill "
          f"{tuple(q3.shape)} x {tuple(k3.shape)} window {rg.window}: "
          f"{flops:.4e} flops, {nbytes:.4e} bytes; kernel {r['ms']:.4f} ms "
          f"({100 * r['bound_ms'] / r['ms']:.1f}% of the bound), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms")
    del q3, k3, v3

    # -- wgmma at llama-3.2-vision's prefill: 32 query heads over 8 kv
    # heads of 128 (a GQA group of 4), the first admit's qpos, k and v
    # strided views of a 4096-position cache; timed beside SDPA --------
    vl = get_config(VLM_ARCH)
    Hq4, Hkv4, D4 = vl.n_heads, vl.n_kv_heads, vl.head_dim
    check(flash_variant(torch.bfloat16, D4, D4) == "wgmma",
          f"{VLM_ARCH}'s Dh {D4} does not take the wgmma variant")
    q4, k4, v4 = inputs(torch.bfloat16, B, T, S, Hq4, Hkv4, D4)
    wg0, n0 = by_variant["wgmma"], flash_attention_cuda.launches
    _, err_vl = compare(f"wgmma {VLM_ARCH} prefill {tuple(q4.shape)} x k,v "
                        f"{tuple(k4.shape)} strides {k4.stride()} "
                        f"window=BIG_WINDOW", torch.bfloat16, q4, k4, v4,
                        qpos, blockwise_attention, tol=FLASH_MAIN_TOL,
                        window=BIG_WINDOW)
    check(by_variant["wgmma"] - wg0 == 1
          and flash_attention_cuda.launches - n0 == 1,
          f"{VLM_ARCH}'s prefill check launched "
          f"{flash_attention_cuda.launches - n0} flash kernels, "
          f"{by_variant['wgmma'] - wg0} of them wgmma, not 1")
    q4t, k4t, v4t = (x.transpose(1, 2) for x in (q4, k4, v4))
    sdpa4 = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4t, k4t, v4t, is_causal=True, enable_gqa=True)
    kernel4 = lambda: flash_attention_cuda(          # noqa: E731
        q4, k4, v4, qpos=qpos, window=BIG_WINDOW)
    lib_err = float((sdpa4().transpose(1, 2).float() - kernel4().float())
                    .abs().max())
    print(f"flash vs SDPA (is_causal, enable_gqa) at {VLM_ARCH}'s prefill "
          f"shape: max_abs_diff={lib_err:.3e}")
    check(lib_err <= FLASH_TOL["bfloat16"] * 4, "SDPA computes another "
          f"function than the kernel at {VLM_ARCH}'s prefill shape")
    flops, nbytes = flash_work(torch, qpos, S, B, Hq4, Hkv4, D4, D4, 2)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    flash["vlm"] = r = dict(
        max_abs_err=err_vl, ms=cuda_ms(torch, kernel4, 20),
        plain_ms=cuda_ms(torch, lambda: blockwise_attention(
            q4, k4, v4, qpos=qpos, window=BIG_WINDOW), 3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=cuda_ms(torch, sdpa4, 20),
        shape=[list(q4.shape), list(k4.shape)])
    print(f"flash wgmma Dh {D4} at {VLM_ARCH}'s prefill {tuple(q4.shape)} x "
          f"{tuple(k4.shape)} ({Hq4}/{Hkv4} heads): {flops:.4e} flops, "
          f"{nbytes:.4e} bytes; kernel {r['ms']:.4f} ms "
          f"({flops / r['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms")
    del q4, k4, v4, q4t, k4t, v4t
    # the four Dh 192 / Dv 128 wgmma kernels (bf16 and fp16, with and
    # without the softcap), each without a spill or C75xx warning (main
    # has failed the run on either in the file)
    reports = [(name, rep) for name, rep in ptxas
               if re.search(r"fa_wgmma_kernel(<.*\b192\b.*\b128\b|"
                            r"I.*Li192ELi128E)", name)]
    check(len(reports) == 4, f"{len(reports)} Dh 192 / Dv 128 wgmma "
          f"kernels in the build log, not 4")
    for name, rep in reports:
        print(f"flash wgmma Dh 192 / Dv 128 ptxas: {name}: {rep}")
    flash["wgmma_mla"] = mla_flash_check(torch, compare, qpos, oracle)
    flash["wgmma_mla"]["ptxas"] = dict(reports)
    torch.cuda.empty_cache()
    return flash, flash_256


def mla_inputs(torch, seed: int = 26):
    """deepseek-v3's MLA prefill operands as the naive form hands them to
    the kernel: the first admit's q (B, 2048, 128, d_nope) and q_rope (B,
    2048, 128, d_rope), strided views of one projection; k (B, 4096, 128,
    d_nope) and v (B, 4096, 128, d_v) from a bf16 latent through wk_b and
    wv_b; the shared RoPE key k_rope (B, 4096, 1, d_rope), a strided view
    of the cache's rows (the latent, then the RoPE key, 1152 bytes a
    row).  Returns (q, k, v, q_rope, k_rope, scale = 1/sqrt(192))."""
    from repro_torch.configs import get_config

    cfg = get_config(DSV3_ARCH)
    m, H = cfg.mla, cfg.n_heads
    B, T, S = SERVE_SLOTS, PROMPTS[0], SERVE_MAX_SEQ
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        x = torch.randn(shape, generator=g, device="cuda")
        return x.mul_(scale).to(torch.bfloat16)

    cache = randn(B, S, m.kv_lora + m.d_rope)
    latent = cache[..., :m.kv_lora]
    wk_b = randn(m.kv_lora, H * m.d_nope, scale=m.kv_lora ** -0.5)
    wv_b = randn(m.kv_lora, H * m.d_v, scale=m.kv_lora ** -0.5)
    k = (latent @ wk_b).reshape(B, S, H, m.d_nope)
    v = (latent @ wv_b).reshape(B, S, H, m.d_v)
    proj = randn(B, T, H * (m.d_nope + m.d_rope))
    q = proj[..., :H * m.d_nope].unflatten(-1, (H, m.d_nope))
    q_rope = proj[..., H * m.d_nope:].unflatten(-1, (H, m.d_rope))
    return (q, k, v, q_rope, cache[..., None, m.kv_lora:],
            (m.d_nope + m.d_rope) ** -0.5)


def mla_flash_check(torch, compare, qpos, oracle):
    """wgmma at deepseek-v3's MLA prefill (``mla_inputs``), as the naive
    form launches it (the RoPE parts as operands of their own) and on the
    concatenated operands: the two must have the same bits, the first
    within FLASH_MAIN_TOL of the plain blockwise version; then the split
    operands at small shapes (GQA, T and S off the tiles, ragged qpos
    with padding and fully masked rows) against float64 (``oracle``),
    each the concatenated launch's bits.  Times both launches beside the
    blockwise version and one PyTorch call on the concatenated operands
    (SDPA's memory-efficient backend, which takes Dv != Dh, else
    compiled flex_attention).  ``compare`` is flash_phase's."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_variant)
    from repro_torch.kernels.flash_attention.ref import join_rope

    q, k, v, q_rope, k_rope, scale = mla_inputs(torch)
    B, T, H, Dn = q.shape
    S, Dr, Dv = k.shape[1], q_rope.shape[-1], v.shape[-1]
    Dh = Dn + Dr
    variant = flash_variant(torch.bfloat16, Dh, Dv)
    check(variant == "wgmma",
          f"{DSV3_ARCH}'s Dh {Dh} / Dv {Dv} does not take wgmma")
    rope = dict(q_rope=q_rope, k_rope=k_rope)
    by_variant = flash_attention_cuda.by_variant
    n0, v0 = flash_attention_cuda.launches, by_variant[variant]
    split, err = compare(
        f"{variant} {DSV3_ARCH} MLA prefill q {tuple(q.shape)} strides "
        f"{q.stride()} + q_rope {tuple(q_rope.shape)}, k "
        f"{tuple(k.shape)} + k_rope {tuple(k_rope.shape)} strides "
        f"{k_rope.stride()}, v {tuple(v.shape)}, scale 1/sqrt({Dh})",
        torch.bfloat16, q, k, v, qpos, blockwise_attention,
        tol=FLASH_MAIN_TOL, window=None, scale=scale, **rope)
    check(flash_attention_cuda.launches - n0 == 1
          and by_variant[variant] - v0 == 1,
          f"the MLA-shape check launched another variant than {variant}")
    q_cat, k_cat = join_rope(q, k, q_rope, k_rope)
    kernel = lambda: flash_attention_cuda(           # noqa: E731
        q, k, v, qpos=qpos, window=None, scale=scale, **rope)
    kernel_cat = lambda: flash_attention_cuda(       # noqa: E731
        q_cat, k_cat, v, qpos=qpos, window=None, scale=scale)
    same = torch.equal(split, kernel_cat())
    print(f"flash {variant} at {DSV3_ARCH}'s MLA prefill: the RoPE parts as "
          f"operands and concatenated give the same bits: {same}")
    check(same, "the split RoPE launch differs from the concatenated one")
    del split

    # small shapes: 8 query heads over 2 kv heads, the RoPE key shared
    g = torch.Generator(device="cuda").manual_seed(27)
    for dtype in (torch.bfloat16, torch.float16):
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        qs = randn(2, 200, 8, Dh)[..., :Dn]               # strided q
        kv = randn(2, 330, 2, 2, Dv)
        ks, vs = randn(2, 330, 2, Dn), kv[:, :, 1]
        qrs, krs = randn(2, 200, 8, Dr), randn(2, 330, 1, Dr)
        qp = torch.arange(130, 330, dtype=torch.int32,
                          device="cuda").repeat(2, 1)
        qp[:, :7] = -1                                  # padding rows
        qp[1, 50:60] = 400                              # window 4: none
        qc, kc = join_rope(qs, ks, qrs, krs)
        for name, kw in (("causal", {}), ("window=4", dict(window=4))):
            out, _ = compare(
                f"{variant} Dh={Dn}+{Dr} Dv={Dv} RoPE operands, 8/2 heads, "
                f"strided q, ragged qpos with padding rows {name} "
                f"(float64 dense)", dtype, qs, ks, vs, qp,
                lambda q_, k_, v_, q_rope, k_rope, **kw_: oracle(
                    *join_rope(q_, k_, q_rope, k_rope), v_, **kw_),
                q_rope=qrs, k_rope=krs, **kw)
            same = torch.equal(out, flash_attention_cuda(
                qc, kc, vs, qpos=qp, **kw))
            masked = out[:, :7].abs().sum() + (
                out[1, 50:60].abs().sum() if kw else 0)
            check(same and float(masked) == 0.0, f"the split RoPE launch "
                  f"at {name} differs from the concatenated one "
                  f"({same}) or its fully masked rows are not 0")
    check(by_variant[variant] - v0 == 2 + 2 * 2 * 2,
          f"the MLA checks launched another variant than {variant}")

    qt, kt, vt = (x.transpose(1, 2) for x in (q_cat, k_cat, v))
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           scale=scale)

        def library():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale)
        lib_name = "SDPA (memory-efficient backend, is_causal)"
    except RuntimeError as e:
        print(f"SDPA's memory-efficient backend refuses Dh {Dh} / Dv {Dv}: "
              f"{str(e).splitlines()[0][:120]}")
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        mask = create_block_mask(lambda b, h, qi, ki: ki <= qi, None, None,
                                 T, S, device="cuda")
        qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
        flex = torch.compile(flex_attention, dynamic=False)

        def library():
            return flex(qc, kc, vc, block_mask=mask, scale=scale)
        lib_name = "compiled flex_attention (causal block mask)"
    lib_err = float((library().transpose(1, 2).float() - kernel().float())
                    .abs().max())
    print(f"flash {variant} vs {lib_name} at {DSV3_ARCH}'s MLA prefill "
          f"shape: max_abs_diff={lib_err:.3e}")
    check(lib_err <= FLASH_TOL["bfloat16"] * 4, f"{lib_name} computes "
          f"another function than {variant} at the MLA prefill shape")
    flops, nbytes = flash_work(torch, qpos, S, B, H, H, Dh, Dv, 2,
                               shared_k=Dr)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    r = dict(variant=variant, max_abs_err=err,
             ms=cuda_ms(torch, kernel, 20),
             concatenated_ms=cuda_ms(torch, kernel_cat, 20),
             plain_ms=cuda_ms(torch, lambda: blockwise_attention(
                 q, k, v, qpos=qpos, window=None, scale=scale, **rope), 2),
             bound_ms=1e3 * max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             library_ms=cuda_ms(torch, library, 10), library=lib_name,
             same_bits_as_concatenated=True,
             shape=[list(q.shape), list(q_rope.shape), list(k.shape),
                    list(k_rope.shape), list(v.shape)])
    print(f"flash {variant} Dh {Dh} / Dv {Dv} at {DSV3_ARCH}'s MLA prefill "
          f"q {tuple(q.shape)} + q_rope {tuple(q_rope.shape)}, k "
          f"{tuple(k.shape)} + k_rope {tuple(k_rope.shape)}, v "
          f"{tuple(v.shape)}: {flops:.4e} flops, {nbytes:.4e} bytes; kernel "
          f"{r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound), on the "
          f"concatenated operands {r['concatenated_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms, {lib_name} {r['library_ms']:.4f} ms")
    return r


def flex_call(torch, qpos, S: int, window: int, softcap: float):
    """One PyTorch call for causal GQA attention at ``qpos`` with a
    ``window`` and, where ``softcap``, a tanh softcap: compiled
    flex_attention, whose block mask is the window and whose score_mod
    caps the scaled logits.  Returns it as a function of head-major q,
    k and v ((B, H, T|S, D)); differentiable."""
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
    kw = dict(block_mask=create_block_mask(mask_mod, B, None, T, S,
                                           device=qpos.device),
              enable_gqa=True)
    if softcap:
        kw["score_mod"] = score_mod
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda qt, kt, vt: fn(qt, kt, vt, **kw)


def flex_softcap(torch, k, v, qpos, window: int, softcap: float):
    """:func:`flex_call` with k and v bound as head-major copies: a
    function of a head-major q (B, Hq, T, Dh), output (B, Hq, T, Dv)."""
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    fn = flex_call(torch, qpos, k.shape[1], window, softcap)
    return lambda qt: fn(qt, kt, vt)


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
               keys: int = 128, window=None):
    """The wgmma dK and dV kernels' work at these query positions, as
    their producers walk it: (blocks, tile steps in all, the longest
    block's steps).  A block is (keys keys, query head, batch): 128 at
    Dh 64 and 128, 64 in Dh 256's one dK/dV pass; a step is one 64-row
    query tile some row of which sees one of its keys."""
    B, T = qpos.shape
    n = -(-T // rows)
    pad = torch.full((B, n * rows), -1, dtype=torch.long, device=qpos.device)
    pad[:, :T] = qpos.long()
    tiles = pad.view(B, n, rows)
    valid = tiles >= 0
    hi = torch.where(valid, torch.clamp(tiles, max=S - 1), -1).amax(-1)
    first = torch.clamp(tiles - window + 1, min=0) if window else \
        torch.zeros_like(tiles)
    lo = torch.where(valid, first, S).amin(-1)
    k0 = torch.arange(0, S, keys, device=qpos.device)
    # a tile sees the block when its rows' keys, [lo, hi], meet it
    steps = ((hi[:, None, :] >= k0[None, :, None])
             & (lo[:, None, :] <= k0[None, :, None] + keys - 1)).sum(-1)
    return (B * Hq * len(k0), int(steps.sum()) * Hq, int(steps.max()))


def profiled_events(torch, fn, reps: int, kept, windows: int = 6,
                    cpu: bool = False):
    """(the CUDA events of ``reps`` calls of ``fn`` under torch.profiler,
    windows profiled), after one call outside it; with ``cpu``, CPU
    activity profiled too, as ``device_breakdown`` profiles.  Late in a
    long process the profiler keeps only some of a short window's kernels
    (33 to 36 of 50 in most windows) and now and then none of them (0 of
    50 in one window of a run whose windows before and after kept 34), so
    a window whose events ``kept`` rejects is profiled again, up to
    ``windows`` times, each after a pause of 0.1 s; the last window's
    events if none was kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for window in range(1, windows + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(0.1)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if kept(events):
            break
    return events, window


def bwd_split(torch, fn, reps: int = 5, want=()):
    """Device ms per launch of each kernel of the wgmma backward, from
    torch.profiler over ``reps`` calls of ``fn``: a window that kept none
    of them, or not every label of ``want``, is profiled again
    (``profiled_events``)."""
    import re

    names = {"prep_kernel": "pre-pass", "dq_wgmma_kernel": "dQ",
             "dkdv_roles_kernel": "dK/dV", "gqa_sum_kernel": "GQA sum"}

    def split_of(events):
        split = {}
        for e in events:
            m = re.search(r"dkv_wgmma_kernel<[^>]*, (true|false)>", e.name)
            label = ("dK" if m.group(1) == "true" else "dV") if m else next(
                (v for k, v in names.items() if k in e.name), None)
            if label is None:
                continue
            us, count = split.get(label, (0.0, 0))
            split[label] = (us + e.time_range.end - e.time_range.start,
                            count + 1)
        return split

    events, _ = profiled_events(
        torch, fn, reps,
        lambda ev: bool(split_of(ev)) and set(want) <= set(split_of(ev)))
    split = split_of(events)
    if not set(want) <= set(split):
        split = {}
    return {k: us / 1e3 / count for k, (us, count) in split.items()}


def bwd_inputs(torch, g, dtype, B, T, S, Hq, Hkv, Dh, Dv, kind):
    """q, k, v and dO drawn from ``g`` on the card in ``dtype``, and
    qpos: "tail" (T causal rows ending at S) or "ragged" (random
    positions, padding rows and rows that see nothing)."""
    dev = g.device
    q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dtype)
                   for sh in ((B, T, Hq, Dh), (B, S, Hkv, Dh),
                              (B, S, Hkv, Dv), (B, T, Hq, Dv)))
    if kind == "tail":
        qpos = torch.arange(S - T, S, dtype=torch.int32,
                            device=dev).repeat(B, 1)
    else:
        qpos = torch.randint(-1, S + 10, (B, T), generator=g, device=dev,
                             dtype=torch.int32)
        qpos[:, :9] = -1
        qpos[-1, 20:30] = S + 200
    return q, k, v, do, qpos


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

    g = torch.Generator(device="cuda").manual_seed(4)

    def kernel_grads(q, k, v, do, qpos, **kw):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fk.flash_attention_cuda(*leaves, qpos=qpos, **kw)
        check(out.grad_fn is not None, "flash forward with grad has no "
              "grad_fn")
        out.backward(do)
        return [x.grad for x in leaves]

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for B, T, S, Hq, Hkv, D, window, softcap, kind in BWD_SHAPES:
            Dh, Dv = D if isinstance(D, tuple) else (D, D)
            variant = fk.bwd_variant(dtype, Dh, Dv)
            q, k, v, do, qpos = bwd_inputs(torch, g, dtype, B, T, S, Hq,
                                           Hkv, Dh, Dv, kind)
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

    def training_shape(Hkv: int, arch: str, timings: bool):
        """One layer's backward at 4096 tokens and 32 query heads of 128
        over ``Hkv`` key heads (``arch``'s training microbatch): against
        the plain blockwise backward, two launches bit-identical, SDPA's
        backward computing the same function; timed beside the plain
        backward, SDPA's and the bound, with ``timings`` also split by
        launch and the dK, dV grid printed."""
        cfg_T, Hq, D = TRAIN_SEQ, 32, 128
        q, k, v, do, qpos = bwd_inputs(torch, g, torch.bfloat16, 1, cfg_T,
                                       cfg_T, Hq, Hkv, D, D, "tail")
        out, lse = fk._forward(q, k, v, qpos, BIG_WINDOW, 0.0, None,
                               with_lse=True)

        def kernel():
            return fk.flash_attention_bwd_cuda(do, q, k, v, out, lse,
                                               qpos=qpos, window=BIG_WINDOW)

        got = kernel()
        again = kernel()
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        out_p = blockwise_attention(*plain, qpos=qpos, window=BIG_WINDOW)
        want = torch.autograd.grad(out_p, plain, do, retain_graph=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"two wgmma backward launches differ at {arch}'s training "
              f"shape")
        main_err, rels = 0.0, []
        for name, x, w in zip("qkv", got, want):
            rels.append(fro_rel(torch, x, w))
            main_err = max(main_err,
                           float((x.float() - w.float()).abs().max()))
            check(rels[-1] <= BWD_MAIN_TOL, f"flash backward d{name} at "
                  f"{arch}'s training shape: {rels[-1]} against the plain "
                  f"backward")
        print(f"flash bwd main bf16 q {tuple(q.shape)} k,v {tuple(k.shape)} "
              f"causal ({arch}): fro_rel dq,dk,dv vs plain blockwise = "
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
        print(f"flash bwd vs SDPA backward at {arch}'s training shape: "
              f"fro_rel {lib_err:.3e}")
        check(lib_err <= 2 * BWD_MAIN_TOL, f"SDPA's backward computes "
              f"another function than the kernel at {arch}'s training shape")
        seen = torch.clamp(qpos.long() + 1, 0, cfg_T)
        pairs = int(seen.sum())
        flops = pairs * Hq * (6 * D + 4 * D)
        nbytes = 2 * (4 * cfg_T * Hq * D + 4 * cfg_T * Hkv * D) \
            + 4 * Hq * cfg_T
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        res = dict(
            max_abs_err=main_err, fro_rel_vs_plain=max(rels),
            ms=cuda_ms(torch, kernel, 10),
            plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                out_p, plain, do, retain_graph=True), 3),
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                o_s, (qt, kt, vt), do_t, retain_graph=True), 10),
            shape=[list(q.shape), list(k.shape)])
        print(f"flash bwd at {tuple(q.shape)} x {tuple(k.shape)} ({arch}): "
              f"{flops:.4e} flops (10 D a pair and head), {nbytes:.4e} "
              f"bytes; bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
              f"plain {res['plain_ms']:.4f} ms, SDPA backward "
              f"{res['library_ms']:.4f} ms")
        print(f"  wgmma: {res['ms']:.4f} ms ({flops / res['ms'] / 1e9:.1f} "
              f"TFLOP/s at 10 D, {100 * res['bound_ms'] / res['ms']:.1f}% of "
              f"the bound)")
        if timings:
            split = bwd_split(torch, kernel)
            blocks, steps, longest = bwd_blocks(torch, qpos, cfg_T, Hq)
            res["wgmma_split_ms"] = {k: round(x, 4) for k, x in split.items()}
            print(f"  wgmma per launch (torch.profiler, ms): "
                  + ", ".join(f"{k} {x:.4f}" for k, x in split.items())
                  + f"; dK, dV grid {blocks} blocks, {steps} tile steps, the "
                  f"longest {longest} ({100 * longest * 132 / steps:.1f}% of "
                  f"an SM's even share, from the tile counts)")
        del q, k, v, do, out, lse, got, again, plain, out_p, want
        del qt, kt, vt, o_s, lib
        torch.cuda.empty_cache()
        return res

    # one layer of yi-9b's training microbatch, then of llama-vision's
    # (32/8 heads)
    bwd = dict(name="flash_attn_bwd_hd", route="cuda",
               source="src/repro_torch/csrc/flash_attn_bwd_hd.cu",
               replaces="src/repro/kernels/flash_attention/jnp_impl.py:130",
               **training_shape(4, TRAIN_ARCH, True))
    bwd["at_32_8_heads"] = training_shape(8, VLM_ARCH, False)
    return bwd


def flash_bwd_ffma_phase(torch):
    """(j) The flash backward's ffma pair, every type and head dims the
    forward takes that wgmma does not: at ``FFMA_SHAPES`` one launch
    through autograd (counted as ``ffma``) and two direct launches, all
    three bit-identical, against the plain blockwise backward (fro_rel
    of dq, dk and dv within BWD_MAIN_TOL), and the forward that autograd
    ran (one launch, counted in the variant ``flash_variant`` names:
    ``mma_sync`` in 16-bit types, the reduced launcher's) against the
    plain blockwise forward (FLASH_MAIN_TOL, in float32 FLASH_TOL's);
    then timed at ``FFMA_TIMED``
    beside its operations bound (10 D flops a visible pair and query
    head at 989 TFLOP/s in 16-bit types, 67 in float32), the plain
    backward and SDPA's backward (``enable_gqa``), which must compute
    the same function."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention

    g = torch.Generator(device="cuda").manual_seed(35)

    worst, fwd = 0.0, {}
    for name, B, T, S, Hq, Hkv, Dh, Dv, window, softcap, kind in FFMA_SHAPES:
        dtype = getattr(torch, name)
        check(fk.bwd_variant(dtype, Dh, Dv) == "ffma", f"bwd_variant sends "
              f"{name} Dh {Dh} / Dv {Dv} elsewhere than ffma")
        q, k, v, do, qpos = bwd_inputs(torch, g, dtype, B, T, S, Hq, Hkv,
                                       Dh, Dv, kind)
        kw = dict(window=window, softcap=softcap)
        fwd_v = fk.flash_variant(dtype, Dh, Dv)
        reset_launches()
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_auto = fk.flash_attention_cuda(*leaves, qpos=qpos, **kw)
        o_auto.backward(do)
        auto = [x.grad for x in leaves]
        torch.cuda.synchronize()
        by = read_variants()
        check(by["flash_attn_bwd_hd"] == {"ffma": 1, "wgmma": 0}
              and by["flash_attn_hd"][fwd_v] == 1
              and sum(by["flash_attn_hd"].values()) == 1,
              f"the forward and backward at {name} {Dh} / {Dv} launched "
              f"{by['flash_attn_hd']} and {by['flash_attn_bwd_hd']}, want "
              f"{fwd_v} once and ffma once")
        out, lse = fk._forward(q, k, v, qpos, window, softcap, None,
                               with_lse=True)
        got = fk.flash_attention_bwd_cuda(do, q, k, v, out, lse, qpos=qpos,
                                          **kw)
        again = fk.flash_attention_bwd_cuda(do, q, k, v, out, lse,
                                            qpos=qpos, **kw)
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        o_plain = blockwise_attention(*plain, qpos=qpos, **kw)
        want = torch.autograd.grad(o_plain, plain, do)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(got, again, auto)),
              f"ffma backward launches differ at {name} {Dh} / {Dv}")
        # the forward as autograd ran it, the path's launch
        tol = FLASH_TOL[name] if dtype == torch.float32 else FLASH_MAIN_TOL
        o_err = (o_auto.detach().float() - o_plain.detach().float()).abs()
        bad = int((o_err > tol + tol * o_plain.detach().float().abs())
                  .sum())
        print(f"(j) flash fwd {fwd_v} {name} B,T,S,Hq,Hkv="
              f"{(B, T, S, Hq, Hkv)} Dh {Dh} / Dv {Dv} window={window} "
              f"softcap={softcap} qpos={kind}: max_abs_err="
              f"{float(o_err.max()):.3e} vs plain blockwise, outside "
              f"rtol=atol={tol:g}: {bad}")
        check(bad == 0 and o_auto.dtype == dtype and
              bool(torch.isfinite(o_auto).all()), f"the flash forward "
              f"{fwd_v} at {name} {Dh} / {Dv} differs from plain blockwise")
        fwd[f"{name} {(B, T, S, Hq, Hkv)} {Dh}/{Dv} window={window} "
            f"softcap={softcap} qpos={kind}"] = dict(
                variant=fwd_v, max_abs_err=float(o_err.max()))
        rels, err = [], 0.0
        for x_name, x, w in zip("qkv", got, want):
            check(x.dtype == dtype and bool(torch.isfinite(x).all()),
                  f"ffma backward d{x_name} not finite at {name} {Dh} / {Dv}")
            rels.append(fro_rel(torch, x, w))
            err = max(err, float((x.float() - w.float()).abs().max()))
        print(f"(j) flash bwd ffma {name} B,T,S,Hq,Hkv={(B, T, S, Hq, Hkv)} "
              f"Dh {Dh} / Dv {Dv} window={window} softcap={softcap} "
              f"qpos={kind}: fro_rel dq,dk,dv vs plain blockwise = "
              + ", ".join(f"{e:.3e}" for e in rels)
              + f" (bound {BWD_MAIN_TOL:g}), max_abs_err={err:.3e}; "
              f"autograd and two launches bit-identical")
        check(max(rels) <= BWD_MAIN_TOL, f"ffma backward at {name} {Dh} / "
              f"{Dv}: {rels} against the plain backward")
        worst = max(worst, err)
        del q, k, v, do, out, lse, got, again, auto, plain, want, leaves, \
            o_auto, o_plain, o_err

    def timed(name, B, T, Hq, Hkv, D):
        dtype = getattr(torch, name)
        q, k, v, do, qpos = bwd_inputs(torch, g, dtype, B, T, T, Hq, Hkv,
                                       D, D, "tail")
        out, lse = fk._forward(q, k, v, qpos, None, 0.0, None,
                               with_lse=True)

        def kernel():
            return fk.flash_attention_bwd_cuda(do, q, k, v, out, lse,
                                               qpos=qpos)

        got = kernel()
        plain = [x.clone().requires_grad_() for x in (q, k, v)]
        out_p = blockwise_attention(*plain, qpos=qpos)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        do_t = do.transpose(1, 2)
        lib = torch.autograd.grad(o_s, (qt, kt, vt), do_t, retain_graph=True)
        lib_err = max(fro_rel(torch, a.transpose(1, 2), b)
                      for a, b in zip(lib, got))
        check(lib_err <= 2 * BWD_MAIN_TOL, f"SDPA's backward computes "
              f"another function than the ffma pair at {name} Dh {D}")
        pairs = int(torch.clamp(qpos.long() + 1, 0, T).sum())
        flops = pairs * Hq * 10 * D
        esize = q.element_size()
        nbytes = esize * (4 * B * T * Hq * D + 4 * B * T * Hkv * D) \
            + 4 * B * Hq * T
        peak = FP32_FLOPS_PER_S if dtype == torch.float32 \
            else BF16_FLOPS_PER_S
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        res = dict(
            shape=[B, T, Hq, Hkv, D], dtype=name, max_abs_err=worst,
            ms=cuda_ms(torch, kernel, 3),
            plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                out_p, plain, do, retain_graph=True), 3),
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                o_s, (qt, kt, vt), do_t, retain_graph=True), 10),
            sdpa_fro_rel=lib_err)
        print(f"(j) flash bwd ffma {name} (B, T, Hq/Hkv, D) = ({B}, {T}, "
              f"{Hq}/{Hkv}, {D}) causal: {flops:.4e} flops (10 D a pair and "
              f"head), {nbytes:.4e} bytes; bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), ffma {res['ms']:.4f} ms "
              f"({100 * res['bound_ms'] / res['ms']:.2f}% of the bound), "
              f"plain {res['plain_ms']:.4f} ms, SDPA backward "
              f"{res['library_ms']:.4f} ms (fro_rel to the kernel "
              f"{lib_err:.3e}) on {card_line()}")
        del q, k, v, do, out, lse, got, plain, out_p, qt, kt, vt, o_s, lib
        torch.cuda.empty_cache()
        return res

    res = [timed(*shape) for shape in FFMA_TIMED]
    return dict(name="flash_attn_bwd_hd ffma", route="cuda",
                source="src/repro_torch/csrc/flash_attn_bwd_hd.cu",
                replaces="src/repro/kernels/flash_attention/jnp_impl.py:130",
                **res[0], at_dh96_32_8_heads=res[1], forward=fwd)


def reduced_launcher_phase(torch):
    """(j) The training launcher at its default, reduced configs and
    ``REDUCED_SEQ`` tokens, every architecture (``train_phase(...,
    reduced=True)``: the gradient gate against the plain versions, the
    first step's loss and gradient norm against the port's CPU step,
    ``REDUCED_STEPS`` steps), xlstm's gate in ``XLSTM_GATE_DTYPE`` as at full width.
    Every self-attention family's backward runs only the ffma pair, at
    least once.  Returns {arch: (launches, variants, stats)}."""
    from repro_torch.configs import ALL_ARCHS, get_config

    out = {}
    for arch in ALL_ARCHS:
        cfg = get_config(arch).reduced()
        out[arch] = train_phase(
            torch, train_cut(arch), REDUCED_STEPS, seq=REDUCED_SEQ,
            batch=REDUCED_BATCH, micro=1, reduced=True,
            gate_dtype=XLSTM_GATE_DTYPE if cfg.family == "ssm" else None)
        launches, variants, _ = out[arch]
        bwd = variants["flash_attn_bwd_hd"]
        if cfg.family != "ssm":
            check(bwd["ffma"] > 0 and bwd["wgmma"] == 0, f"(j) {arch}: the "
                  f"reduced launcher's backward launched {bwd}, want ffma "
                  f"alone")
        torch.cuda.empty_cache()
    return out


def flash_bwd_256_phase(torch, ptxas):
    """The flash backward at Dh 256 at the two training shapes, one
    microbatch of 4096 tokens: gemma2's (16 query heads over 8, softcap
    50, causal as its global layers, and with a window of 1000 that
    binds) and recurrentgemma's (10 over 1, window 2048, which binds):
    against the plain blockwise backward within BWD_MAIN_TOL, two
    launches bit-identical, each timed beside its operations bound, the
    plain backward and compiled flex_attention's backward (the softcap
    as score_mod, the window as block mask), its time split by launch
    (the one dK/dV pass, dQ, the pre-pass and the GQA sum) and its
    grid.  Prints the ptxas lines of every Dh-256 backward kernel
    (``ptxas``: flash_attn_bwd_hd's (kernel, report) pairs).  Returns
    the gemma2 shape's entry, the recurrentgemma shape's under
    "recurrentgemma_shape"."""
    import re

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.models.lm import BIG_WINDOW

    reports = [(k, r) for k, r in ptxas
               if re.search(r"(\(int\)|[<, ])256[,>]", k)]
    for kernel, report in reports:
        print(f"flash bwd Dh 256 ptxas: {kernel}: {report}")
    check(len(reports) == 14, f"{len(reports)} Dh-256 backward kernels in "
          f"the build log, want 14 (8 wgmma: the dK/dV pass and dQ for two "
          f"types with and without a softcap; 6 ffma: its pair in three "
          f"types at widths up to 256)")
    check(fk.bwd_variant(torch.bfloat16, 256, 256) == "wgmma",
          "the Dh-256 backward does not take wgmma in bf16")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(28)
    T = TRAIN_SEQ
    qpos = torch.arange(T, dtype=torch.int32, device=dev)[None]
    g2, rg = get_config(GEMMA2_ARCH), get_config(RG_ARCH)
    out = {}
    for label, cfg, windows, cap in (
            (GEMMA2_ARCH, g2, (BIG_WINDOW, 1000), g2.attn_softcap),
            (RG_ARCH, rg, (rg.window,), 0.0)):
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        check(D == 256, f"{label}'s head dim is {D}, not 256")
        q, k, v, do = (torch.randn(sh, generator=g, device=dev).bfloat16()
                       for sh in ((1, T, Hq, D), (1, T, Hkv, D),
                                  (1, T, Hkv, D), (1, T, Hq, D)))
        rels, err = [], 0.0
        for w in windows:
            o, lse = fk._forward(q, k, v, qpos, w, cap, None, with_lse=True)

            def kernel(o=o, lse=lse, w=w):
                return fk.flash_attention_bwd_cuda(do, q, k, v, o, lse,
                                                   qpos=qpos, window=w,
                                                   softcap=cap)
            n0 = fk.flash_attention_bwd_cuda.by_variant["wgmma"]
            got, again = kernel(), kernel()
            plain = [x.clone().requires_grad_() for x in (q, k, v)]
            out_p = blockwise_attention(*plain, qpos=qpos, window=w,
                                        softcap=cap)
            want = torch.autograd.grad(out_p, plain, do, retain_graph=True)
            torch.cuda.synchronize()
            check(fk.flash_attention_bwd_cuda.by_variant["wgmma"] == n0 + 2,
                  "the Dh-256 backward did not launch wgmma")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"two Dh-256 backward launches differ at {label}'s shape "
                  f"window {w}")
            r = [fro_rel(torch, x, y) for x, y in zip(got, want)]
            e = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(got, want))
            print(f"flash bwd Dh 256 {label} q {tuple(q.shape)} k,v "
                  f"{tuple(k.shape)} window {w} softcap {cap:g}: fro_rel "
                  f"dq,dk,dv vs plain blockwise = "
                  + ", ".join(f"{x:.3e}" for x in r)
                  + f" (bound {BWD_MAIN_TOL:g}), max_abs_err={e:.3e}, two "
                  f"launches bit-identical")
            check(max(r) <= BWD_MAIN_TOL, f"the Dh-256 backward at {label}'s "
                  f"shape window {w}: {r} against the plain backward")
            if w == windows[0]:      # the training path's window: timed
                rels, err = r, e
                timed = (kernel, plain, out_p, w)
        kernel, plain, out_p, w = timed
        # the library's one call: compiled flex_attention's backward
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        o_f = flex_call(torch, qpos, T, w, cap)(qt, kt, vt)
        do_t = do.transpose(1, 2).contiguous()
        lib = torch.autograd.grad(o_f, (qt, kt, vt), do_t, retain_graph=True)
        got = kernel()
        lib_err = max(fro_rel(torch, a.transpose(1, 2), b)
                      for a, b in zip(lib, got))
        print(f"flash bwd Dh 256 vs flex_attention's backward at {label}'s "
              f"shape: fro_rel {lib_err:.3e}")
        check(lib_err <= 2 * BWD_MAIN_TOL, "flex_attention's backward "
              f"computes another function than the kernel at {label}'s")
        hi = torch.clamp(qpos.long() + 1, 0, T)
        lo = torch.clamp(qpos.long() + 1 - w, 0, T)
        pairs = int((hi - lo).sum())
        flops = pairs * Hq * 10 * D
        nbytes = 2 * (4 * T * Hq * D + 4 * T * Hkv * D) + 4 * Hq * T
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        entry = dict(
            name="flash_attn_bwd_hd", variant="wgmma", head_dim=D,
            route="cuda", source="src/repro_torch/csrc/flash_attn_bwd_hd.cu",
            replaces="src/repro/kernels/flash_attention/jnp_impl.py:130",
            max_abs_err=err, fro_rel_dq_dk_dv=rels,
            ms=cuda_ms(torch, kernel, 10),
            plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                out_p, plain, do, retain_graph=True), 3),
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                o_f, (qt, kt, vt), do_t, retain_graph=True), 10),
            wgmma_split_ms={k: round(x, 4)
                            for k, x in bwd_split(torch, kernel).items()},
            shape=[list(q.shape), list(k.shape)], window=w, softcap=cap,
            visible_pairs=pairs)
        blocks, steps, longest = bwd_blocks(torch, qpos, T, Hq, keys=64,
                                            window=w)
        entry["grid"] = dict(dkdv_blocks=blocks, dkdv_tile_steps=steps,
                             dkdv_longest=longest,
                             dq_blocks=Hq * -(-T // 128))
        print(f"flash bwd Dh 256 at {label}'s training shape: {flops:.4e} "
              f"flops (10 D a pair and head), {nbytes:.4e} bytes; bound "
              f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), wgmma "
              f"{entry['ms']:.4f} ms ({flops / entry['ms'] / 1e9:.1f} TFLOP/s,"
              f" {100 * entry['bound_ms'] / entry['ms']:.1f}% of the bound), "
              f"plain {entry['plain_ms']:.4f} ms, flex_attention backward "
              f"{entry['library_ms']:.4f} ms; per launch (torch.profiler, ms) "
              + ", ".join(f"{k} {x:.4f}"
                          for k, x in entry["wgmma_split_ms"].items())
              + f"; grid: one dK/dV pass of {blocks} blocks of 64 keys "
              f"({steps} tile steps, the longest {longest}), dQ "
              f"{entry['grid']['dq_blocks']} blocks of 128 rows")
        check(set(entry["wgmma_split_ms"]) <= {"pre-pass", "dK/dV", "dQ",
                                                "GQA sum"},
              f"the Dh-256 backward ran {sorted(entry['wgmma_split_ms'])}, "
              f"not one dK/dV pass")
        out[label] = entry
        del q, k, v, do, o, lse, got, again, plain, out_p, want, lib, o_f
        del qt, kt, vt, do_t, timed, kernel
        torch.cuda.empty_cache()
    entry = out[GEMMA2_ARCH]
    entry["recurrentgemma_shape"] = out[RG_ARCH]
    entry["ptxas"] = dict(reports)
    return entry


def flash_bwd_mla_phase(torch, ptxas):
    """The flash backward at Dh 192 / Dv 128 at deepseek-v3's training
    microbatch, as MLA's naive form hands it with grad: q and k (1, 4096,
    128, 192), the RoPE columns joined (the key's shared by every head),
    v and dO (1, 4096, 128, 128), causal, scale 1/sqrt(192).  Against the
    plain blockwise backward within BWD_MAIN_TOL and against float64
    dense autograd on heads 0-7 (each head's gradients depend on its own
    operands alone) within BWD_FRO_TOL; two launches bit-identical;
    timed (and split by launch) beside its operations bound, the plain
    backward and SDPA's backward on the same operands (memory-efficient
    backend, is_causal); each pass's TFLOP/s (the dK/dV pass 4 (Dh + Dv)
    flops a visible pair and head, dQ 2 (2 Dh + Dv)) and the dK/dV pass's
    two probes (its elementwise math left out, its copies left out; not
    the function), from CUDA events by difference of the probe entry's
    launches.  Prints the ptxas lines of its kernels (``ptxas``:
    flash_attn_bwd_hd's (kernel, report) pairs).  Returns its entry."""
    import re

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.ref import join_rope

    reports = [(k, r) for k, r in ptxas
               if re.search(r"(\(int\)|[<, ])192, (\(int\))?128[,>]", k)]
    for kernel, report in reports:
        print(f"flash bwd Dh 192 / Dv 128 ptxas: {kernel}: {report}")
    check(len(reports) == 10, f"{len(reports)} Dh 192 / Dv 128 backward "
          f"kernels in the build log, want 10 (the dK/dV pass and dQ for two "
          f"types with and without a softcap, and the pass's two probes)")
    check(fk.bwd_variant(torch.bfloat16, 192, 128) == "wgmma",
          "the Dh 192 / Dv 128 backward does not take wgmma in bf16")
    cfg = get_config(DSV3_ARCH)
    H, m = cfg.n_heads, cfg.mla
    Dn, Dr, Dv = m.d_nope, m.d_rope, m.d_v
    Dh = Dn + Dr
    T = TRAIN_SEQ
    g = torch.Generator(device="cuda").manual_seed(30)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    # the naive form's operands: the RoPE key one a position, expanded
    # and joined to every head's k
    q, k = join_rope(randn(1, T, H, Dn), randn(1, T, H, Dn),
                     randn(1, T, H, Dr), randn(1, T, 1, Dr))
    v, do = randn(1, T, H, Dv), randn(1, T, H, Dv)
    qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    scale = 1.0 / Dh ** 0.5
    out, lse = fk._forward(q, k, v, qpos, None, 0.0, scale, with_lse=True)

    def kernel():
        return fk.flash_attention_bwd_cuda(do, q, k, v, out, lse, qpos=qpos,
                                           scale=scale)
    n0 = fk.flash_attention_bwd_cuda.by_variant["wgmma"]
    got, again = kernel(), kernel()
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    out_p = blockwise_attention(*plain, qpos=qpos, window=None, scale=scale)
    want = torch.autograd.grad(out_p, plain, do, retain_graph=True)
    torch.cuda.synchronize()
    check(fk.flash_attention_bwd_cuda.by_variant["wgmma"] == n0 + 2,
          "the Dh 192 / Dv 128 backward did not launch wgmma")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "two Dh 192 / Dv 128 backward launches differ at deepseek-v3's "
          "training shape")
    check([tuple(x.shape) for x in got] == [q.shape, k.shape, v.shape],
          "the Dh 192 / Dv 128 backward's gradients have other shapes")
    rels = [fro_rel(torch, x, y) for x, y in zip(got, want)]
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    # float64 on heads 0-7 (17 GB of scores at all 128)
    hs = slice(0, 8)
    leaves = [x[:, :, hs].double().requires_grad_() for x in (q, k, v)]
    dense64(torch, *leaves, qpos).backward(do[:, :, hs].double())
    rels64 = [fro_rel(torch, x[:, :, hs], w.grad)
              for x, w in zip(got, leaves)]
    del leaves
    print(f"flash bwd Dh {Dh} / Dv {Dv} {DSV3_ARCH} q, k {tuple(q.shape)} "
          f"(RoPE joined), v {tuple(v.shape)} causal: fro_rel dq,dk,dv vs "
          f"plain blockwise = " + ", ".join(f"{x:.3e}" for x in rels)
          + f" (bound {BWD_MAIN_TOL:g}), vs float64 on heads 0-7 = "
          + ", ".join(f"{x:.3e}" for x in rels64)
          + f" (bound {BWD_FRO_TOL:g}), max_abs_err={err:.3e}, two launches "
          f"bit-identical")
    check(max(rels) <= BWD_MAIN_TOL, f"the Dh 192 / Dv 128 backward: {rels} "
          f"against the plain backward")
    check(max(rels64) <= BWD_FRO_TOL, f"the Dh 192 / Dv 128 backward: "
          f"{rels64} against float64")
    # the library's one call: SDPA's backward, memory-efficient backend
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    do_t = do.transpose(1, 2)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             scale=scale)

    def library():
        return torch.autograd.grad(o_s, (qt, kt, vt), do_t,
                                   retain_graph=True)
    lib = library()
    lib_err = max(fro_rel(torch, a.transpose(1, 2), b)
                  for a, b in zip(lib, got))
    print(f"flash bwd Dh {Dh} / Dv {Dv} vs SDPA's backward (memory-efficient"
          f" backend, is_causal): fro_rel {lib_err:.3e}")
    check(lib_err <= 2 * BWD_MAIN_TOL, "SDPA's backward computes another "
          "function than the kernel at deepseek-v3's training shape")
    pairs = T * (T + 1) // 2
    flops = pairs * H * 2 * (3 * Dh + 2 * Dv)
    nbytes = 2 * (3 * T * H * Dh + 4 * T * H * Dv) + 4 * H * T
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    entry = dict(
        name="flash_attn_bwd_hd", variant="wgmma", head_dim=[Dh, Dv],
        route="cuda", source="src/repro_torch/csrc/flash_attn_bwd_hd.cu",
        replaces="src/repro/kernels/flash_attention/jnp_impl.py:130",
        max_abs_err=err, fro_rel_dq_dk_dv=rels,
        fro_rel_f64_heads_0_7=rels64,
        ms=cuda_ms(torch, kernel, 10),
        plain_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            out_p, plain, do, retain_graph=True), 2),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=cuda_ms(torch, library, 10),
        library="SDPA backward (memory-efficient backend, is_causal)",
        wgmma_split_ms={k: round(x, 4) for k, x in bwd_split(
            torch, kernel, want=("pre-pass", "dK/dV", "dQ")).items()},
        shape=[list(q.shape), list(k.shape), list(v.shape)],
        visible_pairs=pairs, ptxas=dict(reports))
    blocks, steps, longest = bwd_blocks(torch, qpos, T, H, keys=64)
    entry["grid"] = dict(dkdv_blocks=blocks, dkdv_tile_steps=steps,
                         dkdv_longest=longest, dq_blocks=H * -(-T // 128))
    # the work each pass does: the dK/dV pass 4 (Dh + Dv) flops a visible
    # pair and head, dQ 2 (2 Dh + Dv) (S and dP again), 2 (4 Dh + 3 Dv)
    # in all against the bound's 2 (3 Dh + 2 Dv).  Each pass and probe
    # timed by CUDA events, by difference: the probe entry's pre-pass
    # alone, the pre-pass and the dK/dV pass alone, the pre-pass and each
    # probe; dQ is the whole backward less the pre-pass and the dK/dV
    # pass (Hq = Hkv: no GQA sum); every call queued before the first
    # runs, since the pre-pass alone takes less device time than host
    # time.  torch.profiler's split above may keep none of a window's
    # kernels; these times do not depend on it.
    check(q.shape[2] == k.shape[2], "deepseek-v3's backward has a GQA sum")

    def alone(name):
        return cuda_ms(torch, lambda: fk.flash_attention_bwd_probe(
            do, q, k, v, out, lse, qpos=qpos, scale=scale, probe=name), 10,
            queued=True)
    pre, upto, whole = (alone("pre-pass"), alone("pre-pass and dK/dV"),
                        cuda_ms(torch, kernel, 10, queued=True))
    probes = {name: alone(name) - pre for name in fk.BWD_PROBES}
    rates = {}
    for name, ms, per_pair in (("dK/dV", upto - pre, 4 * (Dh + Dv)),
                               ("dQ", whole - upto, 2 * (2 * Dh + Dv))):
        tf = pairs * H * per_pair / ms / 1e9 if ms > 0 else float("nan")
        rates[name] = dict(ms=ms, tflops=tf,
                           peak_share=tf * 1e12 / BF16_FLOPS_PER_S)
    entry["pass_rates"] = rates
    entry["prepass_ms"] = pre
    entry["dkdv_probes_ms"] = probes
    print(f"flash bwd Dh {Dh} / Dv {Dv} passes (CUDA events, by difference;"
          f" pre-pass {pre:.4f} ms): "
          + "; ".join(f"{k} {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, "
                      f"{100 * r['peak_share']:.1f}% of the 989 TFLOP/s "
                      f"peak" for k, r in rates.items())
          + "; the dK/dV pass's probes (not the function): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in probes.items()))
    check(all(r["ms"] > 0 for r in rates.values()) and all(
        v > 0 for v in probes.values()),
        f"the Dh 192 / Dv 128 passes or probes timed at no time: {rates}, "
        f"{probes}")
    print(f"flash bwd Dh {Dh} / Dv {Dv} at {DSV3_ARCH}'s training shape: "
          f"{flops:.4e} flops (the bound's 2 (3 Dh + 2 Dv) a pair and head; "
          f"the kernel does 2 (4 Dh + 3 Dv) = {2 * (4 * Dh + 3 * Dv)}), "
          f"{nbytes:.4e} bytes; bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), wgmma {entry['ms']:.4f} ms "
          f"({flops / entry['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * entry['bound_ms'] / entry['ms']:.1f}% of the bound), plain "
          f"{entry['plain_ms']:.4f} ms, SDPA backward "
          f"{entry['library_ms']:.4f} ms; per launch (torch.profiler, ms) "
          + ", ".join(f"{k} {x:.4f}"
                      for k, x in entry["wgmma_split_ms"].items())
          + f"; grid: one dK/dV pass of {blocks} blocks of 64 keys ({steps} "
          f"tile steps, the longest {longest}), dQ "
          f"{entry['grid']['dq_blocks']} blocks of 128 rows")
    check(set(entry["wgmma_split_ms"]) <= {"pre-pass", "dK/dV", "dQ"},
          f"the Dh 192 / Dv 128 backward ran "
          f"{sorted(entry['wgmma_split_ms'])}, not one dK/dV pass and no "
          f"GQA sum")
    del q, k, v, do, out, lse, got, again, plain, out_p, want, lib, o_s
    del qt, kt, vt, do_t
    torch.cuda.empty_cache()
    return entry


def slstm_bwd_phase(torch):
    """The sLSTM recurrence's backward kernel at xlstm-125m's training
    microbatch (1, 4096, 768) and at the pool's prefill shape (4, 2048,
    768), bf16 pre_x, from a state and without, through autograd
    (SlstmScanFunction) with the final state's gradients given: each
    gradient (d pre_x, dr, and the state's dc, dn, dh, dm) within
    SLSTM_TOL of its largest magnitude (SLSTM_BWD_STATE_TOL at the
    training shape from a state; d pre_x, bf16, one bf16 ulp of its own
    more) against float64 autograd through the recurrence and
    against the plain reverse loop; a forward and a backward launch a
    call; two backward launches bit-identical.  Then the backward alone
    timed at the training shape (CUDA events) beside its bound and the
    plain loop, in us a step, and its two probes (the step loop with the
    exchange alone; the product and gate math alone, no exchange; not
    the function) in us a step.  Returns its entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.slstm_scan.kernel import (
        BWD_PROBES, VARIANTS, slstm_scan_bwd_cuda, slstm_scan_bwd_probe,
        slstm_scan_cuda, slstm_scan_kernel)
    from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_ref,
                                                    slstm_scan_ref)

    cfg = get_config(XLSTM_ARCH)
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    g = torch.Generator(device="cuda").manual_seed(31)
    r = torch.randn((H, Dh, 4 * Dh), generator=g, device="cuda") \
        * (0.5 / Dh ** 0.5)
    errs, timed = {}, None
    for B, T in ((1, TRAIN_SEQ), (SERVE_SLOTS, PROMPTS[0])):
        for with_state in (True, False):
            pre_x = torch.randn((B, T, 4 * D), generator=g,
                                device="cuda").bfloat16()
            st = None
            if with_state:
                n = torch.rand((B, D), generator=g, device="cuda") * 4 + 0.1
                st = (n * (torch.rand((B, D), generator=g, device="cuda")
                           * 2 - 1), n,
                      torch.rand((B, D), generator=g, device="cuda") * 2 - 1,
                      torch.randn((B, D), generator=g, device="cuda") * 3)
            dhs = torch.randn((B, T, D), generator=g, device="cuda")
            dfin = [torch.randn((B, D), generator=g, device="cuda")
                    for _ in range(4)]

            def grads(scan, f64=False):
                """The gradients of a loss on hs and the final state,
                every input a leaf (in float64 with ``f64``)."""
                leaves = [(x.double() if f64 else x).detach().clone()
                          .requires_grad_() for x in (pre_x, r) + (st or ())]
                hs, fin = scan(leaves[0], leaves[1],
                               tuple(leaves[2:]) if st else None)
                loss = (hs * dhs.to(hs.dtype)).sum() + sum(
                    (a * b.to(a.dtype)).sum() for a, b in zip(fin, dfin))
                return torch.autograd.grad(loss, leaves)
            n0, b0 = slstm_scan_cuda.launches, slstm_scan_bwd_cuda.launches
            got = grads(slstm_scan_cuda)
            again = grads(slstm_scan_cuda)
            torch.cuda.synchronize()
            check((slstm_scan_cuda.launches - n0,
                   slstm_scan_bwd_cuda.launches - b0) == (2, 2),
                  "a call of the sLSTM kernel with grad did not add one "
                  "forward and one backward launch")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  "two launches of the sLSTM backward differ")
            want = grads(slstm_scan_ref, f64=True)
            dpre, dr, dst = slstm_scan_bwd_ref(dhs, pre_x, r, st, dfin)
            plain = [dpre, dr] + (list(dst) if st else [])
            names = ["dpre_x", "dr"] + (["dc0", "dn0", "dh0", "dm0"]
                                        if st else [])
            tol = SLSTM_BWD_STATE_TOL if st and B == 1 else SLSTM_TOL
            row, bad = [], []
            for name, a, p, w in zip(names, got, plain, want):
                top = float(w.abs().max())
                slack = w.abs() * 2.0 ** -7 if a.dtype == torch.bfloat16 \
                    else 0.0
                e64 = (a.double() - w).abs()
                ep = (a.double() - p.double()).abs()
                # the float32 loop's own distance from float64
                ep64 = float((p.double() - w).abs().max()) / top
                if not (bool((e64 <= tol * top + slack).all())
                        and bool((ep <= tol * top + slack).all())):
                    bad.append(name)
                errs[name] = max(errs.get(name, 0.0), float(ep.max()))
                row.append(f"{name} {float(e64.max()) / top:.2e}/"
                           f"{float(ep.max()) / top:.2e}/{ep64:.2e}")
            print(f"slstm_scan bwd {(B, T, D)} bf16"
                  f"{' from a state' if st else ''}: max|err| / max|grad| "
                  f"of the kernel against float64 / against the plain "
                  f"reverse loop / the plain loop's against float64: "
                  + ", ".join(row) + f" (bound {tol:g}, bf16 d pre_x + one "
                  f"ulp); two launches bit-identical")
            check(not bad, f"the sLSTM backward's {bad} at {(B, T, D)} "
                  f"exceed the bound")
            if B == 1 and not with_state:
                timed = (pre_x, dhs)
            del pre_x, st, dhs, dfin, got, again, want, plain
            torch.cuda.empty_cache()
    pre_x, dhs = timed
    B, T, _ = pre_x.shape
    f32 = dict(dtype=torch.float32, device="cuda")
    saved = (torch.empty((B, T, 4 * D), **f32),
             *(torch.empty((B, T, D), **f32) for _ in range(3)))
    slstm_scan_kernel(pre_x, r, None, VARIANTS.index("cluster"), saved)

    def kernel():
        return slstm_scan_bwd_cuda(dhs, r, saved)
    # dh's product: 2 D 4Dh operations a step and row; the bytes: dhs, pre
    # and c, n, m read once, dpre written once, r read once
    ops = 2 * B * T * D * 4 * Dh
    nbytes = 4 * B * T * (D + 4 * D + 3 * D + 4 * D) + 4 * r.numel()
    t_ops, t_bytes = ops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    entry = dict(
        name="slstm_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/slstm_scan.cu",
        replaces="src/repro/models/xlstm.py:217",
        max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
        ms=cuda_ms(torch, kernel, 10),
        # one call, not warmed up: the correctness checks above ran it
        plain_ms=cuda_ms(torch, lambda: slstm_scan_bwd_ref(dhs, pre_x, r),
                         1, warm=False),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bytes_bound_ms=1e3 * t_bytes, library_ms=None, shape=[B, T, D])
    entry["us_per_step"] = 1e3 * entry["ms"] / T
    entry["probes_us_per_step"] = {
        name: 1e3 * cuda_ms(torch, lambda: slstm_scan_bwd_probe(
            dhs, r, saved, name), 10) / T for name in BWD_PROBES}
    print(f"slstm_scan bwd at {entry['shape']} (bf16 pre_x): "
          f"{entry['ms']:.4f} ms ({entry['us_per_step']:.3f} us a step; "
          f"probes, not the function: " + ", ".join(
              f"{k} alone {v:.3f}" for k, v in
              entry["probes_us_per_step"].items()) + " us a step), "
          f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}: {ops:.4e} "
          f"operations over the float32 rate; bytes "
          f"{entry['bytes_bound_ms']:.4f} ms), plain reverse loop "
          f"{entry['plain_ms']:.4f} ms (the forward again included); no "
          f"PyTorch call computes the recurrence's gradient")
    del timed, pre_x, dhs, saved
    torch.cuda.empty_cache()
    return entry


def scan_f64(torch, x, ga, gi, lam, h0):
    """The RG-LRU recurrence of ``rglru_scan_ref`` in float64."""
    x, ga, gi, lam = (t.double() for t in (x, ga, gi, lam))
    log_a = -8.0 * torch.nn.functional.softplus(lam) * torch.sigmoid(ga)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12)) \
        * torch.sigmoid(gi) * x
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.double()
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def scan_phase(torch):
    """The RG-LRU scan kernel's two variants against float64 and the
    plain float32 loop at recurrentgemma's shapes in bf16, as the engine
    calls them: a prefill of the whole pool (SERVE_SLOTS x PROMPTS[0] x
    lru_width) from the slots' states h0, which are not 0 on a reused or
    live slot, and without a state, as a forward calls it, on both
    variants; a decode step (T = 1 from h0) on ``sequential``, the one
    the wrapper picks for it.  lam spreads over decays from a near 1 to
    the init's a near 0.  Each call adds one launch, to its variant.
    Checks the chunked kernel's branch-free reciprocal and square root
    against IEEE on every float32 it can meet.  Times both variants back
    to back at the prefill shape from h0 (CUDA events) beside the plain
    loop and the bound (each input read once, h written once), and the
    decode call both back to back (CUDA events) and as device time
    (torch.profiler)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan.kernel import (
        CHUNK_CLUSTER, rglru_scan_cuda, scan_variant)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    W = get_config(RG_ARCH).rg.lru_width
    B, T = SERVE_SLOTS, PROMPTS[0]
    check(scan_variant(B, T, W) == "chunked"
          and scan_variant(B, 1, W) == "sequential",
          "the scan's variant choice does not send prefills to chunked "
          "and decode steps to sequential")
    lib = build.load("rglru_scan")
    bad = torch.zeros(2, dtype=torch.int64, device="cuda")
    check(lib.rglru_scan_math_check(
        ctypes.c_void_p(bad.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) == 0,
        "rglru_scan_math_check did not launch")
    n_rcp, n_sqrt = (int(n) for n in bad.tolist())
    print(f"rglru_scan chunked math: the branch-free reciprocal differs "
          f"from IEEE division on {n_rcp} floats of [1, 2^126], the square "
          f"root from sqrtf on {n_sqrt} of [1e-12, 1]")
    check(n_rcp == 0 and n_sqrt == 0,
          "the chunked scan's reciprocal or square root is not IEEE's")
    clusters = ctypes.c_int(0)
    check(lib.rglru_scan_max_clusters(ctypes.byref(clusters)) == 0,
          "cudaOccupancyMaxActiveClusters failed")
    need = B * -(-W // 64)              # a cluster per 64 channels in bf16
    print(f"rglru_scan chunked grid at the prefill: {need} clusters of "
          f"{CHUNK_CLUSTER} blocks; the card holds {clusters.value} at once")
    check(clusters.value >= need, "the chunked scan's prefill grid no "
          "longer fits on the card in one wave")
    g = torch.Generator(device="cuda").manual_seed(0)
    lam = torch.rand((W,), generator=g, device="cuda") * 10 - 6
    errs, cases = {}, {}
    for name, t, with_h0, variants in (
            ("prefill", T, True, ("chunked", "sequential")),
            ("decode", 1, True, ("sequential",)),
            ("prefill without state", T, False, ("chunked", "sequential"))):
        x, ga, gi = (torch.randn((B, t, W), generator=g, device="cuda")
                     .bfloat16() for _ in range(3))
        h0 = torch.randn((B, W), generator=g, device="cuda") \
            if with_h0 else None
        plain = rglru_scan_ref(x, ga, gi, lam, h0)
        want = scan_f64(torch, x, ga, gi, lam, h0)
        top = float(want.abs().max())
        for v in variants:
            n0, v0 = rglru_scan_cuda.launches, rglru_scan_cuda.by_variant[v]
            got = rglru_scan_cuda(x, ga, gi, lam, h0, variant=v)
            check(rglru_scan_cuda.launches - n0 == 1
                  and rglru_scan_cuda.by_variant[v] - v0 == 1,
                  f"rglru_scan {name} {v}: one call did not add one launch "
                  f"to its variant")
            torch.cuda.synchronize()
            e64 = float((got.double() - want).abs().max()) / top
            eplain = float((got - plain).abs().max()) / top
            errs[(name, v)] = float((got - plain).abs().max())
            print(f"rglru_scan {v} {name} {(B, t, W)} bf16"
                  f"{' from h0' if with_h0 else ''}: max|err| / max|h| "
                  f"against float64 {e64:.3e}, against the plain loop "
                  f"{eplain:.3e} (bound {SCAN_TOL:g})")
            check(e64 <= SCAN_TOL and eplain <= SCAN_TOL,
                  f"rglru_scan {v} {name}: {e64}, {eplain} > {SCAN_TOL}")
        cases[name] = (x, ga, gi, h0)
    x, ga, gi, h0 = cases["prefill"]
    x1, ga1, gi1, h01 = cases["decode"]
    # three bf16 inputs and h0 read once, h written once in float32
    nbytes = B * T * W * (3 * 2 + 4) + B * W * 4

    def call(v):
        return lambda: rglru_scan_cuda(x, ga, gi, lam, h0, variant=v)
    ms = {v: cuda_ms(torch, call(v), 20) for v in ("chunked", "sequential")}
    ms["chunked again"] = cuda_ms(torch, call("chunked"), 20)
    decode = lambda: rglru_scan_cuda(x1, ga1, gi1, lam, h01)  # noqa: E731
    entry = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/models/rglru.py:73",
        max_abs_err=max(errs[("prefill", "chunked")],
                        errs[("prefill without state", "chunked")]),
        ms=ms["chunked"],
        plain_ms=cuda_ms(torch, lambda: rglru_scan_ref(x, ga, gi, lam, h0),
                         2),
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=None,
        ms_by_variant={"chunked": ms["chunked"],
                       "sequential": ms["sequential"],
                       "chunked again": ms["chunked again"]},
        gb_per_s=nbytes / ms["chunked"] / 1e6,
        decode_ms=cuda_ms(torch, decode, 50),
        decode_max_abs_err=errs[("decode", "sequential")],
        shape=[B, T, W])
    entry["decode_device_ms"], seen, win = scan_device_ms(torch, decode, 50)
    dev = entry["decode_device_ms"]
    print(f"rglru_scan at {entry['shape']} bf16 from h0: chunked "
          f"{ms['chunked']:.4f} ms ({entry['gb_per_s']:.1f} GB/s; "
          f"{ms['chunked again']:.4f} again), sequential "
          f"{ms['sequential']:.4f} ms, plain loop {entry['plain_ms']:.4f} "
          f"ms, bound {entry['bound_ms']:.4f} ms (bytes); a decode step "
          f"{(B, 1, W)} on sequential {entry['decode_ms']:.4f} ms a call "
          f"back to back (CUDA events), "
          f"{'not measured' if dev is None else f'{dev:.4f} ms'} of device "
          f"time (torch.profiler, {seen} of 50 launches seen in window {win})")
    del cases, x, ga, gi, h0, x1, ga1, gi1, h01
    torch.cuda.empty_cache()
    return entry


def scan_bwd_close(torch, got, want, top: float) -> float:
    """The largest |got - want| over ``top``, checked against SCAN_TOL
    of ``top`` plus, for a bf16 gradient, one bf16 ulp of the element
    (2**-7 relative: the kernel writes dx, dgate_a and dgate_i in the
    inputs' type, and two float32 values a hair apart can round to
    neighbouring bf16 values)."""
    err = (got.double() - want.double()).abs()
    slack = want.double().abs() * 2.0 ** -7 if got.dtype == torch.bfloat16 \
        else 0.0
    check(bool((err <= SCAN_TOL * top + slack).all()), "the scan's backward "
          f"off by {float(err.max())} of a largest {top}")
    return float(err.max()) / top


def scan_bwd_phase(torch):
    """The RG-LRU scan's backward kernel against float64 autograd
    through the scan and against the plain backward, at SCAN_BWD_SHAPES
    in bf16 (lam spread over decays from a = 1, where the clamp binds,
    to the init's a near 0), from a state and without: each gradient
    within SCAN_TOL of its largest magnitude (bf16 ones also one bf16
    ulp of their own); two launches bit-identical, dlam included;
    then timed at the training microbatch's shape beside its byte bound
    and the plain backward, with its grid and the clusters the card
    holds at once.  Returns its entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan.kernel import (
        BWD_CLUSTER, BWD_STRIP, rglru_scan_bwd_cuda, rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    W = get_config(RG_ARCH).rg.lru_width
    g = torch.Generator(device="cuda").manual_seed(28)
    lam = torch.rand((W,), generator=g, device="cuda") * 10 - 6
    lam[:CLAMPED] = -25.0                      # a = 1: the clamp binds
    errs, timed = {}, None
    for B, T, W_ in SCAN_BWD_SHAPES:
        check(W_ == W, f"SCAN_BWD_SHAPES' width {W_} is not {RG_ARCH}'s {W}")
        for with_h0 in (True, False):
            x, ga, gi = (torch.randn((B, T, W), generator=g, device="cuda")
                         .bfloat16() for _ in range(3))
            h0 = torch.randn((B, W), generator=g, device="cuda") \
                if with_h0 else None
            dh = torch.randn((B, T, W), generator=g, device="cuda")
            h = rglru_scan_cuda(x, ga, gi, lam, h0)
            n0 = rglru_scan_bwd_cuda.launches
            got = rglru_scan_bwd_cuda(dh, x, ga, gi, lam, h0, h)
            again = rglru_scan_bwd_cuda(dh, x, ga, gi, lam, h0, h)
            torch.cuda.synchronize()
            check(rglru_scan_bwd_cuda.launches == n0 + 2, "a call of the "
                  "scan's backward did not add one launch")
            check(all(a is b or torch.equal(a, b)
                      for a, b in zip(got, again)),
                  "two launches of the scan's backward differ")
            plain = rglru_scan_bwd_ref(dh, x, ga, gi, lam, h0, h)
            leaves = [t.double().requires_grad_()
                      for t in (x, ga, gi, lam) + ((h0,) if with_h0 else ())]
            out = scan_f64(torch, *leaves[:4],
                           leaves[4] if with_h0 else None)
            want = torch.autograd.grad(out, leaves, dh.double())
            del out
            row = []
            for name, a, p, w in zip(("dx", "dgate_a", "dgate_i", "dlam",
                                      "dh0"), got, plain, want):
                top = float(w.abs().max())
                # where a = 1 in float32 the clamp binds (mult 1e-6), in
                # float64 it does not (mult 1.5e-5): those channels are
                # held to the plain backward, which binds it too
                e64 = scan_bwd_close(torch, a[..., CLAMPED:],
                                     w[..., CLAMPED:], top)
                ep = scan_bwd_close(torch, a, p, top)
                errs[name] = max(errs.get(name, 0.0),
                                 float((a.float() - p.float()).abs().max()))
                row.append(f"{name} {e64:.2e}/{ep:.2e}")
            print(f"rglru_scan bwd {(B, T, W)} bf16"
                  f"{' from h0' if with_h0 else ''}: max|err| / max|grad| "
                  f"against float64 / the plain backward: " + ", ".join(row)
                  + f" (bound {SCAN_TOL:g}, bf16 gradients + one ulp);"
                  f" two launches bit-identical")
            if (B, T) == SCAN_BWD_SHAPES[0][:2] and not with_h0:
                timed = (dh, x, ga, gi, h)
            del x, ga, gi, h0, dh, h, got, again, plain, leaves, want
            torch.cuda.empty_cache()
    dh, x, ga, gi, h = timed
    B, T, _ = x.shape
    # x, gate_a, gate_i read in bf16, h and g in float32; dx, dgate_a and
    # dgate_i written in bf16: 20 bytes an element
    nbytes = B * T * W * 20

    def kernel():
        return rglru_scan_bwd_cuda(dh, x, ga, gi, lam, None, h)
    entry = dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/models/rglru.py:73",
        max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
        ms=cuda_ms(torch, kernel, 20),
        plain_ms=cuda_ms(torch, lambda: rglru_scan_bwd_ref(
            dh, x, ga, gi, lam, None, h), 2),
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
        library_ms=None, shape=[B, T, W])
    entry["gb_per_s"] = nbytes / entry["ms"] / 1e6
    clusters = ctypes.c_int(0)
    check(build.load("rglru_scan").rglru_scan_bwd_max_clusters(
        ctypes.byref(clusters)) == 0, "cudaOccupancyMaxActiveClusters "
        "failed for the scan's backward")
    blocks = B * BWD_CLUSTER * -(-W // BWD_STRIP)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entry["grid"] = dict(blocks=blocks, blocks_per_sm=blocks / sms,
                         cluster=BWD_CLUSTER, max_clusters=clusters.value)
    print(f"rglru_scan bwd at {entry['shape']} bf16: {entry['ms']:.4f} ms "
          f"({entry['gb_per_s']:.1f} GB/s, "
          f"{100 * entry['bound_ms'] / entry['ms']:.1f}% of the bound), "
          f"bound {entry['bound_ms']:.4f} ms (bytes: 20 B an element), "
          f"plain backward {entry['plain_ms']:.4f} ms; grid {blocks} blocks "
          f"of {BWD_STRIP} channels ({blocks / sms:.2f} an SM), clusters of "
          f"{BWD_CLUSTER}, the card holds {clusters.value} at once")
    del timed, dh, x, ga, gi, h
    torch.cuda.empty_cache()
    return entry


def scan_device_ms(torch, fn, reps: int, kernel: str = "rglru",
                   not_kernel: str | None = None, windows: int = 6):
    """(mean device time of one launch of the kernel named with
    ``kernel`` that ``fn`` launches, launches seen, windows profiled),
    from torch.profiler's kernel intervals in ``reps`` calls, with CPU
    and CUDA activities; fails where a kernel named with ``not_kernel``
    ran in any window.  The mean is over the launches the profiler kept,
    a window that kept none profiled again (``profiled_events``); None if
    none kept any: a measurement, not a gate."""
    def kept(events):
        us = [e for e in events if kernel in e.name]
        check(len(us) <= reps, f"the profiler saw {len(us)} {kernel} "
              f"kernels in {reps} calls")
        check(not_kernel is None or not any(not_kernel in e.name
                                            for e in events),
              f"a {not_kernel} kernel ran where only {kernel} should")
        return bool(us)

    events, window = profiled_events(torch, fn, reps, kept, windows,
                                     cpu=True)
    us = [e.time_range.end - e.time_range.start for e in events
          if kernel in e.name]
    return (sum(us) / len(us) / 1e3 if us else None), len(us), window


def slstm_f64(torch, pre_x, r, state):
    """hs of the sLSTM recurrence of ``slstm_scan_ref`` in float64."""
    B, T, D4 = pre_x.shape
    D, (H, Dh, _) = D4 // 4, r.shape
    c, n, h, m = (s.double() for s in state)
    r = r.double()
    hs = torch.empty((B, T, D), dtype=torch.float64, device=r.device)
    for t in range(T):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r)
        i_, f_, z_, o_ = torch.split(pre_x[:, t].double()
                                     + rec.reshape(B, 4 * D), D, dim=-1)
        m_new = torch.maximum(f_ + m, i_)
        i_g, f_g = torch.exp(i_ - m_new), torch.exp(f_ + m - m_new)
        c, n = f_g * c + i_g * torch.tanh(z_), f_g * n + i_g
        h = torch.sigmoid(o_) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs[:, t] = h
    return hs


def slstm_phase(torch, ptxas):
    """The sLSTM recurrence kernel's two variants against float64 and the
    plain float32 loop at xlstm-125m's shapes, as the engine calls them:
    a prefill of the whole pool (SERVE_SLOTS x PROMPTS[0] x d_model) in
    bf16 from the slots' states, which are not 0 on a reused or live
    slot, and without a state, as a forward calls it, both on
    ``cluster``; a decode step (T = 1) from a state on ``step``, written
    over its state as the engine writes it.  pre_x ~ N(0, 1), the
    model's pre-activations; r with the model's scale; the state one the
    recurrence can reach (n > 0, |c| <= n).  Each call adds one launch,
    to its variant.  Prints each instantiation's ptxas registers and
    spills (``ptxas``: slstm_scan's report), the clusters the card holds
    and the shared memory a block takes; times ``cluster`` at the
    prefill shape (CUDA events) beside the plain loop and the
    operations bound, the exchange probe (the ``cluster`` step loop
    without the product and the gates) at the same shape, and the
    decode call on ``step``, back to back (CUDA events) and as device
    time (torch.profiler), beside its plain loop and its bound (r's
    bytes).  The profiler's kernel names hold each call to its
    variant."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.slstm_scan.kernel import (
        CLUSTER, PROBE, slstm_scan_cuda, slstm_scan_kernel, slstm_variant,
        smem_bytes)
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

    cfg = get_config(XLSTM_ARCH)
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    B, T = SERVE_SLOTS, PROMPTS[0]
    for kernel, report in ptxas:
        print(f"slstm_scan ptxas: {kernel}: {report}")
    check(slstm_variant(B, T, D, H) == "cluster"
          and slstm_variant(B, 1, D, H) == "step",
          "the sLSTM kernel's variant choice does not send prefills to "
          "cluster and decode steps to step")
    lib = build.load("slstm_scan")
    clusters = ctypes.c_int(0)
    check(lib.slstm_scan_max_clusters(D, H, ctypes.byref(clusters)) == 0,
          "cudaOccupancyMaxActiveClusters failed for slstm_scan")
    need = B
    print(f"slstm_scan cluster grid at the prefill: {need} cluster(s) of "
          f"{CLUSTER} blocks, {smem_bytes(D, H, 'cluster')} bytes of shared "
          f"memory a block; the card holds {clusters.value} at once; step: "
          f"{smem_bytes(D, H, 'step')} bytes of dynamic shared memory a "
          f"block")
    check(clusters.value >= need, "the sLSTM kernel's prefill grid does not "
          "fit on the card in one wave")
    g = torch.Generator(device="cuda").manual_seed(0)
    r = torch.randn((H, Dh, 4 * Dh), generator=g, device="cuda") \
        * (0.5 / Dh ** 0.5)

    def state():
        n = torch.rand((B, D), generator=g, device="cuda") * 4 + 0.1
        c = n * (torch.rand((B, D), generator=g, device="cuda") * 2 - 1)
        h = torch.rand((B, D), generator=g, device="cuda") * 2 - 1
        m = torch.randn((B, D), generator=g, device="cuda") * 3
        return c, n, h, m

    errs, cases = {}, {}
    for name, t, st, v in (("prefill", T, state(), "cluster"),
                           ("decode", 1, state(), "step"),
                           ("prefill without state", T, None, "cluster")):
        pre_x = torch.randn((B, t, 4 * D), generator=g,
                            device="cuda").bfloat16()
        zero = torch.zeros((B, D), device="cuda")
        want = slstm_f64(torch, pre_x, r, st or (zero,) * 4)
        plain, plain_st = slstm_scan_ref(pre_x, r, st)
        # the decode step writes over its state, as the engine's does
        out = tuple(s.clone() for s in st) if name == "decode" else None
        n0, v0 = slstm_scan_cuda.launches, slstm_scan_cuda.by_variant[v]
        hs, fin = slstm_scan_cuda(pre_x, r, out or st, out=out)
        check(slstm_scan_cuda.launches - n0 == 1
              and slstm_scan_cuda.by_variant[v] - v0 == 1,
              f"slstm_scan {name}: one call did not add one launch to {v}")
        torch.cuda.synchronize()
        top = float(want.abs().max())
        e64 = float((hs.double() - want).abs().max()) / top
        eplain = float((hs - plain).abs().max()) / top
        eloop = float((plain.double() - want).abs().max()) / top
        errs[name] = float((hs - plain).abs().max())
        print(f"slstm_scan {v} {name} {(B, t, D)} bf16"
              f"{' from a state' if st is not None else ''}: max|h| "
              f"{top:.4f}; max|err| / max|h| against float64 {e64:.3e}, "
              f"against the plain loop {eplain:.3e} (bound {SLSTM_TOL:g}); "
              f"the plain loop's own against float64 {eloop:.3e}")
        check(top <= 1.0, f"slstm_scan {name}: max|h| {top} > 1")
        check(e64 <= SLSTM_TOL and eplain <= SLSTM_TOL,
              f"slstm_scan {name}: {e64}, {eplain} > {SLSTM_TOL}")
        check(torch.equal(fin[2], hs[:, -1]),
              f"slstm_scan {name}: the final h is not the last step's")
        efin = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip(fin, plain_st))
        check(efin <= SLSTM_TOL, f"slstm_scan {name}: the final state is "
              f"{efin} from the plain loop's")
        cases[name] = (pre_x, st)
    pre_x, st = cases["prefill"]
    pre1, st1 = cases["decode"]
    out1 = tuple(s.clone() for s in st1)

    def bound(t):
        """(ms, "operations" or "bytes", the bytes' ms): the least time of
        a call at T t.  2 B H Dh 4Dh operations a step over the card's
        float32 rate; pre_x (bf16) and r read once, hs written once, the
        state read and written once, over its memory rate."""
        ops_s = 2 * B * H * Dh * 4 * Dh * t / FP32_FLOPS_PER_S
        bytes_s = (B * t * 4 * D * 2 + B * t * D * 4 + r.numel() * 4
                   + 8 * B * D * 4) / HBM_BYTES_PER_S
        return (1e3 * max(ops_s, bytes_s),
                "operations" if ops_s >= bytes_s else "bytes", 1e3 * bytes_s)
    ms = cuda_ms(torch, lambda: slstm_scan_cuda(pre_x, r, st), 10)
    probe = cuda_ms(torch, lambda: slstm_scan_kernel(pre_x, r, st, PROBE), 10)

    def decode():
        return slstm_scan_cuda(pre1, r, out1, out=out1)
    bound_ms, bound_by, bytes_ms = bound(T)
    dec_bound_ms, dec_bound_by, _ = bound(1)
    entry = dict(
        name="slstm_scan", route="cuda",
        source="src/repro_torch/csrc/slstm_scan.cu",
        replaces="src/repro/models/xlstm.py:187",
        max_abs_err=max(errs["prefill"], errs["prefill without state"]),
        ms=ms,
        plain_ms=cuda_ms(torch, lambda: slstm_scan_ref(pre_x, r, st), 2),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        us_per_step=1e3 * ms / T,
        ms_again=cuda_ms(torch, lambda: slstm_scan_cuda(pre_x, r, st), 10),
        probe_us_per_step=1e3 * probe / T,
        bytes_bound_ms=bytes_ms,
        decode_ms=cuda_ms(torch, decode, 50),
        decode_plain_ms=cuda_ms(
            torch, lambda: slstm_scan_ref(pre1, r, st1), 50),
        decode_bound_ms=dec_bound_ms, decode_bound_by=dec_bound_by,
        decode_max_abs_err=errs["decode"],
        smem_bytes={v: smem_bytes(D, H, v) for v in ("cluster", "step")},
        max_clusters=clusters.value,
        ptxas=dict(ptxas), shape=[B, T, D])
    entry["ms_by_variant"] = {"cluster": ms, "step": entry["decode_ms"]}
    # the device's kernel names: a prefill runs `cluster` and a decode
    # call `step`, and neither the other.  The profiler drops up to 16 of
    # a window's first kernels (none of 3 prefills kept in one run, 7 of
    # 20 in another, 34 of 50 decode calls), so each window is 50 calls,
    # and now and then all of them, so a window that kept none is
    # profiled again.
    entry["prefill_device_ms"], seen_p, win_p = scan_device_ms(
        torch, lambda: slstm_scan_cuda(pre_x, r, st), 50, "slstm_cluster",
        "slstm_step")
    entry["decode_device_ms"], seen, win = scan_device_ms(
        torch, decode, 50, "slstm_step", "slstm_cluster")
    check(seen_p > 0 and seen > 0, f"the profiler saw {seen_p} cluster "
          f"kernels in 50 prefills and {seen} step kernels in 50 decode "
          f"calls, in each of {win_p} and {win} windows")
    dev = entry["decode_device_ms"]
    print(f"slstm_scan cluster at {entry['shape']} bf16 from a state: "
          f"{ms:.4f} ms ({entry['ms_again']:.4f} again; "
          f"{entry['prefill_device_ms']:.4f} ms of device time, {seen_p} "
          f"of 50 launches seen in window {win_p}; "
          f"{entry['us_per_step']:.3f} us a step), the exchange probe "
          f"{probe:.4f} ms ({entry['probe_us_per_step']:.3f} us a step), "
          f"plain loop {entry['plain_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; bytes "
          f"{entry['bytes_bound_ms']:.4f} ms); a decode step {(B, 1, D)} on "
          f"step {entry['decode_ms']:.4f} ms a call back to back (CUDA "
          f"events), {dev:.4f} ms of device time (torch.profiler, {seen} "
          f"of 50 launches seen in window {win}), plain loop "
          f"{entry['decode_plain_ms']:.4f} ms, bound "
          f"{entry['decode_bound_ms']:.5f} ms ({entry['decode_bound_by']}); "
          f"no PyTorch call computes the recurrence")
    del cases, pre_x, st, pre1, st1, out1
    torch.cuda.empty_cache()
    return entry


def _wrappers():
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.gemm_hd.kernel import gemm_cuda
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                      rglru_scan_cuda)
    from repro_torch.kernels.slstm_scan.kernel import (slstm_scan_bwd_cuda,
                                                       slstm_scan_cuda)
    from repro_torch.kernels.stencil_hd.kernel import jacobi_cuda
    return {"jacobi_hd": jacobi_cuda, "gemm_hd": gemm_cuda,
            "flash_attn_hd": flash_attention_cuda,
            "flash_attn_bwd_hd": flash_attention_bwd_cuda,
            "rglru_scan": rglru_scan_cuda,
            "rglru_scan_bwd": rglru_scan_bwd_cuda,
            "slstm_scan": slstm_scan_cuda,
            "slstm_scan_bwd": slstm_scan_bwd_cuda}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "by_variant"):
            fn.by_variant = dict.fromkeys(fn.by_variant, 0)


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_variants():
    """Launches per variant of each kernel whose source has variants."""
    return {name: dict(fn.by_variant) for name, fn in _wrappers().items()
            if hasattr(fn, "by_variant")}


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


def logits_finite(torch, eng, prompt_len: int = PROMPTS[1],
                  extra_inputs=None) -> bool:
    """Whether the engine's model gives finite logits for one prefill of
    the whole pool (every slot a prompt of ``prompt_len`` tokens, with
    the ``extra_inputs``) and one decode step after it, through the
    bundle's public steps on a cache of the engine's size: outside the
    timed run, so the engine that is timed is the one a user calls."""
    bundle = eng.bundle
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, eng.cfg.vocab,
                                         (SERVE_SLOTS, prompt_len)))
    cache = bundle.init_cache(SERVE_SLOTS, eng.scfg.max_seq)
    pre, cache = bundle.prefill(
        eng.params, {"tokens": toks.to(eng.device), **(extra_inputs or {})},
        cache)
    batch = {"token": pre.argmax(dim=-1),
             "pos": torch.full((SERVE_SLOTS,), prompt_len, dtype=torch.int32,
                               device=eng.device)}
    dec, cache = bundle.decode(eng.params, batch, cache)
    ok = bool(torch.isfinite(pre).all()) and bool(torch.isfinite(dec).all())
    print(f"logits of one pool prefill {tuple(pre.shape)} and one decode "
          f"step {tuple(dec.shape)} all finite: {ok}")
    del cache
    torch.cuda.empty_cache()
    return ok


def serve_prompts(vocab: int, lengths=PROMPTS):
    """The serving phases' prompts of ``lengths`` tokens, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in lengths]


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts and lists."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def serve_path(torch, arch: str, variant: str, label: str,
               readmit_repeats: bool = True, per_step=None,
               step_variants=None, max_seq: int = SERVE_MAX_SEQ,
               prompts=PROMPTS, extra_inputs=None, cfg=None):
    """``arch`` at full width and depth (or ``cfg``, a cut of it, built
    as ``load_engine`` builds a family) behind the slot Engine of
    ``SERVE_SLOTS`` x ``max_seq``: admits of ``prompts`` tokens, each
    with the same pool-shaped ``extra_inputs`` (audio frames, image
    embeddings), decode steps, finishes, and the first prompt again,
    every prefill launching the flash kernel's ``variant`` (where
    ``per_step`` has flash).  ``per_step`` maps each kernel the family
    launches to its launches per prefill and per decode step (default:
    flash once per layer in a prefill, never in decode); every other
    kernel, flash included, must launch no time.
    ``step_variants`` maps a kernel of ``per_step`` to the variant every
    one of its prefill launches and every one of its decode launches
    must take.  With
    ``readmit_repeats`` the re-admitted prompt must repeat its greedy
    continuation.  Returns (launches, launches by variant, bundle,
    params); the engine and its cache are freed."""
    from repro_torch.kernels.flash_attention.kernel import VARIANTS
    from repro_torch.launch.serve import load_engine
    from repro_torch.models.lm import _window_array

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if cfg is None:
        eng = load_engine(arch, reduced=False, slots=SERVE_SLOTS,
                          max_seq=max_seq, seed=0)
    else:
        from repro_torch.models import build
        from repro_torch.serve import Engine, ServeConfig
        bundle = build(cfg, torch.bfloat16)
        eng = Engine(bundle, bundle.init(0), ServeConfig(
            max_seq=max_seq, slots=SERVE_SLOTS), seed=0)
    torch.cuda.synchronize()
    cfg = eng.cfg
    per_step = per_step or {"flash_attn_hd": (cfg.n_layers, 0)}
    n_params = cfg.param_count()
    w_bytes, cache_bytes = tensor_bytes(eng.params), tensor_bytes(eng.cache)
    ffn = (f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
           f"{cfg.moe.d_expert_ff} (capacity factor "
           f"{cfg.moe.capacity_factor})" if cfg.moe else f"d_ff {cfg.d_ff}")
    if cfg.moe and cfg.moe.n_shared:
        ffn += (f" plus {cfg.moe.n_shared} shared of "
                f"{cfg.moe.d_shared_ff or cfg.moe.d_expert_ff}")
    if cfg.mla:
        m = cfg.mla
        ffn += (f", MLA (q_lora {m.q_lora}, kv_lora {m.kv_lora}, d_nope "
                f"{m.d_nope}, d_rope {m.d_rope}, d_v {m.d_v}), the first "
                f"{cfg.dense_layers} layers dense with d_ff {cfg.d_ff}, the "
                f"MTP head's parameters")
    if cfg.rg:
        ffn += (f", lru_width {cfg.rg.lru_width}, conv width "
                f"{cfg.rg.conv_width}, {cfg.rg.pattern} rec per attention")
    if cfg.xlstm:
        xl = cfg.xlstm
        ffn = (f"mLSTM inner width {int(cfg.d_model * xl.proj_factor)}, "
               f"sLSTM every {xl.slstm_every} layers, its ffn "
               f"{int(cfg.d_model * 4 * xl.ff_factor) // 2 * 2}, no "
               f"attention")
    if cfg.encdec:
        ffn += (f" (plain tanh-gelu MLP), encoder {cfg.encdec.n_enc_layers} "
                f"layers over {cfg.encdec.n_frames} frames, dense; decoder "
                f"self-attention without a window, cross-attention dense")
    if cfg.vision:
        vi = cfg.vision
        ffn += (f", a dense cross-attention after block "
                f"{vi.cross_every - 2} of every {vi.cross_every} "
                f"({cfg.n_layers // vi.cross_every} in all, {cfg.n_heads} "
                f"heads) over {vi.n_image_tokens} image tokens of width "
                f"{vi.d_vision}")
    print(f"{label}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads d_head {cfg.head_dim} {ffn} "
          f"vocab {cfg.vocab}, windows "
          f"{None if cfg.encdec else sorted(set(_window_array(cfg)))}, "
          f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, bfloat16: "
          f"weights {w_bytes / 1e9:.3f} GB (param_count() {n_params}), "
          f"cache {cache_bytes / 1e9:.3f} GB ({SERVE_SLOTS} slots x "
          f"{max_seq}), both from the tensors' bytes; allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; set-up (random "
          f"weights from a seeded generator) "
          f"{time.perf_counter() - t0:.2f} s")

    wrappers = _wrappers()
    flash = wrappers["flash_attn_hd"]
    lengths = prompts
    prompts = serve_prompts(cfg.vocab, lengths)
    prefill_ms, per_prefill, decode_ms, decode_tokens = [], [], [], 0

    step_variants = step_variants or {}

    def counts():
        return {k: wrappers[k].launches for k in per_step}

    def by_variant(phase):
        """Launches so far of each kernel of step_variants in the variant
        it must take in ``phase`` (0 prefill, 1 decode)."""
        return {k: wrappers[k].by_variant[v[phase]]
                for k, v in step_variants.items()}

    def check_variants(phase, n0, got):
        for k, n in by_variant(phase).items():
            check(n - n0[k] == got[k],
                  f"a {label} {('prefill', 'decode step')[phase]} launched "
                  f"{k} in another variant than "
                  f"{step_variants[k][phase]}")

    def admit(prompt):
        n0, v0 = counts(), by_variant(0)
        w0 = flash.by_variant.get(variant, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sid = eng.add_request(prompt, extra_inputs)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t))
        per_prefill.append({k: n - n0[k] for k, n in counts().items()})
        if "flash_attn_hd" in per_step:
            check(flash.by_variant[variant] - w0
                  == per_prefill[-1]["flash_attn_hd"],
                  f"a {label} prefill launched another flash variant than "
                  f"{variant}")
        check_variants(0, v0, per_prefill[-1])
        return sid

    def decode(n):
        nonlocal decode_tokens
        for _ in range(n):
            n0, v0 = counts(), by_variant(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = eng.step()
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t))
            decode_tokens += len(out)
            got = {k: m - n0[k] for k, m in counts().items()}
            check(got == {k: d for k, (_, d) in per_step.items()},
                  f"a {label} decode step launched {got}, not "
                  f"{ {k: d for k, (_, d) in per_step.items()} }")
            check_variants(1, v0, got)

    reset_launches()
    t_run = time.perf_counter()
    sids = []
    for prompt in prompts:
        sids.append(admit(prompt))
        decode(DECODE_STEPS)
    streams = [eng.finish(sid) for sid in sids]
    sid = admit(prompts[0])
    decode(len(lengths) * DECODE_STEPS)
    again = eng.finish(sid)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    launches = read_launches()
    variants = read_variants()
    n_gen = len(streams[0]) - lengths[0]
    print(f"{label}: prefill ms per admit {[round(x, 3) for x in prefill_ms]} "
          f"(prompts {list(lengths)} then {lengths[0]} again; host clock, "
          f"synchronized); decode ms per step: median "
          f"{float(np.median(decode_ms)):.3f}, min {min(decode_ms):.3f}, "
          f"max {max(decode_ms):.3f} over {len(decode_ms)} steps; "
          f"{decode_tokens} decode tokens in {sum(decode_ms) / 1e3:.3f} s = "
          f"{decode_tokens / (sum(decode_ms) / 1e3):.1f} tokens/s; whole run "
          f"{t_run:.3f} s; launches per prefill {per_prefill}, per decode "
          f"step { {k: d for k, (_, d) in per_step.items()} }; launches "
          f"{launches}, by variant "
          f"{ {k: variants[k] for k in per_step if k in variants} }")
    check(per_prefill == [{k: p for k, (p, _) in per_step.items()}]
          * (len(lengths) + 1),
          f"{label}: launches per prefill {per_prefill}, not "
          f"{ {k: p for k, (p, _) in per_step.items()} }")
    check(all(n == 0 for k, n in launches.items() if k not in per_step),
          f"{label}: launched another path's kernel: {launches}")
    check("flash_attn_hd" in per_step or launches["flash_attn_hd"] == 0,
          f"{label}: a family without attention launched flash")
    check(variants["flash_attn_hd"] == {
        v: launches["flash_attn_hd"] if v == variant else 0
        for v in VARIANTS},
        f"{label}: flash launches by variant {variants['flash_attn_hd']}: "
        f"every one must be the {variant} kernel")
    check(logits_finite(torch, eng, lengths[1], extra_inputs),
          f"non-finite logits on the {label}")
    same = again == streams[0]
    print(f"{label}: re-admitted prompt repeats its greedy continuation of "
          f"{n_gen} tokens: {same}")
    check(same or not readmit_repeats,
          f"{label}: the same prompt gave another greedy continuation")
    check(all(0 <= t < cfg.vocab for st in streams + [again] for t in st),
          f"{label}: a generated token is outside the vocabulary")

    eng.add_request(prompts[2], extra_inputs)
    # six names: gemma2's flash kernel comes fifth or later
    device_breakdown(torch, f"{label}: one prefill ({lengths[1]} tokens, "
                     f"the whole {SERVE_SLOTS}-slot pool)",
                     lambda: eng.add_request(prompts[1], extra_inputs), top=6)
    device_breakdown(torch, f"{label}: one decode step ({SERVE_SLOTS} slots, "
                     f"2 live)", eng.step, host_top=8)
    print(f"{label}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, weights "
          f"{w_bytes / 1e9:.3f} GB")
    bundle, params = eng.bundle, eng.params
    del eng
    torch.cuda.empty_cache()
    return launches, variants, bundle, params


def lone_prompt_repeats(torch, bundle, params, prompt, steps: int) -> None:
    """One prompt admitted alone into a fresh Engine on ``params`` and
    decoded ``steps`` steps, twice: every bit of both caches (every
    leaf: for a decoder each layer's keys and values of every position,
    so every layer's input at every step; for recurrentgemma also each
    recurrent layer's state and conv tail and the ring's positions; for
    xlstm every mLSTM and sLSTM layer's state)
    must be equal, and the streams too, a secondary check (random
    weights tend to decode one token over and over, so equal streams
    alone show little).  Each run starts from the same pool state
    (every slot empty): under MoE capacity the empty slots' rows
    compete for experts too, and recurrentgemma's and xlstm's Engines,
    like the reference's, reset only ``pos`` when they reuse a slot."""
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.tree import tree_leaves

    streams, caches = [], []
    for _ in range(2):
        eng = Engine(bundle, params, ServeConfig(max_seq=SERVE_MAX_SEQ,
                                                 slots=SERVE_SLOTS), seed=0)
        sid = eng.add_request(prompt)
        for _ in range(steps):
            eng.step()
        streams.append(eng.finish(sid))
        caches.append(tree_leaves(eng.cache))
        del eng
    same = streams[0] == streams[1]
    bits = len(caches[0]) == len(caches[1]) and all(
        torch.equal(a, b) for a, b in zip(*caches))
    print(f"{bundle.cfg.name}: one prompt of {len(prompt)} tokens admitted "
          f"alone into a fresh engine and decoded {steps} steps, twice: "
          f"every one of the {len(caches[0])} cache leaves bit-identical "
          f"{bits}; streams equal (secondary) {same} "
          f"({streams[0][len(prompt):]})")
    check(same and bits, f"{bundle.cfg.name}: the lone prompt's run "
          f"changed between two runs from the same pool state")
    del caches
    torch.cuda.empty_cache()


def moe_layer_check(torch, bundle, params, prompt, mesh) -> None:
    """The first moe layer's feed-forward at full width on the hidden
    state of the first admit's prefill (the whole pool: the prompt in
    slot 0, empty slots of token 0 beside it; after the leading dense
    layers where the model has them), in bf16, against a float32
    evaluation of the same routing (the same ids and weights, the same
    capacity drops, every expert in float32, one expert at a time, and
    the shared experts where the layer has them); then the same layer
    through the expert-parallel dispatch (``impl="ep"``) on ``mesh``, the
    (1, 1) ("data", "model") mesh of :func:`ep_mesh`, which must equal
    the sort dispatch bit for bit: one column holds every expert, so the
    same routing, capacity and sums, and an all-reduce over one rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    import repro_torch.models.layers as LY
    from repro_torch.models import lm
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import rms_norm

    cfg, mo = bundle.cfg, bundle.cfg.moe
    pl = params["main"][0]
    toks = np.zeros((SERVE_SLOTS, len(prompt)), np.int64)
    toks[0] = prompt
    with torch.no_grad():
        x = lm._embed(params["emb"], torch.from_numpy(toks).cuda(), cfg,
                      torch.bfloat16)
        if "dense" in params:
            x, _, _ = lm._run_stack(cfg, params["dense"], x,
                                    lm._window_array(cfg), None)
        h = rms_norm(x, pl["norms"]["pre_attn"])
        if cfg.mla is not None:
            a, _ = MLA.mla_attention(pl["attn"], h, cfg,
                                     rope_base=cfg.rope_base)
        else:
            a, _ = LY.attention(pl["attn"], h, cfg=cfg, window=lm.BIG_WINDOW)
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
        shared = "shared" in pl["ffn"]
        if shared:
            sp, xf = pl["ffn"]["shared"], hf.float()
            want += (torch.nn.functional.silu(xf @ sp["w_gate"].float())
                     * (xf @ sp["w_up"].float())) @ sp["w_down"].float()
        err = float((got.float().reshape(N, D) - want).norm() / want.norm())
    print(f"{cfg.name}: the first moe layer on the first admit's hidden "
          f"state ({B} x {T} tokens, C = {C}, {kept} of {N * k} pairs kept"
          f"{', the shared expert included' if shared else ''}): bf16 "
          f"against float32 on the same routing, relative Frobenius error "
          f"{err:.3e} (gate {MOE_LAYER_TOL:g}); {ms:.3f} ms a call")
    check(err <= MOE_LAYER_TOL, f"{cfg.name}: the bf16 MoE layer is "
          f"{err:.3e} from the float32 evaluation of its routing")
    xd = DTensor.from_local(h, mesh, [Shard(0), Replicate()],
                            run_check=False)

    def ep_call():
        return MOE.moe_ffn(pl["ffn"], xd, mo, aux=False, impl="ep")[0]
    with torch.no_grad():
        ep = ep_call()
        bits = isinstance(ep, DTensor) and torch.equal(ep.to_local(), got)
        ep_ms = cuda_ms(torch, ep_call, 5)
    print(f"{cfg.name}: the first moe layer through impl='ep' on a (1, 1) "
          f"('data', 'model') mesh over a one-rank NCCL group "
          f"({mo.num_experts} experts a column, C = {C}): bit for bit the "
          f"sort dispatch {bits}; ep {ep_ms:.3f} ms a call, sort {ms:.3f} "
          f"ms a call ({card_line()})")
    check(bits, f"{cfg.name}: the ep dispatch on one rank parts from the "
          f"sort dispatch")


def ep_mesh():
    """The (1, 1) ("data", "model") DeviceMesh on the card over a
    one-rank NCCL process group on a free localhost port, destroyed at
    exit."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    atexit.register(dist.destroy_process_group)
    return make_debug_mesh((1, 1), device_type="cuda")


def mla_layer_check(torch, bundle, params):
    """One MLA layer of the served model (the first moe layer's
    attention) at B 1 and T 1024 (FLASH_MIN_T) from a filled cache:
    1024 rows written by a first chunk, then a second chunk of 1024 in
    both forms on the same cache, the naive one (K and V expanded from
    the latent, the flash kernel's wgmma with the RoPE parts as operands
    of their own, the shared key a strided view of the cache) and the
    absorbed one (dense einsums against the latent), within
    MLA_FORMS_BF16_TOL (Frobenius-relative) of each other."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.models import mla as MLA
    from repro_torch.models.layers import FLASH_MIN_T

    cfg, T = bundle.cfg, FLASH_MIN_T
    p = params["main"][0]["attn"]
    g = torch.Generator(device="cuda").manual_seed(5)
    x0, x = (torch.randn((1, T, cfg.d_model), generator=g, device="cuda")
             .bfloat16() for _ in range(2))
    cache = {"ckv": MLA.init_mla_cache(cfg, 1, 1, SERVE_MAX_SEQ)["ckv"][0],
             "pos": torch.zeros((1,), dtype=torch.int32, device="cuda")}
    kw = dict(rope_base=cfg.rope_base)
    by_variant = flash_attention_cuda.by_variant
    with torch.no_grad():
        _, cache = MLA.mla_attention(p, x0, cfg, cache=cache, **kw)
        n0, v0 = flash_attention_cuda.launches, by_variant["wgmma"]
        naive, _ = MLA.mla_attention(p, x, cfg, cache=dict(cache), naive=True,
                                     **kw)
        launched = (flash_attention_cuda.launches - n0,
                    by_variant["wgmma"] - v0)
        absorbed, _ = MLA.mla_attention(p, x, cfg, cache=dict(cache),
                                        naive=False, **kw)
        err = fro_rel(torch, naive, absorbed)
        ms = {form: cuda_ms(torch, lambda: MLA.mla_attention(
            p, x, cfg, cache=dict(cache), naive=form == "naive", **kw), 5)
            for form in ("naive", "absorbed")}
    finite = bool(torch.isfinite(naive).all() and torch.isfinite(absorbed)
                  .all())
    print(f"{cfg.name}: one MLA layer at B 1, T {T} from a cache holding "
          f"{T} rows (of {SERVE_MAX_SEQ}): naive form (flash launches "
          f"{launched[0]}, wgmma {launched[1]}) against absorbed form, "
          f"relative Frobenius {err:.3e} (gate {MLA_FORMS_BF16_TOL:g}); "
          f"finite {finite}; naive {ms['naive']:.3f} ms, absorbed "
          f"{ms['absorbed']:.3f} ms a call (CUDA events)")
    check(launched == (1, 1), f"{cfg.name}: the naive MLA form launched "
          f"{launched[0]} flash kernels, {launched[1]} wgmma, not 1")
    check(finite and err <= MLA_FORMS_BF16_TOL, f"{cfg.name}: the naive "
          f"and absorbed MLA forms are {err:.3e} apart")
    del naive, absorbed, cache
    torch.cuda.empty_cache()
    return dict(fro_rel=err, naive_ms=ms["naive"],
                absorbed_ms=ms["absorbed"], shape=[1, T, cfg.d_model])


def hd_flash_phase(torch):
    """make_flash_kernel on the torch backend: one fp16 sequence of
    HD_FLASH_T tokens as 2-D (T, heads*dim) HDArrays, the queries'
    rows partitioned over NPROC ranks, K and V read whole (ALL_2D), O
    defined on each rank's rows, one apply_kernel at each of
    HD_FLASH_SHAPES; each within FLASH_MAIN_TOL of the plain blockwise
    version over the whole sequence, every launch counted (NPROC, of
    the variant flash_variant picks).  Returns (launches, launches by
    variant, launches by shape) of the apply_kernel runs."""
    from repro_torch.core import ALL_2D, ROW_ALL, HDArrayRuntime
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.kernel import (
        VARIANTS, flash_attention_cuda, flash_variant)
    from repro_torch.kernels.hd import make_flash_kernel

    T = HD_FLASH_T
    rng = np.random.default_rng(4)
    launches, variants, by_shape = 0, dict.fromkeys(VARIANTS, 0), {}
    for Hq, Hkv, Dh, Dv in HD_FLASH_SHAPES:
        q, k, v = (rng.standard_normal((T, w), np.float32).astype(np.float16)
                   for w in (Hq * Dh, Hkv * Dh, Hkv * Dv))
        rt = HDArrayRuntime(NPROC)
        arrs = [rt.create(n, a.shape, np.float16)
                for n, a in (("Q", q), ("K", k), ("V", v))]
        arrs.append(rt.create("O", (T, Hq * Dv), np.float16))
        part = rt.partition_row(q.shape)
        rt.write(arrs[0], q, part)
        rt.write_replicated(arrs[1], k)
        rt.write_replicated(arrs[2], v)
        rt.write(arrs[3], np.zeros((T, Hq * Dv), np.float16),
                 rt.partition_row((T, Hq * Dv)))
        kern = make_flash_kernel(heads=Hq, dim=Dh, kv_heads=Hkv, out_dim=Dv)
        variant = flash_variant(torch.float16, Dh, Dv)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.apply_kernel("flash", part, kern, arrs,
                        uses={"Q": ROW_ALL, "K": ALL_2D, "V": ALL_2D},
                        defs={"O": ROW_ALL})
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        n, by = flash_attention_cuda.launches, dict(
            flash_attention_cuda.by_variant)
        launches += n
        by_shape[Hq, Hkv, Dh, Dv] = n
        variants = {x: variants[x] + by[x] for x in VARIANTS}
        got = torch.from_numpy(rt.read_coherent(arrs[3])).cuda()
        qt, kt, vt = (torch.from_numpy(a).cuda() for a in (q, k, v))
        want = blockwise_attention(
            qt.view(1, T, Hq, Dh), kt.view(1, T, Hkv, Dh),
            vt.view(1, T, Hkv, Dv),
            qpos=torch.arange(T, dtype=torch.int32, device="cuda")[None],
            window=None).view(T, Hq * Dv)
        err = (got.float() - want.float()).abs()
        bad = int((err > FLASH_MAIN_TOL * (1 + want.float().abs())).sum())
        print(f"make_flash_kernel on the torch backend, {NPROC} ranks of "
              f"{T // NPROC} query rows, fp16 {Hq}/{Hkv} heads of {Dh}/{Dv}: "
              f"launches {n} ({by}), apply_kernel {wall:.3f} ms (host clock, "
              f"synchronized, first run); against the blockwise version "
              f"over the whole sequence max_abs_err={float(err.max()):.3e}, "
              f"outside rtol=atol={FLASH_MAIN_TOL:g}: {bad}")
        check(n == NPROC and by[variant] == NPROC, f"make_flash_kernel at "
              f"{Dh}/{Dv} launched {by}, not {NPROC} {variant}")
        check(bad == 0, f"make_flash_kernel at {Dh}/{Dv} differs from the "
              f"plain version")
        rt.close()
        del rt, arrs, got, want, qt, kt, vt, err
        torch.cuda.empty_cache()
    return launches, variants, by_shape


def named_leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf of a parameter tree, in order."""
    if isinstance(tree, dict):
        for k, t in tree.items():
            yield from named_leaves(t, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def train_cut(arch: str, **cut):
    """``arch`` and the fields of its configuration that the card's
    training replaces (n_layers, dense_layers): ``setup``'s ``cut``."""
    return arch, cut


def slstm_train_check(torch, bundle, params, mb) -> None:
    """The sLSTM kernels inside one bf16 training microbatch through
    ``bundle``, against the plain loops on that microbatch's own inputs,
    layer by layer: the kernel's hs within SLSTM_TOL of its largest of
    ``slstm_scan_ref``'s from the same pre_x and r; the backward's d pre_x
    (bf16, one bf16 ulp of its own more) and dr (the gradient of the
    layer's r_in) within SLSTM_TOL of their largest of
    ``slstm_scan_bwd_ref``'s from the same pre_x, r and dL/dhs."""
    import repro_torch.models.xlstm as XL
    from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_ref,
                                                    slstm_scan_ref)
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)

    real, taps = XL.slstm_scan, []

    def scan(pre_x, r, state=None, out=None):
        hs, fin = real(pre_x, r, state, out=out)
        tap = {"pre_x": pre_x.detach(), "r": r.detach(), "hs": hs.detach()}
        # the checkpoint's recompute builds a graph no gradient reaches
        hs.register_hook(lambda g: tap.__setitem__("dhs", g))
        pre_x.register_hook(lambda g: tap.__setitem__("dpre_x", g))
        taps.append(tap)
        return hs, fin

    XL.slstm_scan = scan
    try:
        _, _, grads = value_and_grad(make_loss_fn(bundle, TrainConfig()))(
            params, mb)
    finally:
        XL.slstm_scan = real
    taps = [t for t in taps if "dhs" in t]
    check(len(taps) == len(grads["slstm"]), f"(h) {bundle.cfg.name}: "
          f"{len(taps)} sLSTM layers reached by the backward")
    rows = []
    for i, (t, g) in enumerate(zip(taps, grads["slstm"])):
        hs, _ = slstm_scan_ref(t["pre_x"], t["r"])
        dpre, dr, _ = slstm_scan_bwd_ref(t["dhs"].float(), t["pre_x"],
                                         t["r"])
        e_hs = float((t["hs"] - hs).abs().max() / hs.abs().max())
        e_pre = (t["dpre_x"].double() - dpre.double()).abs()
        slack = dpre.double().abs() * 2.0 ** -7
        top = float(dpre.abs().max())
        e_dr = float((g["r_in"] - dr).abs().max() / dr.abs().max())
        rows.append(f"layer {i}: hs {e_hs:.2e}, d pre_x "
                    f"{float(e_pre.max()) / top:.2e}, dr {e_dr:.2e}")
        check(e_hs <= SLSTM_TOL and e_dr <= SLSTM_TOL
              and bool((e_pre <= SLSTM_TOL * top + slack).all()),
              f"(h) {bundle.cfg.name}: the sLSTM kernels in a bf16 training "
              f"microbatch part from the plain loops: {rows[-1]}")
    print(f"(h) {bundle.cfg.name} the sLSTM kernels in one bf16 microbatch "
          f"(1 x {TRAIN_SEQ}) against the plain loops on its own inputs, "
          f"max|err| / max: " + "; ".join(rows)
          + f" (bound {SLSTM_TOL:g}, bf16 d pre_x + one ulp)")


def moe_routing(torch, cfg, taps, pass_names) -> None:
    """Per moe layer of one microbatch, from the ids ``_route`` gave in
    two passes (``taps``: one dict a pass, each layer's first routing
    under its router's key, in the forward's order): the (token, choice)
    pairs dropped by capacity in each pass, and the pairs the first pass
    routed to an expert that the second did not choose for that
    token."""
    mo = cfg.moe
    rows = []
    for i, ids in enumerate(zip(*(list(t.values()) for t in taps))):
        N = ids[0].shape[0]
        C = max(1, int(mo.capacity_factor * N * mo.top_k / mo.num_experts))
        drops = [int((torch.bincount(x.reshape(-1), minlength=mo.num_experts)
                      - C).clamp(min=0).sum()) for x in ids]
        flips = int((~(ids[0][:, :, None] == ids[1][:, None, :]).any(-1))
                    .sum())
        rows.append(f"layer {i}: dropped " + ", ".join(
            f"{d} ({n})" for d, n in zip(drops, pass_names))
            + f", pairs routed otherwise than the {pass_names[1]} pass "
            f"{flips}")
    print(f"(h) {cfg.name} routing of one microbatch, {N} tokens x top "
          f"{mo.top_k} of {mo.num_experts} experts, capacity {C} a expert "
          f"(capacity factor {mo.capacity_factor:g}): " + "; ".join(rows))


def host_gate(torch, cfg, params, mb):
    """One sample of ``mb`` through the float32 model, its loss and
    every gradient on the card against the same float32 model on the
    host: (the worst fro_rel of a leaf, its name)."""
    from repro_torch.models import build
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)
    from repro_torch.tree import tree_map

    one = {k: v[:1] for k, v in mb.items()}
    got = {}
    for dev in ("cuda", "cpu"):
        fn = value_and_grad(make_loss_fn(build(cfg, torch.float32, dev),
                                         TrainConfig()))
        t0 = time.perf_counter()
        loss, _, g = fn(tree_map(lambda t: t.to(dev), params),
                        {k: v.to(dev) for k, v in one.items()})
        torch.cuda.synchronize()
        got[dev] = (float(loss), tree_map(lambda t: t.cpu(), g),
                    time.perf_counter() - t0)
    worst, leaf = max((fro_rel(torch, a, b), name) for (name, a), (_, b) in
                      zip(named_leaves(got["cuda"][1]),
                          named_leaves(got["cpu"][1])))
    shape = {k: tuple(v.shape) for k, v in one.items()}
    print(f"(h) {cfg.name} one sample {shape} in float32, the card against "
          f"the host: loss {got['cuda'][0]:.7f} and {got['cpu'][0]:.7f}; "
          f"worst fro_rel of a leaf's gradient {worst:.3e} ({leaf}), bound "
          f"{HOST_GATE_TOL:g}; card {got['cuda'][2]:.2f} s, host "
          f"{got['cpu'][2]:.2f} s (host clock)")
    check(abs(got["cuda"][0] - got["cpu"][0])
          <= HOST_GATE_TOL * abs(got["cpu"][0]) and worst <= HOST_GATE_TOL,
          f"(h) {cfg.name}: the card's float32 loss or gradients part from "
          f"the host's: {worst} at {leaf}")
    return worst, leaf


def train_phase(torch, cut, steps: int, tol: float = TRAIN_GRAD_TOL,
                spread: bool = False, gate_dtype=None, seq: int = TRAIN_SEQ,
                batch: int = TRAIN_BATCH, micro: int = TRAIN_MICRO,
                on_host: bool = False, reduced: bool = False):
    """(h) ``cut`` (a ``train_cut``) trained on the card at full width
    (with ``reduced``, at the launcher's default reduced config, its
    first step's loss and gradient norm then held to the port's CPU step
    on the same weights and batch within ``REDUCED_LOSS_RTOL`` and
    ``REDUCED_GNORM_RTOL``, and no device breakdown) through ``launch.train.setup``, with the traffic ``seq``, ``batch``,
    ``micro`` (sequence length, global batch, microbatches) and the
    family's extra inputs (``launch.train._extra_inputs``, as ``train``
    makes them): a gate on one microbatch's gradients, kernels against
    the plain versions (blockwise attention, the plain scan and sLSTM
    loops) on the same float32 masters, each leaf finite, non-zero and
    within ``tol`` (with ``spread``, also within twice the plain path's
    own spread: its distance from the plain path run with 256 x 256
    attention blocks; with ``gate_dtype``, a torch dtype's name, the
    gate's model computes in that type, not bf16); with moe layers, the
    plain versions on the kernels' routing within ``tol``, on their own
    routing within twice the spread, and each pass's drops and routing
    printed (``moe_routing``); with ``on_host``, where
    the path launches no kernel, the gate holds one sample's float32
    loss and gradients on the card to the host's instead
    (``host_gate``); with sLSTM layers, ``slstm_train_check`` on a bf16
    microbatch; then ``steps`` steps through the run's train step.
    Checks every launch: per microbatch flash's forward 2 and its
    backward 1 per self-attention layer at ``FLASH_MIN_T`` tokens or
    more (the checkpointed layer's recompute included) and 1 and 1 for
    an MTP block (no checkpoint), the scan's forward 2 (``chunked``) and
    its backward 1 per recurrent layer, the sLSTM's forward 2
    (``cluster``) and its backward 1 per sLSTM layer; dense
    cross-attentions and encoders none; flash's forward and backward in
    the variants ``flash_variant`` and ``bwd_variant`` name for the
    model's bf16 head dims.  Returns its launches, launches
    by variant and step stats."""
    import functools

    import repro_torch.models.layers as LY
    import repro_torch.models.mla as MLA
    import repro_torch.models.moe as MOE
    import repro_torch.models.rglru as RG
    import repro_torch.models.xlstm as XL
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    from repro_torch.launch.train import _extra_inputs, setup
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)

    arch, fields = cut
    ph = "(j)" if reduced else "(h)"      # the phase the prints name
    t0 = time.perf_counter()
    run = setup(arch, reduced=reduced, cut=fields, seq_len=seq,
                global_batch=batch, microbatches=micro, device="cuda")
    cfg, bundle, params = run.cfg, run.bundle, run.params
    n_params = sum(p.numel() for p in tree_leaves(params))
    # the moments, zeros, wait out the gate off the card: made again
    # before the steps, as setup makes them
    run.opt_state = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    full = get_config(arch).n_layers
    L = cfg.n_layers
    n_rec = n_s = n_cross = n_enc = 0
    if cfg.family == "hybrid":
        n_att = L // (cfg.rg.pattern + 1)
        n_rec = L - n_att
    elif cfg.family == "ssm":
        n_att, n_s = 0, L // cfg.xlstm.slstm_every
    else:
        n_att = L
    if cfg.family == "vlm":
        n_cross = L // cfg.vision.cross_every
    if cfg.family == "audio":
        n_enc, n_cross = cfg.encdec.n_enc_layers, L
    n_mtp = int(bool(cfg.mtp))
    n_moe = L - cfg.dense_layers if cfg.moe is not None else 0
    kinds = ", ".join(f"{n} {k}" for n, k in (
        (n_enc, "encoder"), (n_att, "self-attention"), (n_rec, "RG-LRU"),
        (n_s, "sLSTM"), (L - n_s if cfg.family == "ssm" else 0, "mLSTM"),
        (n_cross, "cross-attention"),
        (n_moe, "moe feed-forward"),
        (n_mtp, "MTP block")) if n)
    print(f"{ph} {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab}, "
          f"{L} of {full} layers ({kinds}): "
          f"{n_params / 1e9:.3f} B float32 parameters "
          f"({4 * n_params / 1e9:.2f} GB; {16 * n_params / 1e9:.1f} GB with "
          f"gradients and two moments), setup {time.perf_counter() - t0:.1f}"
          f" s")
    # the decoder's self-attention reaches flash from FLASH_MIN_T tokens,
    # in the variants its bf16 head dims take (MLA's RoPE part joined)
    n_flash, m_flash = (n_att, n_mtp) if seq >= LY.FLASH_MIN_T else (0, 0)
    dims = ((cfg.mla.d_nope + cfg.mla.d_rope, cfg.mla.d_v) if cfg.mla
            else (cfg.head_dim, cfg.head_dim))
    fwd_v = fk.flash_variant(torch.bfloat16, *dims)
    bwd_v = fk.bwd_variant(torch.bfloat16, *dims)
    extras = _extra_inputs(cfg, batch, seq, np.random.default_rng(123),
                           "cuda")

    def batch_at(i):
        b = {k: torch.from_numpy(v).to("cuda")
             for k, v in run.pipeline.batch_at(i).items()}
        return {**b, **extras}

    def per_microbatch(k: int):
        return {"flash_attn_hd": (2 * n_flash + m_flash) * k,
                "flash_attn_bwd_hd": (n_flash + m_flash) * k,
                "rglru_scan": 2 * n_rec * k, "rglru_scan_bwd": n_rec * k,
                "slstm_scan": 2 * n_s * k, "slstm_scan_bwd": n_s * k}

    # -- the gate: one microbatch, kernels against the plain versions --
    gate_bundle = bundle if gate_dtype is None else build(
        cfg, getattr(torch, gate_dtype), "cuda")
    grad_fn = value_and_grad(make_loss_fn(gate_bundle, TrainConfig()))
    mb = {k: v[0::micro] for k, v in batch_at(0).items()}
    real_route, taps = MOE._route, []

    def route(router_w, x, top_k, aux=True):
        w, ids, a = real_route(router_w, x, top_k, aux)
        taps[-1].setdefault(router_w.data_ptr(), ids)
        return w, ids, a

    def pinned_route(router_w, x, top_k, aux=True):
        """``_route`` on the kernels' pass's choices for this layer (its
        router, the key): the router's softmax at those experts,
        normalised, and the aux loss of those choices."""
        ids = taps[0][router_w.data_ptr()]
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        w = probs.gather(-1, ids)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        E, flat = probs.shape[-1], ids.reshape(-1)
        counts = torch.zeros(E, dtype=torch.float32, device=x.device)
        counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
        a = E * torch.sum(probs.mean(0) * counts / ids.numel()) if aux \
            else None
        taps[-1].setdefault(router_w.data_ptr(), ids)
        return w, ids, a

    def tapped(fn, *args, pin=False):
        """``fn`` with each moe layer's routing kept, by its router, in a
        dict of its own; with ``pin``, on the kernels' pass's routing."""
        taps.append({})
        MOE._route = pinned_route if pin else route
        try:
            return fn(*args)
        finally:
            MOE._route = real_route

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_k, _, g_k = tapped(grad_fn, params, mb)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    got, variants = read_launches(), read_variants()
    want = per_microbatch(1)
    check({k: got[k] for k in want} == want
          and sum(got.values()) == sum(want.values())
          and variants["flash_attn_bwd_hd"][fk.bwd_variant(
              getattr(torch, gate_dtype or "bfloat16"), *dims)] == want[
              "flash_attn_bwd_hd"]
          and variants["rglru_scan"]["chunked"] == want["rglru_scan"]
          and variants["slstm_scan"]["cluster"] == want["slstm_scan"],
          f"{ph} {cfg.name}: one microbatch launched {got} {variants}, want "
          f"{want}")
    gate_peak = torch.cuda.max_memory_allocated()

    def plain_grads(pin=False, **blocks):
        saved = (LY.flash_attention, MLA.flash_attention, RG.rglru_scan,
                 XL.slstm_scan)
        LY.flash_attention = MLA.flash_attention = functools.partial(
            ops.flash_attention, impl="blockwise", **blocks)
        RG.rglru_scan, XL.slstm_scan = rglru_scan_ref, slstm_scan_ref
        try:
            return tapped(grad_fn, params, mb, pin=pin)
        finally:
            (LY.flash_attention, MLA.flash_attention, RG.rglru_scan,
             XL.slstm_scan) = saved

    def worst_leaf(ga, gb):
        return max((fro_rel(torch, a, b), name) for (name, a), (_, b) in
                   zip(named_leaves(ga), named_leaves(gb)))

    n = 0
    for name, a in named_leaves(g_k):
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
              f"{ph} {cfg.name}: the gradient of {name} is not finite or "
              f"is zero")
        n += 1
    if on_host:
        print(f"{ph} {cfg.name} one microbatch ({seq} tokens x "
              f"{batch // micro}, bfloat16 compute): loss "
              f"{float(loss_k):.6f}; {n} leaves finite and non-zero; "
              f"launches {got}; {t_kernel:.2f} s (host clock); "
              f"max_memory_allocated {gate_peak / 1e9:.3f} GB")
        del g_k
        torch.cuda.empty_cache()
        worst, leaf = host_gate(torch, cfg, params, mb)
    else:
        t0 = time.perf_counter()
        loss_p, _, g_p = plain_grads()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        check(read_launches() == got, f"{ph} {cfg.name}: the plain versions "
              f"launched a kernel")
        worst, leaf = worst_leaf(g_k, g_p)
        print(f"{ph} {cfg.name} one microbatch ({seq} tokens x "
              f"{batch // micro}, {gate_dtype or 'bfloat16'} compute): loss "
              f"kernels {float(loss_k):.6f}, plain {float(loss_p):.6f}; {n} "
              f"leaves finite and non-zero; worst fro_rel of a leaf's "
              f"gradient {worst:.3e} ({leaf}), bound {tol:g}; kernels "
              f"{t_kernel:.2f} s, plain versions {t_plain:.2f} s (host "
              f"clock); max_memory_allocated {gate_peak / 1e9:.3f} GB after "
              f"the kernels' microbatch, "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB after the "
              f"plain one")
        against_spread = worst
        if n_moe:
            # a bf16 rounding that moves a router's top-k moves which
            # pairs the capacity drops after it: the gate holds the
            # kernels to the plain versions on the kernels' routing, the
            # free routing to twice the plain path's own spread
            moe_routing(torch, cfg, taps, ("kernels", "plain"))
            _, _, g_q = plain_grads(pin=True)
            worst, leaf = worst_leaf(g_k, g_q)
            print(f"{ph} {cfg.name} the plain versions on the kernels' "
                  f"routing: worst fro_rel of a leaf's gradient {worst:.3e} "
                  f"({leaf}), bound {tol:g}")
            del g_q
        check(worst <= tol, f"{ph} {cfg.name}: kernel gradients differ from "
              f"the plain versions': {worst} at {leaf}")
        del g_k
        if spread or n_moe:
            _, _, g_s = plain_grads(block_q=256, block_kv=256)
            floor, floor_leaf = worst_leaf(g_s, g_p)
            print(f"{ph} {cfg.name} the plain path's own spread (256 x 256 "
                  f"attention blocks against 512 x 1024): worst fro_rel "
                  f"{floor:.3e} ({floor_leaf}); the kernels' "
                  f"{against_spread:.3e} is "
                  f"{against_spread / max(floor, 1e-30):.2f} of it, bound 2")
            if n_moe:
                moe_routing(torch, cfg, [taps[1], taps[-1]],
                            ("plain", "256 x 256"))
            check(against_spread <= 2 * floor, f"{ph} {cfg.name}: kernel "
                  f"gradients part from the plain path by more than twice "
                  f"its own spread")
            del g_s
        del g_p
    del taps[:]
    torch.cuda.empty_cache()
    if n_s:
        slstm_train_check(torch, bundle, params, mb)
        torch.cuda.empty_cache()

    # -- the steps ---------------------------------------------------------
    step_fn = run.step_fn
    # the first step's weights, for the CPU step that holds its loss
    params0 = tree_map(lambda t: t.detach().cpu(), params) if reduced \
        else None
    state = adamw.init_opt_state(adamw.AdamWConfig(
        lr=3e-3, warmup_steps=20, total_steps=1000, moment_dtype="fp32"),
        params)                                  # as launch.train.setup
    batches = [batch_at(i) for i in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[i])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        if i == 0:
            norm0 = float(m["grad_norm"])
    launches, variants = read_launches(), read_variants()
    peak = torch.cuda.max_memory_allocated()
    steady = sum(ms[1:]) / len(ms[1:])
    print(f"{ph} {cfg.name} {steps} steps of {batch} x {seq} tokens, "
          f"{micro} microbatches: losses {[round(x, 4) for x in losses]}; "
          f"ms per step {[round(x, 3) for x in ms]} (host clock after "
          f"synchronize), steps 2-{steps} mean {steady:.3f} ms, "
          f"{batch * seq / steady * 1e3:.1f} tokens/s; max_memory_allocated "
          f"{peak / 1e9:.3f} GB; launches {launches}, by variant {variants}")
    check(all(np.isfinite(losses)), f"{ph} {cfg.name}: a loss is not finite: "
          f"{losses}")
    want = per_microbatch(micro * steps)
    check({k: launches[k] for k in want} == want
          and variants["flash_attn_hd"][fwd_v] == want["flash_attn_hd"]
          and variants["flash_attn_bwd_hd"][bwd_v]
          == want["flash_attn_bwd_hd"]
          and variants["rglru_scan"]["chunked"] == want["rglru_scan"]
          and variants["slstm_scan"]["cluster"] == want["slstm_scan"],
          f"{ph} {cfg.name}: launched {launches} {variants}, want {want}")
    check(sum(launches.values()) == sum(want.values()),
          f"{ph} {cfg.name}: training launched another kernel: {launches}")
    check(int(state.step) == steps, f"{ph} the optimizer step count")
    stats = dict(ms=ms, losses=losses, tokens_per_s=batch * seq
                 / steady * 1e3, peak_gb=peak / 1e9, gate_worst=worst)
    if reduced:
        # the same first step on the host: the port's CPU path (its
        # plain versions) on the card's first weights and batch
        cpu = setup(arch, reduced=True, cut=fields, seq_len=seq,
                    global_batch=batch, microbatches=micro, device="cpu")
        b0 = {k: torch.from_numpy(v)
              for k, v in cpu.pipeline.batch_at(0).items()}
        b0.update(_extra_inputs(cfg, batch, seq, np.random.default_rng(123),
                                "cpu"))
        _, _, m = cpu.step_fn(params0, cpu.opt_state, b0)
        host, host_norm = float(m["loss"]), float(m["grad_norm"])
        rel = abs(losses[0] - host) / abs(host)
        rel_norm = abs(norm0 - host_norm) / abs(host_norm)
        print(f"{ph} {cfg.name} first step: card loss {losses[0]:.6f}, "
              f"gradient norm {norm0:.6f}; the port's CPU step on the same "
              f"weights and batch {host:.6f}, {host_norm:.6f}: {rel:.3e} "
              f"and {rel_norm:.3e} apart, bounds {REDUCED_LOSS_RTOL:g} and "
              f"{REDUCED_GNORM_RTOL:g}")
        check(rel <= REDUCED_LOSS_RTOL, f"{ph} {cfg.name}: the card's first "
              f"loss {losses[0]} parts from the CPU's {host} by {rel}")
        # xlstm's bf16 gradients are not reproducible at init (its gate
        # is float32, XLSTM_GATE_DTYPE): its norm is printed, not held
        check(rel_norm <= REDUCED_GNORM_RTOL or cfg.family == "ssm",
              f"{ph} {cfg.name}: the card's first gradient norm {norm0} "
              f"parts from the CPU's {host_norm} by {rel_norm}")
        stats["cpu_loss_rel"], stats["cpu_grad_norm_rel"] = rel, rel_norm
        del cpu, params0
    else:
        device_breakdown(torch, f"{ph} {cfg.name} train step {steps + 1}",
                         lambda: step_fn(params, state, batches[steps]),
                         top=8)
    del run, bundle, gate_bundle, params, state, batches, step_fn, extras
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


def model_steps():
    """(label, arch, cut, seq, batch, microbatches) of every (h) train
    step the run measures, and last of the one-microbatch step (i)
    counts on the card."""
    return [
        ("yi-9b", TRAIN_ARCH, {"n_layers": TRAIN_LAYERS}, TRAIN_SEQ,
         TRAIN_BATCH, TRAIN_MICRO),
        ("gemma2-9b", GEMMA2_ARCH, {"n_layers": GEMMA2_TRAIN_LAYERS},
         TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
        ("recurrentgemma-2b", RG_ARCH, {}, TRAIN_SEQ, TRAIN_BATCH,
         TRAIN_MICRO),
        ("deepseek-v3-671b", DSV3_ARCH, {"n_layers": DSV3_TRAIN_LAYERS,
                                         "dense_layers": DSV3_TRAIN_LAYERS},
         TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
        ("xlstm-125m", XLSTM_ARCH, {}, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
        ("llama-3.2-vision-11b", VLM_ARCH, {"n_layers": VLM_TRAIN_LAYERS},
         TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
        ("qwen3-moe-30b-a3b", QWEN3_ARCH, {"n_layers": QWEN3_TRAIN_LAYERS},
         TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO),
        ("whisper-base", WHISPER_ARCH, {}, WHISPER_MAX_SEQ,
         WHISPER_TRAIN_BATCH, WHISPER_TRAIN_MICRO),
        ("yi-9b one microbatch", TRAIN_ARCH, {"n_layers": TRAIN_LAYERS},
         TRAIN_SEQ, 1, 1),
    ]


def host_models(out_path: str) -> None:
    """(i)'s host process: every ``model_steps`` step counted on fake
    tensors on one device with the kernels' formulas in the plain
    versions' place (``launch.dryrun.step_costs(..., card=True)``), AdamW
    as ``launch.train.setup`` makes it; writes {label: counts} to
    ``out_path`` as JSON."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import step_costs
    from repro_torch.roofline import analysis as RL
    from repro_torch.train.step import TrainConfig

    out = {}
    for label, arch, cut, seq, batch, micro in model_steps():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), **cut)
        counter, _ = step_costs(cfg, "train_4k", global_batch=batch,
                                seq_len=seq, card=True,
                                tcfg=TrainConfig(microbatches=micro))
        cost = counter.cost
        cell = dataclasses.replace(SHAPES["train_4k"], global_batch=batch,
                                   seq_len=seq)
        rep = RL.analyze(cost, arch=arch, shape=label, mesh_name="1x1",
                         n_chips=1,
                         model_flops_total=RL.model_flops(cfg, cell))
        out[label] = dict(
            flops=cost.flops, bytes=cost.hbm_bytes,
            flops_by_type=cost.flops_by_type, t_compute=rep.t_compute,
            t_memory=rep.t_memory, model_flops=rep.model_flops_total,
            peak_bytes=cost.peak_bytes, ops=cost.n_ops,
            kernels=cost.kernels, seconds=time.perf_counter() - t0)
        print(f"host model {label}: {out[label]}", flush=True)
    with open(out_path, "w") as f:
        json.dump(out, f)


def host_dryrun(out_dir: str) -> None:
    """(i)'s second host process: the dry-run's production cells
    (``DRYRUN_CELLS``) through ``launch.dryrun.main``, each writing its
    record, then the reduced cells (``DRYRUN_REDUCED_CELLS``) through
    ``lower_cell``, each record written to ``out_dir`` as
    ``{arch}__{shape}__reduced.json`` (status "error" and the error
    where a cell raises)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell, main

    for arch, shape in DRYRUN_CELLS:
        main(["--arch", arch, "--shape", shape, "--mesh", "single",
              "--force"])
    for arch, shape in DRYRUN_REDUCED_CELLS:
        t0 = time.perf_counter()
        try:
            rec = lower_cell(arch, shape, False, verbose=False,
                             cfg=get_config(arch).reduced(),
                             global_batch=32, seq_len=64)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": repr(e)[-2000:]}
        rec["seconds"] = time.perf_counter() - t0
        print(f"reduced cell {arch} {shape}: {rec['status']} "
              f"{rec['seconds']:.1f} s", flush=True)
        with open(Path(out_dir) / f"{arch}__{shape}__reduced.json", "w") as f:
            json.dump(rec, f, default=str)


def start_host_jobs() -> dict:
    """(i)'s two host processes, started before every card phase so that
    they run beside them, without the card: ``host_models`` and the
    dry-run's production cells, one after the other.  Each writes its
    log (and each cell its record) under ``build/cost_model``; both are
    stopped at exit."""
    out = ROOT / "build" / "cost_model"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               REPRO_TORCH_RESULTS_DIR=str(out),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    me = str(Path(__file__).resolve())
    cmds = {"models": [sys.executable, me, "--host-models",
                       str(out / "host_models.json")],
            "dryrun": [sys.executable, me, "--host-dryrun", str(out)]}
    jobs = {}
    for name, cmd in cmds.items():
        log = open(out / f"{name}.log", "w")
        jobs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log)

    def stop():
        for proc, log in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    atexit.register(stop)
    return jobs


def wait_job(jobs, name: str, timeout: float = 600.0) -> int:
    proc, log = jobs[name]
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    log.flush()
    tail = (ROOT / "build" / "cost_model" / f"{name}.log").read_text()[-3000:]
    check(rc == 0, f"(i) the host's {name} process exited {rc}: {tail}")
    return rc


def cost_model_phase(torch, measured: dict, jobs) -> None:
    """(i) the H100 cost model beside the card: each (h) step's host
    count against its measured ms, one step counted on the card against
    the host's count of it, the dry-run's production cells."""
    from repro_torch.launch.train import setup
    from repro_torch.roofline.op_costs import OpCosts

    t0 = time.perf_counter()
    wait_job(jobs, "models")
    with open(ROOT / "build" / "cost_model" / "host_models.json") as f:
        models = json.load(f)
    print(f"(i) the cost model on {card_line()} (data-sheet rates: "
          f"{BF16_FLOPS_PER_S:.3g} FLOP/s bf16, {FP32_FLOPS_PER_S:.3g} "
          f"FP32, {HBM_BYTES_PER_S:.3g} B/s); host counts on fake tensors "
          f"(one device, the kernels' formulas), measured: the mean of "
          f"steps 2 on in (h)")
    for label, ms in measured.items():
        m = models[label]
        model_ms = 1e3 * max(m["t_compute"], m["t_memory"])
        mfu = m["model_flops"] / (ms / 1e3) / BF16_FLOPS_PER_S
        kern = {k: int(v["launches"]) for k, v in m["kernels"].items()}
        print(f"(i) {label}: {m['flops']:.4e} FLOPs {m['flops_by_type']}, "
              f"{m['bytes']:.4e} bytes; t_compute {1e3 * m['t_compute']:.3f}"
              f" ms, t_memory {1e3 * m['t_memory']:.3f} ms; measured "
              f"{ms:.3f} ms a step: {100 * model_ms / ms:.1f}% of the "
              f"card's bound; mfu {100 * mfu:.2f}% (model FLOPs "
              f"{m['model_flops']:.4e}); modelled peak "
              f"{m['peak_bytes'] / 1e9:.2f} GB, {m['ops']} ops, kernels "
              f"{kern}; counted in {m['seconds']:.1f} s")
        check(model_ms <= MODEL_OVER_MEASURED * ms, f"(i) {label}: the "
              f"modelled {model_ms:.3f} ms passes {MODEL_OVER_MEASURED} x "
              f"the measured {ms:.3f} ms")
    # one microbatch's step counted on the card, the kernels reporting
    label, arch, cut, seq, batch, micro = model_steps()[-1]
    run = setup(arch, reduced=False, cut=cut, seq_len=seq,
                global_batch=batch, microbatches=micro, device="cuda")
    data = {k: torch.from_numpy(v).to("cuda")
            for k, v in run.pipeline.batch_at(0).items()}
    torch.cuda.synchronize()
    with OpCosts() as counter:
        run.step_fn(run.params, run.opt_state, data)
        torch.cuda.synchronize()
    card, host = counter.cost, models[label]
    rel = abs(card.flops - host["flops"]) / host["flops"]
    kern = {k: (int(v["launches"]), v["flops"])
            for k, v in card.kernels.items()}
    print(f"(i) {label} ({batch} x {seq} tokens) counted on the card: "
          f"{card.flops:.6e} FLOPs, {card.hbm_bytes:.4e} bytes, "
          f"{card.n_ops} ops, kernels reported {kern}; the host's fake "
          f"count {host['flops']:.6e} FLOPs, {host['bytes']:.4e} bytes: "
          f"FLOPs {rel:.3e} apart, bound {CARD_COUNT_TOL:g}")
    check(rel <= CARD_COUNT_TOL, f"(i) the card's count of {label} parts "
          f"from the host's by {rel}")
    del run, data
    torch.cuda.empty_cache()
    # the dry-run's production cells, run under the card host's torch
    wait_job(jobs, "dryrun")
    for arch, shape in DRYRUN_CELLS:
        with open(ROOT / "build" / "cost_model"
                  / f"{arch}__{shape}__pod16x16.json") as f:
            rec = json.load(f)
        rl = rec.get("roofline", {})
        print(f"(i) dry-run {arch} {shape} on the (16, 16) mesh of a fake "
              f"group of {rl.get('n_chips')} ranks: status {rec['status']}, "
              f"rules {rec['rules']}, per rank {rl.get('hlo_flops', 0):.4e} "
              f"FLOPs, {rl.get('hlo_bytes', 0):.4e} bytes, collectives "
              f"{rl.get('coll_by_kind')} ({rec.get('collective_ops')} ops); "
              f"t_compute {rl.get('t_compute', 0):.4e} s, t_memory "
              f"{rl.get('t_memory', 0):.4e} s, t_collective "
              f"{rl.get('t_collective', 0):.4e} s, bottleneck "
              f"{rl.get('bottleneck')}; peak {rl.get('mem_per_device')} "
              f"bytes; traced in {rec.get('trace_s')} s")
        check(rec["status"] == "ok", f"(i) the dry-run cell {arch} {shape} "
              f"failed: {rec.get('error')}")
    # the reduced cells whose models once asked this torch for ops it
    # cannot place (roll, a shard turned partial, flip)
    for arch, shape in DRYRUN_REDUCED_CELLS:
        with open(ROOT / "build" / "cost_model"
                  / f"{arch}__{shape}__reduced.json") as f:
            rec = json.load(f)
        rl = rec.get("roofline", {})
        print(f"(i) dry-run {arch} {shape}, reduced config at 32 x 64 "
              f"tokens, on the (16, 16) mesh under torch "
              f"{torch.__version__}: status {rec['status']}, collectives "
              f"{rl.get('coll_by_kind')} ({rec.get('collective_ops')} ops); "
              f"{rec['seconds']:.1f} s")
        check(rec["status"] == "ok", f"(i) the reduced dry-run cell {arch} "
              f"{shape} failed: {rec.get('error')}")
    print(f"(i) done in {time.perf_counter() - t0:.1f} s on the critical "
          f"path (host counts: "
          f"{sum(m['seconds'] for m in models.values()):.1f} s beside "
          f"the card phases)")


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

    started = time.perf_counter()
    # (i)'s host processes run beside every card phase
    jobs = start_host_jobs()

    def mark(what: str) -> None:
        print(f"[{time.perf_counter() - started:.1f} s] done: {what}",
              flush=True)

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
    ptxas = {name: ptxas_report(logs[name], build._nvcc())
             for name in build.SOURCES}
    for name in build.SOURCES:
        for kernel, report in ptxas[name]:
            print(f"  {name}: {kernel}: {report}")
        faults = build.ptxas_faults(logs[name])
        check(not faults, f"ptxas spills or serialises wgmmas in {name}: "
              + "; ".join(faults))

    mark("the kernel build")
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
    mark("the main path")
    flash, flash_256 = flash_phase(torch, ptxas["flash_attn_hd"])
    flash_bwd = flash_bwd_phase(torch)
    mark("the flash phases")
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
    mark("serving yi-9b and the resilience phases")
    # training last, so that every earlier phase runs as it did before
    train_launches, train_variants, stats = train_phase(
        torch, train_cut(TRAIN_ARCH, n_layers=TRAIN_LAYERS), TRAIN_STEPS)
    # (i) reads each (h) step's measured ms: the mean of steps 2 on
    measured = {}

    def steady(label, st):
        measured[label] = sum(st["ms"][1:]) / len(st["ms"][1:])
    steady("yi-9b", stats)
    fault_launches = train_fault_phase(torch)
    # the Dh-256 families' training after it, so that every earlier phase
    # runs as it did before: the two backward kernels at their training
    # shapes, then gemma2-9b (8 layers) and recurrentgemma-2b (full
    # depth), each alone on the card
    torch.cuda.empty_cache()
    flash_bwd_256 = flash_bwd_256_phase(torch, ptxas["flash_attn_bwd_hd"])
    scan_bwd = scan_bwd_phase(torch)
    # the two backward kernels deepseek-v3 and xlstm-125m train through,
    # at their training shapes, beside the others (their training comes
    # last)
    flash_bwd_mla = flash_bwd_mla_phase(torch, ptxas["flash_attn_bwd_hd"])
    slstm_bwd = slstm_bwd_phase(torch)
    mark("yi-9b's training, the fault path, the backward kernels' phases")
    g2t_launches, g2t_variants, stats = train_phase(
        torch, train_cut(GEMMA2_ARCH, n_layers=GEMMA2_TRAIN_LAYERS),
        FAMILY_TRAIN_STEPS)
    steady("gemma2-9b", stats)
    rgt_launches, rgt_variants, stats = train_phase(
        torch, train_cut(RG_ARCH), FAMILY_TRAIN_STEPS, tol=RG_TRAIN_GRAD_TOL,
        spread=True)
    steady("recurrentgemma-2b", stats)
    mark("the Dh-256 families' training")
    # the other families' serving last, so that every earlier phase runs
    # as it did before; each alone on the card (qwen3's weights are 61 GB)
    torch.cuda.empty_cache()
    g2_launches, g2_variants, bundle, params = serve_path(
        torch, GEMMA2_ARCH, "wgmma", "gemma2 serving")
    del bundle, params
    torch.cuda.empty_cache()
    q3_launches, q3_variants, bundle, params = serve_path(
        torch, QWEN3_ARCH, "wgmma", "qwen3 serving", readmit_repeats=False)
    prompt = serve_prompts(bundle.cfg.vocab)[0]
    lone_prompt_repeats(torch, bundle, params, prompt, DECODE_STEPS)
    # the moe gates' expert-parallel dispatch runs on this mesh
    mesh = ep_mesh()
    moe_layer_check(torch, bundle, params, prompt, mesh)
    del bundle, params
    torch.cuda.empty_cache()
    # recurrentgemma last, so that every earlier phase runs as it did
    # before: its scan kernel against its plain version, then its
    # serving.  The reference's Engine resets only `pos` when it reuses
    # a slot, so a re-admitted prompt starts from the last occupant's
    # recurrent state (the port keeps that behaviour): lone prompts
    # from fresh engines take the re-admit gate's place
    scan = scan_phase(torch)
    from repro_torch.configs import get_config
    rg_cfg = get_config(RG_ARCH)
    n_attn = rg_cfg.n_layers // (rg_cfg.rg.pattern + 1)
    n_rec = rg_cfg.n_layers - n_attn
    rg_launches, rg_variants, bundle, params = serve_path(
        torch, RG_ARCH, "wgmma", "recurrentgemma serving",
        readmit_repeats=False,
        per_step={"flash_attn_hd": (n_attn, 0), "rglru_scan": (n_rec, n_rec)},
        step_variants={"rglru_scan": ("chunked", "sequential")})
    lone_prompt_repeats(torch, bundle, params,
                        serve_prompts(bundle.cfg.vocab)[0], DECODE_STEPS)
    del bundle, params
    torch.cuda.empty_cache()
    # xlstm last, so that every earlier phase runs as it did before: its
    # sLSTM kernel against its plain version, then its serving.  Its
    # Engine, like recurrentgemma's, resets only `pos` on a reused slot:
    # lone prompts from fresh engines take the re-admit gate's place
    slstm = slstm_phase(torch, ptxas["slstm_scan"])
    xl_cfg = get_config(XLSTM_ARCH)
    n_slstm = xl_cfg.n_layers // xl_cfg.xlstm.slstm_every
    xl_launches, xl_variants, bundle, params = serve_path(
        torch, XLSTM_ARCH, None, "xlstm serving", readmit_repeats=False,
        per_step={"slstm_scan": (n_slstm, n_slstm)},
        step_variants={"slstm_scan": ("cluster", "step")})
    lone_prompt_repeats(torch, bundle, params,
                        serve_prompts(bundle.cfg.vocab)[0], DECODE_STEPS)
    del bundle, params
    torch.cuda.empty_cache()
    # the vision decoder and the encoder-decoder last, so that every
    # earlier phase runs as it did before; each alone on the card, every
    # admit with the same pool-shaped extra inputs.  llama-vision: 40
    # flash launches a prefill, all wgmma, none in decode; whisper: no
    # kernel at all
    from repro_torch.launch.serve import extra_inputs
    vl_launches, vl_variants, bundle, params = serve_path(
        torch, VLM_ARCH, "wgmma", "vision serving",
        extra_inputs=extra_inputs(get_config(VLM_ARCH), SERVE_SLOTS,
                                  np.random.default_rng(0)))
    del bundle, params
    torch.cuda.empty_cache()
    wh_launches, wh_variants, bundle, params = serve_path(
        torch, WHISPER_ARCH, "wgmma", "whisper serving",
        per_step={"flash_attn_hd": (0, 0)}, max_seq=WHISPER_MAX_SEQ,
        prompts=WHISPER_PROMPTS,
        extra_inputs=extra_inputs(get_config(WHISPER_ARCH), SERVE_SLOTS,
                                  np.random.default_rng(0)))
    del bundle, params
    torch.cuda.empty_cache()
    # deepseek-v3 last, so that every earlier phase runs as it did before:
    # full width, its depth cut to the 3 dense and 2 moe layers; every
    # prefill MLA's naive form, 5 flash wgmma launches at Dh 192 / Dv 128
    # (the RoPE parts as operands of their own), none in decode.
    # Under its capacity one slot's tokens can drop another's, so the
    # lone-prompt gate takes the re-admit gate's place, as for qwen3
    import dataclasses
    ds_cfg = dataclasses.replace(get_config(DSV3_ARCH), n_layers=DSV3_LAYERS)
    ds_launches, ds_variants, bundle, params = serve_path(
        torch, DSV3_ARCH, "wgmma", "deepseek-v3 serving",
        readmit_repeats=False, cfg=ds_cfg)
    prompt = serve_prompts(bundle.cfg.vocab)[0]
    lone_prompt_repeats(torch, bundle, params, prompt, DECODE_STEPS)
    moe_layer_check(torch, bundle, params, prompt, mesh)
    mla_layer = mla_layer_check(torch, bundle, params)
    del bundle, params
    torch.cuda.empty_cache()
    # flash attention as an HDArray device kernel
    hd_launches, hd_variants, hd_by_shape = hd_flash_phase(torch)
    mark("the serving phases and the HDArray flash kernel")
    # deepseek-v3's and xlstm-125m's training last.  deepseek-v3 (2 dense
    # layers and the MTP head) peaks at 78.4 GB of the card's 85: after
    # the earlier phases the allocator's cached blocks were too split up
    # for it (out of memory with 6.7 GiB reserved but free), so from here
    # on the allocator maps expandable segments.  xlstm's profiled step
    # (some 100,000 small launches, host-bound) left the profiler keeping
    # none of a later short window's kernels (the sLSTM serving phase's)
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    dst_launches, dst_variants, stats = train_phase(
        torch, train_cut(DSV3_ARCH, n_layers=DSV3_TRAIN_LAYERS,
                         dense_layers=DSV3_TRAIN_LAYERS), FAMILY_TRAIN_STEPS)
    steady("deepseek-v3-671b", stats)
    torch.cuda.empty_cache()
    xlt_launches, xlt_variants, stats = train_phase(
        torch, train_cut(XLSTM_ARCH), FAMILY_TRAIN_STEPS,
        gate_dtype=XLSTM_GATE_DTYPE)
    steady("xlstm-125m", stats)
    mark("deepseek-v3's and xlstm-125m's training")
    # the last three families' training after every other phase, each
    # alone on the card: llama-3.2-vision-11b (10 layers: two super-blocks
    # and their cross-attentions) and qwen3-moe-30b-a3b (4 layers, the
    # published capacity factor) with the yi-9b traffic, whisper-base
    # whole with its own; its path launches no kernel, so its gate holds
    # the card's float32 gradients to the host's
    torch.cuda.empty_cache()
    vlt_launches, vlt_variants, stats = train_phase(
        torch, train_cut(VLM_ARCH, n_layers=VLM_TRAIN_LAYERS),
        FAMILY_TRAIN_STEPS)
    steady("llama-3.2-vision-11b", stats)
    torch.cuda.empty_cache()
    q3t_launches, q3t_variants, stats = train_phase(
        torch, train_cut(QWEN3_ARCH, n_layers=QWEN3_TRAIN_LAYERS),
        FAMILY_TRAIN_STEPS)
    steady("qwen3-moe-30b-a3b", stats)
    torch.cuda.empty_cache()
    wht_launches, wht_variants, stats = train_phase(
        torch, train_cut(WHISPER_ARCH), FAMILY_TRAIN_STEPS,
        seq=WHISPER_MAX_SEQ, batch=WHISPER_TRAIN_BATCH,
        micro=WHISPER_TRAIN_MICRO, on_host=True)
    steady("whisper-base", stats)
    check(sum(wht_launches.values()) == 0, f"(h) whisper's training "
          f"launched a kernel: {wht_launches}")
    mark("llama-3.2-vision-11b's, qwen3-moe-30b-a3b's and whisper-base's "
         "training")
    # (j) after every earlier phase, so that each runs as it did before:
    # the backward's ffma pair at the widths wgmma does not take, then
    # the training launcher's default, reduced configs at 1024 tokens
    torch.cuda.empty_cache()
    flash_bwd_ffma = flash_bwd_ffma_phase(torch)
    reduced = reduced_launcher_phase(torch)
    mark("(j) the ffma backward and the reduced launcher at 1024 tokens")
    torch.cuda.empty_cache()
    cost_model_phase(torch, measured, jobs)
    mark("(i) the cost model")
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
                                 "(h) gemma2 train":
                                     g2t_launches["flash_attn_hd"],
                                 "(h) recurrentgemma train":
                                     rgt_launches["flash_attn_hd"],
                                 "(h) deepseek-v3 train":
                                     dst_launches["flash_attn_hd"],
                                 "(h) xlstm train":
                                     xlt_launches["flash_attn_hd"],
                                 "(h) llama-vision train":
                                     vlt_launches["flash_attn_hd"],
                                 "(h) qwen3 train":
                                     q3t_launches["flash_attn_hd"],
                                 "(h) whisper train":
                                     wht_launches["flash_attn_hd"],
                                 "gemma2 engine": g2_launches["flash_attn_hd"],
                                 "qwen3 engine": q3_launches["flash_attn_hd"],
                                 "recurrentgemma engine":
                                     rg_launches["flash_attn_hd"],
                                 "xlstm engine": xl_launches["flash_attn_hd"],
                                 "vlm engine": vl_launches["flash_attn_hd"],
                                 "whisper engine":
                                     wh_launches["flash_attn_hd"],
                                 "deepseek-v3 engine":
                                     ds_launches["flash_attn_hd"],
                                 "hd flash kernel": hd_launches}
    flash["launches"] = sum(flash["launches_by_path"].values())
    flash["launches_by_variant"] = {
        k: n + pool_variants[k] + train_variants["flash_attn_hd"][k]
        + g2t_variants["flash_attn_hd"][k] + rgt_variants["flash_attn_hd"][k]
        + dst_variants["flash_attn_hd"][k] + xlt_variants["flash_attn_hd"][k]
        + vlt_variants["flash_attn_hd"][k] + q3t_variants["flash_attn_hd"][k]
        + wht_variants["flash_attn_hd"][k]
        + g2_variants["flash_attn_hd"][k] + q3_variants["flash_attn_hd"][k]
        + rg_variants["flash_attn_hd"][k] + xl_variants["flash_attn_hd"][k]
        + vl_variants["flash_attn_hd"][k] + wh_variants["flash_attn_hd"][k]
        + ds_variants["flash_attn_hd"][k] + hd_variants[k]
        for k, n in serve_variants["flash_attn_hd"].items()}
    # no full-size path launches mma_sync; every Dh 192 / Dv 128 launch
    # is wgmma: deepseek-v3's prefills and the HDArray kernel's apply
    # there
    check(flash["launches_by_variant"]["mma_sync"] == 0,
          f"a path launched flash mma_sync: {flash['launches_by_variant']}")
    mla = flash["wgmma_mla"]
    mla["launches_by_path"] = {
        "deepseek-v3 engine": ds_variants["flash_attn_hd"]["wgmma"],
        "(h) deepseek-v3 train": dst_variants["flash_attn_hd"]["wgmma"],
        "hd flash kernel": hd_by_shape[HD_FLASH_SHAPES[1]]}
    mla["launches"] = sum(mla["launches_by_path"].values())
    mla["mla_layer_naive_vs_absorbed"] = mla_layer
    # every Dh-256 launch: gemma2's and recurrentgemma's prefills and
    # their training
    flash_256["launches_by_path"] = {
        "gemma2 engine": g2_variants["flash_attn_hd"]["wgmma"],
        "recurrentgemma engine": rg_variants["flash_attn_hd"]["wgmma"],
        "(h) gemma2 train": g2t_variants["flash_attn_hd"]["wgmma"],
        "(h) recurrentgemma train": rgt_variants["flash_attn_hd"]["wgmma"]}
    flash_256["launches"] = sum(flash_256["launches_by_path"].values())
    flash["wgmma_dh256_gemma2"] = flash_256
    flash_bwd["launches_by_path"] = {
        "(h) train": train_launches["flash_attn_bwd_hd"],
        "(h) fault path": fault_launches["flash_attn_bwd_hd"],
        "(h) gemma2 train": g2t_launches["flash_attn_bwd_hd"],
        "(h) recurrentgemma train": rgt_launches["flash_attn_bwd_hd"],
        "(h) deepseek-v3 train": dst_launches["flash_attn_bwd_hd"],
        "(h) xlstm train": xlt_launches["flash_attn_bwd_hd"],
        "(h) llama-vision train": vlt_launches["flash_attn_bwd_hd"],
        "(h) qwen3 train": q3t_launches["flash_attn_bwd_hd"],
        "(h) whisper train": wht_launches["flash_attn_bwd_hd"]}
    flash_bwd["launches"] = sum(flash_bwd["launches_by_path"].values())
    flash_bwd["launches_by_variant"] = {
        k: n + g2t_variants["flash_attn_bwd_hd"][k]
        + rgt_variants["flash_attn_bwd_hd"][k]
        + dst_variants["flash_attn_bwd_hd"][k]
        + xlt_variants["flash_attn_bwd_hd"][k]
        + vlt_variants["flash_attn_bwd_hd"][k]
        + q3t_variants["flash_attn_bwd_hd"][k]
        + wht_variants["flash_attn_bwd_hd"][k]
        for k, n in train_variants["flash_attn_bwd_hd"].items()}
    # the Dh 192 / Dv 128 backward: deepseek-v3's training (every backward
    # there is at 192 / 128)
    flash_bwd_mla["launches_by_path"] = {
        "(h) deepseek-v3 train": dst_launches["flash_attn_bwd_hd"]}
    flash_bwd_mla["launches"] = dst_launches["flash_attn_bwd_hd"]
    # the Dh-256 backward: the two training paths' launches (every
    # backward there is Dh 256)
    flash_bwd_256["launches_by_path"] = {
        "(h) gemma2 train": g2t_launches["flash_attn_bwd_hd"],
        "(h) recurrentgemma train": rgt_launches["flash_attn_bwd_hd"]}
    flash_bwd_256["launches"] = sum(
        flash_bwd_256["launches_by_path"].values())
    scan["launches_by_path"] = {"recurrentgemma engine":
                                rg_launches["rglru_scan"],
                                "(h) recurrentgemma train":
                                rgt_launches["rglru_scan"]}
    scan["launches"] = sum(scan["launches_by_path"].values())
    scan["launches_by_variant"] = {
        k: n + rgt_variants["rglru_scan"][k]
        for k, n in rg_variants["rglru_scan"].items()}
    scan["ptxas"] = dict(ptxas["rglru_scan"])
    scan_bwd["launches_by_path"] = {"(h) recurrentgemma train":
                                    rgt_launches["rglru_scan_bwd"]}
    scan_bwd["launches"] = rgt_launches["rglru_scan_bwd"]
    # the scan's entry names its backward's launches too (the same source;
    # its ptxas lines above hold both)
    scan["backward_launches_by_path"] = scan_bwd["launches_by_path"]
    scan_bwd["ptxas"] = {k: r for k, r in ptxas["rglru_scan"]
                         if "bwd" in k or "dlam" in k}
    slstm["launches_by_path"] = {"xlstm engine": xl_launches["slstm_scan"],
                                 "(h) xlstm train": xlt_launches["slstm_scan"]}
    slstm["launches"] = sum(slstm["launches_by_path"].values())
    slstm["launches_by_variant"] = {
        k: n + xlt_variants["slstm_scan"][k]
        for k, n in xl_variants["slstm_scan"].items()}
    slstm_bwd["launches_by_path"] = {"(h) xlstm train":
                                     xlt_launches["slstm_scan_bwd"]}
    slstm_bwd["launches"] = xlt_launches["slstm_scan_bwd"]
    slstm_bwd["ptxas"] = {k: r for k, r in ptxas["slstm_scan"] if "bwd" in k}
    # (j) the reduced launcher's training (head dims 16 and 24 / 16):
    # flash's mma_sync forward and the backward's ffma pair, the scan's
    # and the sLSTM's kernels at the reduced widths
    for arch, (n, by, _) in reduced.items():
        path = f"(j) {arch} reduced train"
        for entry, key in ((flash, "flash_attn_hd"),
                           (flash_bwd, "flash_attn_bwd_hd"),
                           (scan, "rglru_scan"), (scan_bwd, "rglru_scan_bwd"),
                           (slstm, "slstm_scan"),
                           (slstm_bwd, "slstm_scan_bwd")):
            if n[key]:
                entry["launches_by_path"][path] = n[key]
                entry["launches"] += n[key]
        for entry, key in ((flash, "flash_attn_hd"),
                           (flash_bwd, "flash_attn_bwd_hd"),
                           (scan, "rglru_scan"), (slstm, "slstm_scan")):
            for k, x in by[key].items():
                entry["launches_by_variant"][k] += x
    flash_bwd_ffma["launches_by_path"] = {
        f"(j) {arch} reduced train": by["flash_attn_bwd_hd"]["ffma"]
        for arch, (_, by, _) in reduced.items()
        if by["flash_attn_bwd_hd"]["ffma"]}
    flash_bwd_ffma["launches"] = sum(
        flash_bwd_ffma["launches_by_path"].values())
    check(flash_bwd_ffma["launches"] ==
          flash_bwd["launches_by_variant"]["ffma"], "a path outside (j) "
          "launched the backward's ffma pair")
    # the forward at (j)'s shapes, held to its plain version in (j)
    flash["at_ffma_shapes"] = flash_bwd_ffma.pop("forward")
    flash_bwd_ffma["first_loss_vs_cpu"] = {
        arch: st["cpu_loss_rel"] for arch, (_, _, st) in reduced.items()}
    flash_bwd_ffma["first_grad_norm_vs_cpu"] = {
        arch: st["cpu_grad_norm_rel"] for arch, (_, _, st) in reduced.items()}
    print(json.dumps({"kernels": [jac, gemm, flash, flash_bwd,
                                  flash_bwd_256, flash_bwd_mla,
                                  flash_bwd_ffma, scan, scan_bwd, slstm,
                                  slstm_bwd]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-models"] and len(sys.argv) == 3:
        host_models(sys.argv[2])
    elif sys.argv[1:2] == ["--host-dryrun"] and len(sys.argv) == 3:
        host_dryrun(sys.argv[2])
    else:
        main()
