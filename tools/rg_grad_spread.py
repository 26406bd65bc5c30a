#!/usr/bin/env python3
"""How far apart correct bf16 gradients of recurrentgemma-2b lie: the
measurement behind chip_smoke.py's RG_TRAIN_GRAD_TOL.

    python3 tools/rg_grad_spread.py

Needs one CUDA card and nvcc.  Builds recurrentgemma-2b at full width
and depth (26 layers) with float32 masters and seeded weights, takes one
microbatch of chip_smoke.py's training traffic (1 x 4096 tokens) and
computes every parameter's gradient five ways:

* R: the float32 model through the plain versions (blockwise attention,
  the plain scan loop), the yardstick;
* P: the bf16 model through the plain versions;
* P': P with the blockwise attention's blocks at 256 x 256 in place of
  512 x 1024 (the same function, summed in another order);
* A: the bf16 model through the kernels (flash and its backward, the
  scan and its backward), as training runs on the card;
* C: the bf16 model with the scan kernels and the plain attention.

It prints, for each pair, the worst and the median Frobenius-relative
distance over the leaves and the worst leaves' names: P' against P is
the bf16 spread of two plain paths, A and P against R each bf16 path's
distance from float32.  About 4 minutes, nearly all of it the plain
scan's Python loop.
"""
from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
SEQ, BATCH = 4096, 2            # chip_smoke.py's TRAIN_SEQ, TRAIN_BATCH


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("rg_grad_spread: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.models.layers as LY
    import repro_torch.models.rglru as RG
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import build
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)

    print(torch.cuda.get_device_name(0))
    cfg = get_config(ARCH)
    pipe = TokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH, seed=0))
    mb = {k: torch.from_numpy(v[0::2]).to("cuda")
          for k, v in pipe.batch_at(0).items()}
    kernel_flash, kernel_scan = LY.flash_attention, RG.rglru_scan
    plain_flash = functools.partial(ops.flash_attention, impl="blockwise")
    params = build(cfg, torch.bfloat16, "cuda").init(0, dtype=torch.float32)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, t in tree.items():
                yield from leaves(t, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, (list, tuple)):
            for i, t in enumerate(tree):
                yield from leaves(t, f"{prefix}/{i}")
        else:
            yield prefix, tree

    def grads(label, dtype, flash, scan):
        bundle = build(cfg, dtype, "cuda")
        LY.flash_attention, RG.rglru_scan = flash, scan
        try:
            t0 = time.perf_counter()
            loss, _, g = value_and_grad(make_loss_fn(bundle, TrainConfig()))(
                params, mb)
            torch.cuda.synchronize()
        finally:
            LY.flash_attention, RG.rglru_scan = kernel_flash, kernel_scan
        print(f"{label}: loss {float(loss):.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return dict(leaves(g))

    def spread(label, x, y):
        d = sorted(((float(torch.linalg.norm((x[k] - y[k]).double())
                           / torch.linalg.norm(y[k].double())), k)
                    for k in x), reverse=True)
        print(f"{label}: worst {d[0][0]:.3e}, median "
              f"{d[len(d) // 2][0]:.3e}; worst leaves "
              + ", ".join(f"{k} {e:.3e}" for e, k in d[:4]), flush=True)

    R = grads("R (float32, plain)", torch.float32, plain_flash,
              rglru_scan_ref)
    P = grads("P (bf16, plain)", torch.bfloat16, plain_flash, rglru_scan_ref)
    spread("P against R", P, R)
    P2 = grads("P' (bf16, plain, 256 x 256 blocks)", torch.bfloat16,
               functools.partial(plain_flash, block_q=256, block_kv=256),
               rglru_scan_ref)
    spread("P' against P", P2, P)
    del P2
    A = grads("A (bf16, kernels)", torch.bfloat16, kernel_flash, kernel_scan)
    spread("A against R", A, R)
    spread("A against P", A, P)
    del A
    C = grads("C (bf16, plain attention, scan kernels)", torch.bfloat16,
              plain_flash, kernel_scan)
    spread("C against P", C, P)


if __name__ == "__main__":
    main()
