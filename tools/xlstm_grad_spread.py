#!/usr/bin/env python3
"""How far apart correct gradients of xlstm-125m lie, in bf16 and in
float32 compute, and where the bf16 spread arises: the measurement
behind chip_smoke.py's XLSTM_GATE_DTYPE.

    python3 tools/xlstm_grad_spread.py [T ...]
    python3 tools/xlstm_grad_spread.py --bisect [T ...]

Needs one CUDA card (and nvcc for the first form).  Builds xlstm-125m at
full width and depth (10 mLSTM, 2 sLSTM layers) with float32 masters and
seeded weights, and takes one microbatch of chip_smoke.py's training
traffic (1 x 4096 tokens, its first T where given).

The first form (default T 256, 1024 and 4096) computes every parameter's
gradient three ways in each compute type:

* K: through the sLSTM kernels (the forward and its backward), as
  training runs on the card;
* P: through the plain float32 sLSTM loop (autograd);
* P64: through the same loop in float64 (its hs cast back to the
  compute type, as the kernel's float32 hs is).

It prints, for each T and type, the worst and the median
Frobenius-relative distance over the leaves of K from P, P from P64
(two plain paths that differ only in the loop's precision) and K from
P64, with the worst leaves' names.  About 2 minutes, nearly all of it
the plain loops.

``--bisect`` (default T 256) runs P and P64 in bf16 alone, every layer
outside torch.utils.checkpoint (the same gradients), and prints:

* block by block, from the last down (an mLSTM block a chunk of 256
  tokens: one at T 256), the Frobenius-relative change of the gradient
  between P and P64 at each mLSTM chunk's output and at its inputs q,
  k, v, ig, fg, and at each sLSTM's hs and pre_x;
* P against P64 at the leaves (worst, median) with the mLSTM chunks as
  they are, computed in float64, with their normaliser max(|den|,
  exp(-m)) made smooth as sqrt(den**2 + exp(-2 m)) (a diagnostic: not
  the model), and both.

About 1 minute; no kernel is built.
"""
from __future__ import annotations

import inspect
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm-125m"
SEQ, BATCH = 4096, 2            # chip_smoke.py's TRAIN_SEQ, TRAIN_BATCH
NORMALISER = "torch.maximum(den, torch.exp(-m_new))"
SMOOTH = "torch.sqrt(den * den + torch.exp(-2 * m_new))"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("xlstm_grad_spread: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    import repro_torch.models.hybrid as HY
    import repro_torch.models.xlstm as XL
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    from repro_torch.models import build
    from repro_torch.tree import tree_leaves
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)

    print(torch.cuda.get_device_name(0))
    args = sys.argv[1:]
    bisect = "--bisect" in args
    lengths = [int(a) for a in args if a != "--bisect"] \
        or ([256] if bisect else [256, 1024, SEQ])
    cfg = get_config(ARCH)
    pipe = TokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH, seed=0))
    mb = {k: torch.from_numpy(v[0::2]).to("cuda")
          for k, v in pipe.batch_at(0).items()}
    params = build(cfg, torch.bfloat16, "cuda").init(0, dtype=torch.float32)
    kernel_scan, real_chunk = XL.slstm_scan, XL._mlstm_chunk

    def scan64(pre_x, r, state=None, out=None):
        return slstm_scan_ref(pre_x.double(), r.double(), state)

    def grads(dtype, scan, T, chunk=real_chunk):
        bundle = build(cfg, dtype, "cuda")
        XL.slstm_scan, XL._mlstm_chunk = scan, chunk
        try:
            _, _, g = value_and_grad(make_loss_fn(bundle, TrainConfig()))(
                params, {k: v[:, :T] for k, v in mb.items()})
            torch.cuda.synchronize()
        finally:
            XL.slstm_scan, XL._mlstm_chunk = kernel_scan, real_chunk
        return g

    def names(tree, prefix=""):
        if isinstance(tree, dict):
            for k, t in tree.items():
                yield from names(t, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, (list, tuple)):
            for i, t in enumerate(tree):
                yield from names(t, f"{prefix}/{i}")
        else:
            yield prefix

    keys = list(names(params))

    def fro(a, b):
        return float(torch.linalg.norm((a - b).double())
                     / torch.linalg.norm(b.double()))

    def spread(label, x, y):
        d = sorted(((fro(a, b), k) for k, a, b in
                    zip(keys, tree_leaves(x), tree_leaves(y))), reverse=True)
        print(f"  {label}: worst {d[0][0]:.3e}, median "
              f"{d[len(d) // 2][0]:.3e}; worst leaves "
              + ", ".join(f"{k} {e:.3e}" for e, k in d[:3]), flush=True)

    if not bisect:
        for dtype in (torch.bfloat16, torch.float32):
            for T in lengths:
                t0 = time.perf_counter()
                K = grads(dtype, kernel_scan, T)
                P = grads(dtype, slstm_scan_ref, T)
                P64 = grads(dtype, scan64, T)
                print(f"{str(dtype)[6:]} compute, T {T} "
                      f"({time.perf_counter() - t0:.1f} s):", flush=True)
                spread("K against P", K, P)
                spread("P against P64", P, P64)
                spread("K against P64", K, P64)
                del K, P, P64
        return

    # -- --bisect: where the bf16 spread arises ------------------------
    HY.checkpoint = lambda fn, *a, **kw: fn(*a)
    src = inspect.getsource(real_chunk)
    assert NORMALISER in src
    ns = dict(vars(XL))
    exec(src.replace(NORMALISER, SMOOTH), ns)
    smooth_chunk = ns["_mlstm_chunk"]

    def in_f64(chunk):
        def run(q, k, v, ig, fg, state):
            out, st = chunk(q.double(), k.double(), v.double(), ig.double(),
                            fg.double(), tuple(s.double() for s in state))
            return out.float(), tuple(s.float() for s in st)
        return run

    def tapped(scan, T):
        """P or P64's gradients in bf16, with each block's taps."""
        taps = []

        def hook(got, name, t):
            t.register_hook(lambda g: got.__setitem__(name, g.detach()))

        def chunk(q, k, v, ig, fg, state):
            got = {}
            for name, t in zip(("q", "k", "v", "ig", "fg"),
                               (q, k, v, ig, fg)):
                hook(got, name, t)
            out, st = real_chunk(q, k, v, ig, fg, state)
            hook(got, "out", out)
            taps.append(("mLSTM", got))
            return out, st

        def sl(pre_x, r, state=None, out=None):
            got = {}
            hook(got, "pre_x", pre_x)
            hs, fin = scan(pre_x, r, state, out)
            hook(got, "hs", hs)
            taps.append(("sLSTM", got))
            return hs, fin
        return grads(torch.bfloat16, sl, T, chunk), taps

    for T in lengths:
        t0 = time.perf_counter()
        P, tp = tapped(slstm_scan_ref, T)
        P64, t64 = tapped(scan64, T)
        print(f"bf16 compute, T {T}: the gradient's change, P against P64, "
              f"block by block from the last ({time.perf_counter() - t0:.1f}"
              f" s):", flush=True)
        for j in reversed(range(len(tp))):
            kind, a = tp[j]
            b = t64[j][1]
            print(f"  {kind} {j + 1:2d}: " + ", ".join(
                f"{k} {fro(a[k], b[k]):.3e}" for k in sorted(a)), flush=True)
        spread("leaves, the mLSTM chunks as they are", P, P64)
        del P, P64, tp, t64
        for label, chunk in (("in float64", in_f64(real_chunk)),
                             ("with the smooth normaliser", smooth_chunk),
                             ("in float64 with the smooth normaliser",
                              in_f64(smooth_chunk))):
            spread(f"leaves, the mLSTM chunks {label}",
                   grads(torch.bfloat16, slstm_scan_ref, T, chunk),
                   grads(torch.bfloat16, scan64, T, chunk))


if __name__ == "__main__":
    main()
