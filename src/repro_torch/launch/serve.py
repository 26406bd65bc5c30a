"""Serving launcher: batched prefill/decode with the slot Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --full

runs on the card by default (``--device cpu`` runs on the host, at the
reduced size unless ``--full``).  Weights are random, drawn from a
``torch.Generator`` seeded with 0; whisper's audio frames and
llama-vision's image embeddings are standard normals from
``numpy.random.default_rng(0)``, one row a slot, passed to every
request.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig


def load_engine(arch: str, *, reduced: bool = True, slots: int = 4,
                max_seq: int = 256, temperature: float = 0.0,
                seed: int = 0, device: str = "cuda") -> Engine:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    bundle = build(cfg, torch.bfloat16, device)
    params = bundle.init(seed)
    return Engine(bundle, params,
                  ServeConfig(max_seq=max_seq, slots=slots,
                              temperature=temperature), seed=seed)


def extra_inputs(cfg, slots: int, rng: np.random.Generator):
    """The encoder-decoder's audio frames and the vision decoder's image
    embeddings, pool-shaped float32 arrays of standard normals from
    ``rng`` (the conv frontend and the vision tower are stubs, as in
    the reference); empty for the other families."""
    extra = {}
    if cfg.encdec is not None:
        extra["frames"] = np.asarray(
            rng.standard_normal((slots, cfg.encdec.n_frames, cfg.d_model)),
            np.float32)
    if cfg.vision is not None:
        extra["image_embeds"] = np.asarray(
            rng.standard_normal((slots, cfg.vision.n_image_tokens,
                                 cfg.vision.d_vision)), np.float32)
    return extra


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    # the reference launcher's default (repro/launch/serve.py)
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    eng = load_engine(args.arch, reduced=not args.full, slots=args.slots,
                      max_seq=args.max_seq, temperature=args.temperature,
                      device=args.device)
    rng = np.random.default_rng(0)
    cfg = eng.cfg
    extra = extra_inputs(cfg, args.slots, rng)
    _sync(args.device)
    t0 = time.perf_counter()
    n_tok = 0
    for r in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len)
        out = eng.generate(prompt, args.tokens, extra_inputs=extra or None)
        n_tok += args.tokens
        print(f"[serve] req {r}: prompt {args.prompt_len} -> "
              f"{out[args.prompt_len:][:16]} ...")
    _sync(args.device)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s) on {eng.device}")


if __name__ == "__main__":
    main()
