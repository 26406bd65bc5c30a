"""End-to-end training driver: data pipeline -> train step ->
checkpointing + fault tolerance + straggler monitoring, the port of the
reference's ``repro/launch/train.py``.

Trains every registered family (full, ``reduced``, or with its depth
``cut``) on one card, or on the CPU with ``device="cpu"``: the dense,
moe (the sort dispatch under the config's capacity factor, the
load-balance aux loss) and MLA decoders, the RG-LRU hybrid, the xLSTM
LM, the vision decoder and the encoder-decoder, the last two with the
reference's extra inputs (image embeddings, audio frames:
``_extra_inputs``, bf16 on the run's device).  ``chip_smoke.py`` trains
each at full width on one H100: yi-9b with 8 of its 48 layers,
gemma2-9b with 8 of 42, deepseek-v3-671b with its 2 leading dense
layers and the MTP head, llama-3.2-vision-11b with 10 of 40 (two
super-blocks), qwen3-moe-30b-a3b with 4 of 48, and recurrentgemma-2b,
xlstm-125m and whisper-base whole:

  * deterministic resumable pipeline: restore replays the exact stream;
  * atomic async checkpoints with keep-k, auto-restore of the newest
    committed step;
  * StepGuard retry-from-checkpoint on TransientFault (inject with
    ``--inject-fault N``), the straggler EWMA monitor (host clock per
    step, after the step's loss is read back);
  * microbatch accumulation, grad compression, moment-dtype options.

Compute is bfloat16 on float32 masters, as the reference's
(``build(cfg)`` then ``bundle.init``).  On the card every layer's
attention at ``FLASH_MIN_T`` tokens or more runs the hand-written flash
kernels, forward and backward.

    python -m repro_torch.launch.train --arch yi-9b --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.ft.faults import FaultInjector, StepGuard, StragglerMonitor
from repro_torch.models import build
from repro_torch.models.common import resolve_device
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step


@dataclasses.dataclass
class TrainRun:
    """Everything main() assembles; importable for tests and scripts."""
    cfg: Any
    bundle: Any
    step_fn: Any
    params: Any
    opt_state: Any
    pipeline: TokenPipeline
    ckpt: Optional[CheckpointManager]
    monitor: StragglerMonitor
    losses: list


def _extra_inputs(cfg, B, S, rng, device="cpu"):
    """The extra model inputs of the encoder-decoder (audio frames) and
    vision (image embeddings) families: bf16 standard normals from
    ``rng`` on ``device``, as the reference's; empty for the others."""
    d = {}
    if cfg.encdec is not None:
        d["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model))).to(
                device=device, dtype=torch.bfloat16)
    if cfg.vision is not None:
        d["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision.n_image_tokens, cfg.vision.d_vision))).to(
                device=device, dtype=torch.bfloat16)
    return d


def setup(arch: str, *, reduced: bool = True,
          cut: Optional[Dict[str, Any]] = None, seq_len: int = 128,
          global_batch: int = 8, microbatches: int = 1, lr: float = 3e-3,
          ckpt_dir: Optional[str] = None, seed: int = 0,
          grad_compress: str = "none", moment_dtype: str = "fp32",
          total_steps: int = 1000, device="cuda") -> TrainRun:
    """The reference's ``setup`` on ``device`` ("cuda" by default;
    raises without a card).  ``cut`` replaces fields of the
    configuration after ``reduced``: a depth cut such as
    ``{"n_layers": 10}`` keeps a full-width model's training state on
    one card.  Parameters come from a generator seeded with ``seed``,
    float32."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    bundle = build(cfg, torch.bfloat16, dev)
    params = bundle.init(seed, dtype=torch.float32)
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=total_steps,
                             moment_dtype=moment_dtype)
    tcfg = TrainConfig(microbatches=microbatches, grad_compress=grad_compress)
    step_fn = make_train_step(bundle, ocfg, tcfg)
    opt_state = adamw.init_opt_state(ocfg, params)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                    global_batch=global_batch, seed=seed))
    ckpt = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    return TrainRun(cfg, bundle, step_fn, params, opt_state, pipe, ckpt,
                    StragglerMonitor(), [])


def train(run: TrainRun, steps: int, *, start_step: int = 0,
          ckpt_every: int = 50, inject_faults=(), log_every: int = 10,
          resume: bool = True, verbose: bool = True) -> Dict[str, Any]:
    cfg = run.cfg
    dev = run.bundle.device
    injector = FaultInjector(inject_faults)
    state = {"params": run.params, "opt": run.opt_state}
    step0 = start_step
    if run.ckpt and resume and run.ckpt.latest_step() is not None:
        step0, state = run.ckpt.restore(None, state)
        if verbose:
            print(f"[train] resumed from checkpoint step {step0}")

    def restore_fn():
        return run.ckpt.restore(None, state)

    guard = StepGuard(restore_fn) if run.ckpt else None
    rng = np.random.default_rng(123)
    extras = _extra_inputs(cfg, run.pipeline.cfg.global_batch,
                           run.pipeline.cfg.seq_len, rng, dev)
    i = step0
    t_start = time.time()
    while i < steps:
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in run.pipeline.batch_at(i).items()}
        batch.update(extras)

        def one_step():
            injector.maybe_fail(i)
            return run.step_fn(state["params"], state["opt"], batch)

        t0 = time.time()
        if guard is not None:
            out, recovery = guard.run(i, one_step)
            if recovery is not None:
                i, state = recovery  # replay from restored step
                if verbose:
                    print(f"[train] fault -> restored to step {i}, replaying")
                continue
            p, o, metrics = out
        else:
            p, o, metrics = one_step()
        state = {"params": p, "opt": o}
        loss = float(metrics["loss"])      # waits for the step
        dt = time.time() - t0
        run.losses.append(loss)
        straggler = run.monitor.observe(i, dt)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"[train] step {i:5d} loss {loss:.4f} "
                  f"({dt*1000:.0f} ms{' STRAGGLER' if straggler else ''})")
        i += 1
        if run.ckpt and i % ckpt_every == 0:
            run.ckpt.save_async(i, state)
    if run.ckpt:
        run.ckpt.wait()
        run.ckpt.save(steps, state)
    run.params, run.opt_state = state["params"], state["opt"]
    return {"final_loss": run.losses[-1] if run.losses else None,
            "losses": run.losses,
            "wall_s": time.time() - t_start,
            "stragglers": len(run.monitor.events),
            "recoveries": guard.recoveries if guard else []}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--full", action="store_true",
                    help="exact assigned config (default: reduced)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-fault", type=int, action="append", default=[])
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run = setup(args.arch, reduced=not args.full, seq_len=args.seq,
                global_batch=args.batch, microbatches=args.microbatches,
                lr=args.lr, ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                grad_compress=args.grad_compress, device=args.device)
    out = train(run, args.steps, ckpt_every=args.ckpt_every,
                inject_faults=args.inject_fault)
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"in {out['wall_s']:.1f}s, stragglers={out['stragglers']}, "
          f"recoveries={out['recoveries']}")


if __name__ == "__main__":
    main()
