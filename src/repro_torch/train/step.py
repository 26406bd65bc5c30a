"""Train-step factory: loss -> grad -> AdamW, microbatched, the port of
the reference's ``repro/train/step.py``.

  * microbatch gradient accumulation (the reference's ``lax.scan``, a
    Python loop here): microbatch m takes rows m, m + M, m + 2M, ... of
    the batch, the reference's interleaved split;
  * accumulator dtype fp32 (default) or bf16;
  * grad compression (bf16 / int8) applied before the update, as the
    reference applies it before the data-parallel mean;
  * the loss stack: CE (+ MoE aux + MTP CE where a family has them),
    float32; the fused head + CE path for vocabularies of 65536 and up.

Gradients come from ``torch.autograd.grad`` with respect to detached
views of the parameter leaves, so the caller's tensors never carry
autograd state; the update writes them in place
(``optim.adamw.apply_updates``).  The step runs as it is on DTensor
parameters and batches too: the dry-run (``launch/dryrun.py``) traces
it so, placed by ``train/sharding.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.common import cross_entropy_loss, roll
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    accum_dtype: str = "fp32"        # fp32 | bf16
    grad_compress: str = "none"      # none | bf16 | int8
    mtp_weight: float = 0.3          # deepseek-v3 MTP aux loss weight
    aux_weight: float = 0.01         # MoE load-balance aux weight
    param_dtype: str = "fp32"        # fp32 | bf16 (storage dtype)
    fused_ce: bool = True            # chunked head+CE when the arch has it


def cast_params(params, tcfg: TrainConfig):
    if tcfg.param_dtype == "bf16":
        return tree_map(lambda p: p.to(torch.bfloat16)
                        if p.dtype == torch.float32 else p, params)
    return params


def make_loss_fn(bundle, tcfg: TrainConfig) -> Callable:
    # the fused CE pays a chunked-loop overhead; it only wins when the
    # (B, S, V) logits are big: the reference's gate on the vocabulary
    big_vocab = getattr(bundle, "cfg", None) and bundle.cfg.vocab >= 65536
    if (tcfg.fused_ce and big_vocab
            and getattr(bundle, "forward_fused", None) is not None):
        def fused_loss_fn(params, batch):
            loss, metrics = bundle.forward_fused(params, batch)
            if "mtp" in metrics:
                loss = loss + tcfg.mtp_weight * metrics["mtp"]
            if "aux" in metrics:
                loss = loss + tcfg.aux_weight * metrics["aux"]
            return loss, metrics
        return fused_loss_fn

    def loss_fn(params, batch):
        logits, out = bundle.forward(params, batch)
        mask = batch.get("mask")
        loss = cross_entropy_loss(logits, batch["labels"], mask)
        metrics = {"ce": loss}
        if "mtp_logits" in out:
            # MTP predicts token t+2 from position t (labels shifted once
            # more); ignore the wrapped tail via the mask.
            labels2 = roll(batch["labels"], -1, 1)
            mtp = cross_entropy_loss(out["mtp_logits"], labels2, mask)
            loss = loss + tcfg.mtp_weight * mtp
            metrics["mtp"] = mtp
        aux = out.get("aux_loss")
        if aux is not None:
            loss = loss + tcfg.aux_weight * aux
            metrics["aux"] = aux
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """(params, batch) -> (loss, metrics, grads), all detached; grads
    shaped like params."""
    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))
    return grad_fn


def make_train_step(bundle, opt_cfg: adamw.AdamWConfig,
                    tcfg: TrainConfig = TrainConfig()) -> Callable:
    """Returns train_step(params, opt_state, batch) ->
    (params, opt_state, metrics); params and moments are updated in
    place."""
    grad_fn = value_and_grad(make_loss_fn(bundle, tcfg))
    acc_dt = torch.bfloat16 if tcfg.accum_dtype == "bf16" else torch.float32

    def train_step(params, opt_state, batch):
        M = tcfg.microbatches
        if M <= 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            # Interleaved split: microbatch m takes every M-th row, as
            # the reference's reshape(B // M, M, ...).swapaxes(0, 1)
            gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                           device=opt_state.step.device)
            for m in range(M):
                mb = {k: v[m::M] for k, v in batch.items()}
                loss_m, _, g = grad_fn(params, mb)
                # zeros + g equals g: the first sum starts from g itself
                gsum = (tree_map(lambda gi: gi.to(acc_dt), g) if gsum is None
                        else tree_map(lambda a, gi: a.add_(gi.to(acc_dt)),
                                      gsum, g))
                lsum = lsum + loss_m
                del g
            grads = tree_map(lambda a: a.div_(M).float(), gsum)
            loss = lsum / M
            metrics = {"ce": loss}

        if tcfg.grad_compress != "none":
            # the reference draws its int8 rounding noise from a fixed
            # key, PRNGKey(0), every step; so does this generator
            gen = None
            if tcfg.grad_compress == "int8":
                gen = torch.Generator(device=opt_state.step.device)
                gen.manual_seed(0)
            c = adamw.compress_grads(grads, tcfg.grad_compress, gen)
            grads = adamw.decompress_grads(c, tcfg.grad_compress)

        params, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(bundle, tcfg: TrainConfig = TrainConfig()) -> Callable:
    loss_fn = make_loss_fn(bundle, tcfg)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
