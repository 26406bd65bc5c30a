"""AdamW in plain PyTorch, the port of the reference's
``repro/optim/adamw.py``, with its large-scale options:

  * moment dtype control: fp32 / bf16 / int8-quantized (blockwise)
    first and second moments;
  * gradient compression for the data-parallel mean (none / bf16 /
    int8 stochastic);
  * global-norm clipping, cosine / linear schedules, decoupled weight
    decay.

The reference's is jnp, not a Pallas kernel, and so is this: plain
elementwise PyTorch, every expression in the reference's order of
operations and in float32.

Differences by design:

  * ``apply_updates`` writes the new parameters and moments IN PLACE
    (the reference's is functional) and returns the same tensors, so a
    step holds one copy of each: float32 masters with fp32 moments take
    12 bytes a parameter, plus 4 for the gradients;
  * the step counter, the learning rate, the norm and the clip factor
    are 0-d tensors on the parameters' device, so a step never waits
    for the card;
  * int8 stochastic rounding draws from an explicit ``torch.Generator``
    (the reference splits a ``jax.random`` key per leaf).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "fp32"       # fp32 | bf16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | const
    int8_block: int = 256            # blockwise-quant block size


class OptState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    mu: Any              # tree like params; per moment_dtype (int8: {q, s})
    nu: Any


# ---------------------------------------------------------------------
# int8 blockwise quantization of moments (bitsandbytes-style)
# ---------------------------------------------------------------------
def _q8(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    flat = F.pad(flat, (0, pad))
    blk = flat.reshape(-1, block)
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blk / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.float(), x.shape, pad


def _dq8(q, scale, shape, pad) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _store(x: torch.Tensor, dtype: str, block: int):
    if dtype == "fp32":
        return x
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    q, s, _, _ = _q8(x, block)
    return {"q": q, "s": s}


def _load(x, dtype: str, like: torch.Tensor, block: int) -> torch.Tensor:
    if dtype == "fp32":
        return x
    if dtype == "bf16":
        return x.float()
    pad = (-like.numel()) % block
    return _dq8(x["q"], x["s"], like.shape, pad)


def _store_into(dst, x: torch.Tensor, dtype: str, block: int) -> None:
    """Writes the moment ``x`` into its stored form ``dst`` in place."""
    if dtype == "int8":
        q, s, _, _ = _q8(x, block)
        dst["q"].copy_(q)
        dst["s"].copy_(s)
    elif x is not dst:
        dst.copy_(x)


# ---------------------------------------------------------------------
def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int), float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def init_opt_state(cfg: AdamWConfig, params) -> OptState:
    def zero(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device),
                      cfg.moment_dtype, cfg.int8_block)

    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zero, params), nu=tree_map(zero, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def apply_updates(cfg: AdamWConfig, params, grads, state: OptState,
                  decay_mask: Optional[Any] = None):
    """One AdamW step, in place.  Returns (params, state, metrics): the
    same parameter and moment tensors, now updated, and a new step
    counter."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.clip_norm else 1.0)
    lr = schedule_lr(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    md, blk = cfg.moment_dtype, cfg.int8_block

    def upd(p, g, mu_s, nu_s, wd_on):
        g = g.float() * scale
        mu = _load(mu_s, md, p, blk)
        nu = _load(nu_s, md, p, blk)
        # the reference's cfg.b1 * mu + (1 - cfg.b1) * g, in place
        mu = mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu = nu.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            delta = delta.add_(cfg.weight_decay * wd_on * p.float())
        delta = delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_((p.float() - delta).to(p.dtype))
        _store_into(mu_s, mu, md, blk)
        _store_into(nu_s, nu, md, blk)

    if decay_mask is None:
        decay_mask = tree_map(lambda p: float(p.dim() >= 2), params)
    tree_map(upd, params, grads, state.mu, state.nu, decay_mask)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.mu, state.nu), metrics


# ---------------------------------------------------------------------
# gradient compression for the data-parallel mean
# ---------------------------------------------------------------------
def compress_grads(grads, mode: str,
                   generator: Optional[torch.Generator] = None):
    """Cast or quantize gradients before the data-parallel mean.  int8
    uses stochastic rounding, with noise from ``generator`` (on the
    gradients' device), to stay unbiased."""
    if mode in (None, "none"):
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    if mode == "int8":
        def q(g):
            s = g.abs().amax() / 127.0 + 1e-12
            noise = torch.rand(g.shape, generator=generator,
                               device=g.device) - 0.5
            return (torch.clamp(torch.round(g / s + noise), -127, 127)
                    .to(torch.int8), s)
        return tree_map(q, grads)
    raise ValueError(mode)


def decompress_grads(grads, mode: str):
    if mode in (None, "none"):
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.float(), grads)
    if mode == "int8":
        return tree_map(lambda t: t[0].float() * t[1], grads,
                        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                        and isinstance(x[0], torch.Tensor))
    raise ValueError(mode)
