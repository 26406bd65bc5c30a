"""RecurrentGemma's recurrent block (arXiv:2402.19427), the port of the
reference's ``repro/models/rglru.py``: the RG-LRU block with its
temporal conv, mixed 2:1 with local attention by ``models/hybrid.py``.

The recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
runs in ``kernels/rglru_scan``: on the card the hand-written kernel
(``csrc/rglru_scan.cu``, one launch a block: its ``chunked`` variant
for a prefill, its ``sequential`` one for a decode step), on the CPU
its plain float32 loop.  The reference
runs it as an ``associative_scan``; the two round in another order,
within 1e-5 relative in float32.

Parameters are one dict per layer, drawn from a ``torch.Generator``
with the reference's scales: the matrices and the conv taps in the
given dtype, ``lam`` and the biases float32 (every use casts them as
the reference does).  The conv and the products are plain PyTorch:
neither is a kernel in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan

from .common import add_bias, resolve_device
from .layers import _normal

Params = Dict[str, torch.Tensor]


def rglru_params(gen: torch.Generator, cfg, *, dtype=torch.float32,
                 device="cuda") -> Params:
    """One recurrent block's weights (the reference's ``rglru_params``
    for one of its ``L`` stacked layers)."""
    D, W, cw = cfg.d_model, cfg.rg.lru_width, cfg.rg.conv_width
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    zeros = lambda: torch.zeros((W,), dtype=torch.float32,  # noqa: E731
                                device=device)
    return {
        "w_x": _normal(gen, (D, W), 1 / math.sqrt(D), **kw),   # input branch
        "w_g": _normal(gen, (D, W), 1 / math.sqrt(D), **kw),   # gate (GeLU)
        "conv_w": _normal(gen, (cw, W), 1 / math.sqrt(cw), **kw),
        "conv_b": zeros(),
        "w_a": _normal(gen, (W, W), 0.1 / math.sqrt(W), **kw),  # a gate
        "b_a": zeros(),
        "w_i": _normal(gen, (W, W), 0.1 / math.sqrt(W), **kw),  # input gate
        "b_i": zeros(),
        # a = exp(-8 softplus(lam) sigmoid(.)): lam 4 starts a near 0
        "lam": torch.full((W,), 4.0, dtype=torch.float32, device=device),
        "w_out": _normal(gen, (W, D), 1 / math.sqrt(W), **kw),
    }


# the reference's specs (``repro/models/rglru.py:44-55``) without "layers"
RGLRU_SPECS = {"w_x": ("embed", "lru"), "w_g": ("embed", "lru"),
               "conv_w": ("conv", "lru"), "conv_b": ("lru",),
               "w_a": ("lru", "lru_in"), "b_a": ("lru",),
               "w_i": ("lru", "lru_in"), "b_i": ("lru",), "lam": ("lru",),
               "w_out": ("lru", "embed")}


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal depthwise conv of width cw.  x (B, T, W), w (cw, W);
    state (B, cw-1, W): the trailing inputs of the previous chunk.
    Returns (out, new_state), summed tap by tap in x's dtype as the
    reference."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, T+cw-1, W)
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * w[i] for i in range(cw)) + b
    new_state = xp[:, -(cw - 1):, :] if cw > 1 else None
    return out, new_state


def rglru_block(p: Params, x: torch.Tensor, cfg, *,
                cache: Optional[Dict[str, torch.Tensor]] = None):
    """One recurrent block: in-proj (x and gate), conv1d, RG-LRU,
    out-proj.  cache = {h (B, W) float32, conv (B, cw-1, W)}; returns
    (out, new_cache) with new_cache = {h: the last step's state, conv:
    the trailing inputs}, or None without a cache."""
    cdt = x.dtype
    xb = x @ p["w_x"].to(cdt)                                  # (B, T, W)
    gb = F.gelu(x @ p["w_g"].to(cdt), approximate="tanh")
    conv_state = cache["conv"] if cache is not None else None
    xb, new_conv = _conv1d(xb, p["conv_w"].to(cdt), p["conv_b"].to(cdt),
                           conv_state)
    ga = add_bias(xb @ p["w_a"].to(cdt), p["b_a"].to(cdt))
    gi = add_bias(xb @ p["w_i"].to(cdt), p["b_i"].to(cdt))
    h0 = cache["h"] if cache is not None else None
    h = rglru_scan(xb, ga, gi, p["lam"], h0)                   # f32
    out = (h.to(cdt) * gb) @ p["w_out"].to(cdt)
    new_cache = None
    if cache is not None:
        new_cache = {"h": h[:, -1, :], "conv": new_conv}
    return out, new_cache


def init_rglru_cache(cfg, n_layers: int, B: int, dtype=torch.float32,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Every recurrent layer's state (float32) and conv tail, zero."""
    device = resolve_device(device)
    W, cw = cfg.rg.lru_width, cfg.rg.conv_width
    return {"h": torch.zeros((n_layers, B, W), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_layers, B, cw - 1, W), dtype=dtype,
                                device=device)}
