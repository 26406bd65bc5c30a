"""Plain PyTorch version of the RG-LRU scan, the function of the
reference's ``_rglru_scan`` (``repro/models/rglru.py:73-93``):

    log_a = -8 * softplus(lam) * sigmoid(gate_a)
    a     = exp(log_a)
    b     = sqrt(max(1 - exp(2 * log_a), 1e-12)) * sigmoid(gate_i) * x
    h_t   = a_t * h_{t-1} + b_t,    h_{-1} = h0 (or 0)

in float32, the carried state folded into the first step's b as the
reference folds it.  The reference runs the recurrence as a
log-depth ``associative_scan``; this runs it as a loop over T, which
rounds in another order (within 1e-5 relative in float32) and is the
order the CUDA kernel takes.  :func:`rglru_scan_bwd_ref` is the plain
version of the backward kernel: the gradient JAX takes through the
reference's scan, as a reverse loop over T.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

C = 8.0  # the RG-LRU "c" constant of the paper


def gates(x_in: torch.Tensor, gate_a: torch.Tensor, gate_i: torch.Tensor,
          lam: torch.Tensor):
    """(a, b) of the recurrence, float32 (B, T, W)."""
    log_a = -C * F.softplus(lam.float()) * torch.sigmoid(gate_a.float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (torch.sigmoid(gate_i.float()) * x_in.float())
    return a, b


def rglru_scan_ref(x_in: torch.Tensor, gate_a: torch.Tensor,
                   gate_i: torch.Tensor, lam: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_in, gate_a, gate_i (B, T, W); lam (W,); h0 (B, W) or None.
    Returns h (B, T, W) float32."""
    a, b = gates(x_in, gate_a, gate_i, lam)
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    out = torch.empty_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(g: torch.Tensor, x_in: torch.Tensor,
                       gate_a: torch.Tensor, gate_i: torch.Tensor,
                       lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       h: Optional[torch.Tensor] = None):
    """The gradients of :func:`rglru_scan_ref` from g = dL/dh (B, T, W):
    (dx, dgate_a, dgate_i) in the inputs' dtypes, dlam (W,) and dh0
    (B, W) float32 (None without h0).  h is the forward's output
    (computed when not given).  In float32, with e_t = a_t dh_t:

        dh_t   = g_t + e_{t+1}  (a loop from T - 1 down to 0), dh0 = e_0
        dx     = dh mult sig_i,  dgate_i = dh mult x sig_i (1 - sig_i)
        dlog_a = dh h_{t-1} a - [u >= 1e-12] dh sig_i x a^2 / mult
        dgate_a = dlog_a (-C softplus(lam)) sig_a (1 - sig_a)
        dlam   = sum_{b,t} dlog_a (-C sigmoid(lam)) sig_a

    with u = 1 - exp(2 log_a), mult = sqrt(max(u, 1e-12)) and h_{-1} =
    h0 (or 0): the clamp passes no gradient where it binds."""
    lam_f = lam.float()
    sp = F.softplus(lam_f)
    sig_a = torch.sigmoid(gate_a.float())
    sig_i = torch.sigmoid(gate_i.float())
    x = x_in.float()
    log_a = -C * sp * sig_a
    a = torch.exp(log_a)
    u = 1.0 - torch.exp(2.0 * log_a)
    mult = torch.sqrt(torch.clamp(u, min=1e-12))
    if h is None:
        h = rglru_scan_ref(x_in, gate_a, gate_i, lam, h0)
    first = torch.zeros_like(h[:, :1]) if h0 is None else \
        h0.float()[:, None]
    h_prev = torch.cat([first, h[:, :-1].float()], dim=1)
    g = g.float()
    dh = torch.empty_like(g)
    e = torch.zeros_like(g[:, 0])
    for t in range(g.shape[1] - 1, -1, -1):
        dh[:, t] = g[:, t] + e
        e = a[:, t] * dh[:, t]
    dm = dh * sig_i * x                                  # dL/dmult
    dlog_a = dh * h_prev * a - torch.where(u >= 1e-12, dm * a * a / mult,
                                           torch.zeros_like(dm))
    dx = dh * mult * sig_i
    dgi = dh * mult * x * sig_i * (1.0 - sig_i)
    dga = dlog_a * (-C * sp) * sig_a * (1.0 - sig_a)
    dlam = (dlog_a * sig_a).sum(dim=(0, 1)) * (-C * torch.sigmoid(lam_f))
    return (dx.to(x_in.dtype), dga.to(gate_a.dtype), dgi.to(gate_i.dtype),
            dlam, None if h0 is None else e)
