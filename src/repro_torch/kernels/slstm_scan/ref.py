"""Plain PyTorch version of the sLSTM recurrence, the function of the
``step`` of the reference's ``slstm_block`` (``repro/models/xlstm.py:
203-215``) under its ``lax.scan`` over T (``:217``):

    rec   = einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r).reshape(B, 4D)
    pre   = pre_x_t (widened to float32) + rec
    i, f, z, o = split(pre, 4)           # D units each
    m'    = max(f + m, i)
    c'    = exp(f + m - m') c + exp(i - m') tanh(z)
    n'    = exp(f + m - m') n + exp(i - m')
    h'    = sigmoid(o) c' / max(n', 1e-6)

in float32.  The split is of the flat (B, 4D) product, so with H heads
of Dh = D / H the i gate is the first D of the H * 4Dh outputs (head 0's
whole 4Dh when H = 4), not each head's own first Dh: every unit's four
gates read all of h_{t-1}.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def slstm_step(px: torch.Tensor, r: torch.Tensor, state: State) -> State:
    """One step: px (B, 4D) in any float dtype, r (H, Dh, 4Dh) float32,
    state (c, n, h, m) each (B, D) float32.  Returns the new state."""
    c, n, h, m = state
    B, D = h.shape
    H, Dh, _ = r.shape
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r).reshape(B, 4 * D)
    pre = px.float() + rec
    i_, f_, z_, o_ = torch.split(pre, D, dim=-1)
    m_new = torch.maximum(f_ + m, i_)
    i_g = torch.exp(i_ - m_new)
    f_g = torch.exp(f_ + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_) * (c_new / torch.clamp(n_new, min=1e-6))
    return c_new, n_new, h_new, m_new


def slstm_scan_ref(pre_x: torch.Tensor, r: torch.Tensor,
                   state: Optional[State] = None,
                   out: Optional[State] = None
                   ) -> Tuple[torch.Tensor, State]:
    """pre_x (B, T, 4D) in any float dtype; r (H, Dh, 4Dh) float32;
    state (c, n, h, m) each (B, D) float32, or None for zeros.  Returns
    hs (B, T, D) float32 and the final state, copied into ``out`` (four
    (B, D) float32 tensors, which may be ``state`` itself) when given."""
    B, T, D4 = pre_x.shape
    D = D4 // 4
    if state is None:
        z = torch.zeros((B, D), dtype=torch.float32, device=pre_x.device)
        state = (z, z, z, z)
    st = tuple(s.float() for s in state)
    hs = torch.empty((B, T, D), dtype=torch.float32, device=pre_x.device)
    for t in range(T):
        st = slstm_step(pre_x[:, t], r.float(), st)
        hs[:, t] = st[2]
    if out is not None:
        for dst, src in zip(out, st):
            dst.copy_(src)
        st = tuple(out)
    return hs, st
