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
gates read all of h_{t-1}.  Both maxima are ``torch.maximum``, whose
gradient splits evenly at a tie as ``jnp.maximum``'s does
(``torch.clamp(n, min=1e-6)`` would pass all of it at n = 1e-6), so
autograd through :func:`slstm_scan_ref` takes JAX's gradient.

:func:`slstm_scan_bwd_ref` is the plain version of the backward kernel:
the explicit reverse float32 loop that ``csrc/slstm_scan.cu``'s
``slstm_bwd_kernel`` computes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _pre(px: torch.Tensor, r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """pre = px + the recurrent product of h, (B, 4D) in h's dtype."""
    B, D = h.shape
    H, Dh, _ = r.shape
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r).reshape(B, 4 * D)
    return px.to(h.dtype) + rec


def _gate_step(pre: torch.Tensor, c, n, m) -> State:
    """The gates and new state (c, n, h, m) from pre (B, 4D)."""
    i_, f_, z_, o_ = torch.split(pre, c.shape[-1], dim=-1)
    m_new = torch.maximum(f_ + m, i_)
    i_g = torch.exp(i_ - m_new)
    f_g = torch.exp(f_ + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_) * (
        c_new / torch.maximum(n_new, n_new.new_tensor(1e-6)))
    return c_new, n_new, h_new, m_new


def slstm_step(px: torch.Tensor, r: torch.Tensor, state: State) -> State:
    """One step: px (B, 4D) in any float dtype, r (H, Dh, 4Dh) float32,
    state (c, n, h, m) each (B, D) float32.  Returns the new state."""
    c, n, h, m = state
    return _gate_step(_pre(px, r, h), c, n, m)


def slstm_scan_ref(pre_x: torch.Tensor, r: torch.Tensor,
                   state: Optional[State] = None,
                   out: Optional[State] = None
                   ) -> Tuple[torch.Tensor, State]:
    """pre_x (B, T, 4D) in any float dtype; r (H, Dh, 4Dh) float32;
    state (c, n, h, m) each (B, D) float32, or None for zeros.  Returns
    hs (B, T, D) float32 and the final state, copied into ``out`` (four
    (B, D) float32 tensors, which may be ``state`` itself) when given.
    With float64 pre_x the whole recurrence runs in float64 (a test's
    oracle)."""
    B, T, D4 = pre_x.shape
    D = D4 // 4
    dt = torch.float64 if pre_x.dtype == torch.float64 else torch.float32
    if state is None:
        z = torch.zeros((B, D), dtype=dt, device=pre_x.device)
        state = (z, z, z, z)
    st = tuple(s.to(dt) for s in state)
    hs = torch.empty((B, T, D), dtype=dt, device=pre_x.device)
    for t in range(T):
        st = slstm_step(pre_x[:, t], r.to(dt), st)
        hs[:, t] = st[2]
    if out is not None:
        for dst, src in zip(out, st):
            dst.copy_(src)
        st = tuple(out)
    return hs, st


def _tie(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d max(a, b) / da as jnp.maximum's: 1 where a > b, 1/2 at a tie."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def slstm_scan_bwd_ref(dhs: torch.Tensor, pre_x: torch.Tensor,
                       r: torch.Tensor, state: Optional[State] = None,
                       dfinal: Optional[State] = None):
    """The gradients of :func:`slstm_scan_ref` from dhs = dL/dhs (B, T,
    D) and, optionally, dfinal, those of the final (c, n, h, m): dpre (B,
    T, 4D) float32 (pre_x's gradient before its cast), dr (H, Dh, 4Dh)
    float32 and, with a state, its (dc, dn, dh, dm) (else None).  The
    forward is run again in float32, keeping each step's pre and state;
    then, from t = T - 1 down to 0, with the state's gradients carried
    back a step (JAX's terms, a tie of either maximum split evenly):

        dh_t   = g_t + r . dpre_{t+1}
        h = sigmoid(o) q, q = c / nc, nc = max(n, 1e-6):
          do = dh q s (1 - s), dc += dh s / nc, dn -= dh s q / nc [n]
        c = fg cp + ig tanh(z), n = fg np + ig:
          dz = dc ig (1 - tanh(z)^2), dfg = dc cp + dn np, dig = dc tanh(z) + dn
        fg = exp(f + mp - m), ig = exp(i - m), m = max(f + mp, i):
          dm' = dm - dfg fg - dig ig
          df = dfg fg + dm' [f + mp], di = dig ig + dm' [i]
        carried: dc fg, dn fg, dm = df

    and dr = sum_t h_{t-1} (x) dpre_t per head."""
    B, T, D4 = pre_x.shape
    D = D4 // 4
    H, Dh, E = r.shape
    r = r.float()
    zero = torch.zeros((B, D), dtype=torch.float32, device=pre_x.device)
    states = [tuple(s.float() for s in state) if state is not None
              else (zero,) * 4]
    pres = []
    for t in range(T):
        c, n, h, m = states[-1]
        pres.append(_pre(pre_x[:, t], r, h))
        states.append(_gate_step(pres[-1], c, n, m))
    g = dhs.float().clone()
    dc = dn = dm = zero
    if dfinal is not None:
        dc, dn, dh1, dm = (x.float() for x in dfinal)
        g[:, -1] += dh1
    dpre = torch.empty((B, T, D4), dtype=torch.float32, device=pre_x.device)
    dr = torch.zeros((H, Dh, E), dtype=torch.float32, device=pre_x.device)
    back = zero                                   # r . dpre_{t+1}
    for t in range(T - 1, -1, -1):
        cp, np_, hp, mp = states[t]
        i_, f_, z_, o_ = torch.split(pres[t], D, dim=-1)
        fm = f_ + mp
        mn = torch.maximum(fm, i_)
        ig, fg = torch.exp(i_ - mn), torch.exp(fm - mn)
        tz = torch.tanh(z_)
        c = fg * cp + ig * tz
        n = fg * np_ + ig
        nc = torch.maximum(n, n.new_tensor(1e-6))
        so = torch.sigmoid(o_)
        q = c / nc
        dh = g[:, t] + back
        dq = dh * so
        dc = dc + dq / nc
        dn = dn - dq * q / nc * _tie(n, n.new_tensor(1e-6))
        do = dh * q * so * (1.0 - so)
        dfg = dc * cp + dn * np_
        dig = dc * tz + dn
        dz = dc * ig * (1.0 - tz * tz)
        af, ai = dfg * fg, dig * ig
        dmn = dm - af - ai
        wf = _tie(fm, i_)
        df = af + dmn * wf
        di = ai + dmn * (1.0 - wf)
        dpre[:, t] = torch.cat([di, df, dz, do], dim=-1)
        dc, dn, dm = dc * fg, dn * fg, df
        dp = dpre[:, t].reshape(B, H, E)
        back = torch.einsum("bhe,hde->bhd", dp, r).reshape(B, D)
        dr += torch.einsum("bhd,bhe->hde", hp.reshape(B, H, Dh), dp)
    dstate = (dc, dn, back, dm) if state is not None else None
    return dpre, dr, dstate
