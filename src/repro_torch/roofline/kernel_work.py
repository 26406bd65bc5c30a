"""The work each hand-written kernel does, by the formulas of the bounds
that ``PERF.md`` §6 states: the operations of its products (2 a
multiply-add, the type of its operands) and the bytes it must move (each
input read once, each output written once).

A ctypes launch is invisible to a dispatch mode, so each kernel wrapper
reports these to :mod:`~repro_torch.roofline.op_costs` when a count is
under way, and the stand-ins of :func:`~repro_torch.roofline.op_costs.
card_kernels` report the same for fake tensors on the host.  Each
function returns ``(flops, bytes, flop_type)``; the type names the
rate in ``roofline/analysis.py`` (``"bf16"``: the tensor cores,
``"f32"``: FFMA outside them).

Attention's work depends on the data, the visible (query, key) pairs:
:func:`visible` counts them from a launch's qpos, :func:`visible_from_zero`
for queries at positions 0..T-1, each train step's and each prefill's
from an empty cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

Work = Tuple[float, float, str]


def _flop_type(itemsize: int) -> str:
    return "f32" if itemsize == 4 else "bf16"


def visible(qpos, S: int, window: Optional[int]) -> Tuple[int, int]:
    """(pairs, rows) of a launch: the visible (query, key) pairs summed
    over the batch, and the key rows some query of its batch row sees
    (keys [lo, hi) a query: hi = qpos + 1, lo = hi - window)."""
    import torch
    hi = torch.clamp(qpos.long() + 1, 0, S)
    lo = torch.zeros_like(hi) if window is None else \
        torch.clamp(qpos.long() + 1 - int(window), 0, S)
    pairs = int((hi - lo).sum())
    rows = int((hi.amax(dim=1) - lo.amin(dim=1)).clamp(min=0).sum())
    return pairs, rows


def _sum_min(n: int, c: int) -> int:
    """sum of min(j, c) for j = 1..n."""
    if n <= c:
        return n * (n + 1) // 2
    return c * (c + 1) // 2 + (n - c) * c


def visible_from_zero(B: int, T: int, S: int,
                      window: Optional[int]) -> Tuple[int, int]:
    """:func:`visible` for qpos = 0..T-1 in every batch row, in closed
    form: query t sees min(t + 1, S) keys less those below t + 1 -
    window."""
    pairs = _sum_min(T, S)
    if window is not None:
        pairs -= _sum_min(max(T - int(window), 0), S)
    return B * pairs, B * min(T, S)


def flash_fwd(B: int, T: int, S: int, Hq: int, Hkv: int, Dh: int, Dv: int,
              itemsize: int, pairs: int, rows: int, shared_k: int = 0,
              with_lse: bool = False) -> Work:
    """2 (Dh + Dv) operations a visible pair and head (q.k and p.v; Dh
    with MLA's RoPE columns); q and o once, each key row some query
    sees once (the last ``shared_k`` of K's columns, MLA's RoPE key,
    once a row for every kv head), the log-sum-exp when written."""
    flops = 2 * Hq * (Dh + Dv) * pairs
    kv_row = Hkv * (Dh - shared_k + Dv) + shared_k
    nbytes = itemsize * (B * T * Hq * (Dh + Dv) + rows * kv_row)
    if with_lse:
        nbytes += 4 * B * Hq * T
    return float(flops), float(nbytes), _flop_type(itemsize)


def flash_bwd(B: int, T: int, S: int, Hq: int, Hkv: int, Dh: int, Dv: int,
              itemsize: int, pairs: int) -> Work:
    """2 (3 Dh + 2 Dv) operations a visible pair and head (S, dV, dP,
    dQ, dK: 10 Dh at Dh = Dv); q, o, dO and dq, k, v and dk, dv once,
    the log-sum-exp once."""
    flops = 2 * Hq * (3 * Dh + 2 * Dv) * pairs
    nbytes = itemsize * (B * T * Hq * (2 * Dh + 2 * Dv)
                         + B * S * Hkv * (2 * Dh + 2 * Dv)) + 4 * B * Hq * T
    return float(flops), float(nbytes), _flop_type(itemsize)


def rglru_fwd(B: int, T: int, W: int, itemsize: int,
              with_h0: bool = False) -> Work:
    """No product; x, gate_a, gate_i read once, h (float32) written
    once (10 B an element in bf16), lam and h0 once."""
    nbytes = B * T * W * (3 * itemsize + 4) + 4 * W + (4 * B * W
                                                       if with_h0 else 0)
    return 0.0, float(nbytes), "f32"


def rglru_bwd(B: int, T: int, W: int, itemsize: int,
              with_h0: bool = False) -> Work:
    """No product; g and h (float32) and x, gate_a, gate_i read once,
    their three gradients written once (20 B an element in bf16)."""
    nbytes = B * T * W * (6 * itemsize + 8) + 8 * W + (8 * B * W
                                                       if with_h0 else 0)
    return 0.0, float(nbytes), "f32"


def slstm_fwd(B: int, T: int, D: int, H: int, itemsize: int,
              saving: bool = False) -> Work:
    """The recurrent product, 2 B H Dh 4Dh a step, in float32; pre_x
    and r read once, hs written once, the state read and written once,
    and under grad pre, c, n, m (float32) written once a step for the
    backward."""
    Dh = D // H
    flops = 2 * B * H * Dh * 4 * Dh * T
    nbytes = (B * T * 4 * D * itemsize + B * T * D * 4 + H * Dh * 4 * Dh * 4
              + 8 * B * D * 4)
    if saving:
        nbytes += 4 * B * T * 7 * D
    return float(flops), float(nbytes), "f32"


def slstm_bwd(B: int, T: int, D: int, H: int) -> Work:
    """dh's product, 2 D 4Dh a step and row, in float32; dhs, pre and
    c, n, m read once, dpre written once, r once."""
    Dh = D // H
    flops = 2 * B * T * D * 4 * Dh
    nbytes = 4 * B * T * (D + 4 * D + 3 * D + 4 * D) + 4 * H * Dh * 4 * Dh
    return float(flops), float(nbytes), "f32"
