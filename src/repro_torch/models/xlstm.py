"""xLSTM blocks (arXiv:2405.04517), the port of the reference's
``repro/models/xlstm.py``: the mLSTM (matrix memory, chunkwise
parallel) and the sLSTM (scalar memory, truly recurrent), mixed by
``models/hybrid.py``'s ``build_xlstm_lm``.

The mLSTM is plain PyTorch, as the reference's einsums are plain XLA:
within a chunk the quadratic parallel form, across chunks the (C, n, m)
state; a decode step is the recurrent form.  Which of the three runs
follows the reference: with a cache and T = 1 the recurrent step; T a
multiple of ``chunk`` with more than one chunk, a loop over chunks;
any other T one chunk over all of T.  Every product of the chunk is in
float32 (TF32 stays off on the card).

The sLSTM's recurrence runs in ``kernels/slstm_scan``: on the card the
hand-written kernel (``csrc/slstm_scan.cu``, one launch a block for all
T steps: ``cluster`` in a prefill, ``step`` in a decode step; with grad
its backward kernel too, the reverse of ``cluster``), on the CPU its
plain float32 loop, differentiated by autograd.  The recurrent weights
``r_in`` are read in float32 (``xlstm.py:201``): they stay float32
whatever the compute dtype.

Parameters are one dict per layer, drawn from a ``torch.Generator`` with
the reference's scales: the matrices in the given dtype, ``r_in`` and
the biases float32 (every use casts them as the reference does).  With
a cache, each block writes its new state into the cache's rows in place
(the reference returns new arrays).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import slstm_scan

from .common import as_dtensor, from_shards, resolve_device, shardwise
from .layers import _normal

Params = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _widths(cfg) -> Tuple[int, int, int]:
    """(Dm, H, Dm // H): the mLSTM's inner width and heads."""
    Dm = int(cfg.d_model * cfg.xlstm.proj_factor)
    return Dm, cfg.n_heads, Dm // cfg.n_heads


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------
def mlstm_params(gen: torch.Generator, cfg, *, dtype=torch.float32,
                 device="cuda") -> Params:
    """One mLSTM block's weights (the reference's ``mlstm_params`` for
    one of its ``L`` stacked layers)."""
    D = cfg.d_model
    Dm, H, _ = _widths(cfg)
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    return {
        "w_up": _normal(gen, (D, 2 * Dm), 1 / math.sqrt(D), **kw),
        "w_q": _normal(gen, (Dm, Dm), 1 / math.sqrt(Dm), **kw),
        "w_k": _normal(gen, (Dm, Dm), 1 / math.sqrt(Dm), **kw),
        "w_v": _normal(gen, (Dm, Dm), 1 / math.sqrt(Dm), **kw),
        "w_if": _normal(gen, (Dm, 2 * H), 1 / math.sqrt(Dm), **kw),
        "b_if": torch.zeros((2 * H,), dtype=torch.float32, device=device),
        "skip": _normal(gen, (Dm, Dm), 0.1 / math.sqrt(Dm), **kw),
        "w_down": _normal(gen, (Dm, D), 1 / math.sqrt(Dm), **kw),
    }


# the reference's specs (``repro/models/xlstm.py:46-55``) without "layers"
MLSTM_SPECS = {"w_up": ("embed", "inner"), "w_q": ("inner", "inner"),
               "w_k": ("inner", "inner"), "w_v": ("inner", "inner"),
               "w_if": ("inner", "gates"), "b_if": ("gates",),
               "skip": ("inner", "inner"), "w_down": ("inner", "embed")}


def _mlstm_chunk(q, k, v, ig, fg, state: State):
    """One chunk of the chunkwise-parallel mLSTM, in float32.

    q, k, v (B, H, t, Dh); ig, fg (B, H, t) log-gates; state (C, n, m):
    C (B, H, Dh, Dh), n (B, H, Dh), m (B, H).  Returns (out, new_state),
    with the reference's stabilisers (``xlstm.py:59-96``)."""
    t, Dh = q.shape[2], q.shape[3]
    # the log-gates' prefix sum over time, never a sharded dim: on a
    # DTensor each rank's shard, forward and backward (cumsum's backward
    # flips, an op torch 2.11's DTensor has no strategy for)
    Fc = shardwise(lambda f: torch.cumsum(F.logsigmoid(f), dim=-1), fg,
                   dim=-1)
    C_prev, n_prev, m_prev = state
    # log weights of the pairs inside the chunk: F_i - F_j + ig_j, j <= i
    Dmat = Fc[..., :, None] - Fc[..., None, :] + ig[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    Dmat = torch.where(mask, Dmat, -torch.inf)
    inter = Fc + m_prev[..., None]                 # the carried state's
    m_new = torch.maximum(Dmat.amax(dim=-1), inter)
    m_new = torch.clamp(m_new, min=-1e30)
    Wd = torch.exp(Dmat - m_new[..., None])
    Wi = torch.exp(inter - m_new)
    qs = q * (1.0 / math.sqrt(Dh))
    s_intra = torch.einsum("bhtd,bhsd->bhts", qs, k) * Wd
    num = torch.einsum("bhts,bhsd->bhtd", s_intra, v) \
        + torch.einsum("bhtd,bhde->bhte", qs, C_prev) * Wi[..., None]
    den = torch.abs(s_intra.sum(dim=-1)
                    + torch.einsum("bhtd,bhd->bht", qs, n_prev) * Wi)
    out = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    # the state at the end of the chunk
    lf_total = Fc[..., -1]
    rest = ig + (lf_total[..., None] - Fc)
    m_end = torch.maximum(lf_total + m_prev, rest.amax(dim=-1))
    w_prev = torch.exp(lf_total + m_prev - m_end)
    w_tok = torch.exp(rest - m_end[..., None])
    C_new = C_prev * w_prev[..., None, None] \
        + torch.einsum("bhtd,bhte,bht->bhde", k, v, w_tok)
    n_new = n_prev * w_prev[..., None] \
        + torch.einsum("bhtd,bht->bhd", k, w_tok)
    return out, (C_new, n_new, m_end)


def mlstm_block(p: Params, x: torch.Tensor, cfg, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                chunk: int = 256):
    """x (B, T, D) -> (out, new_cache).  cache = {C, n, m} float32; with
    it, new_cache holds the state after the last step, else None."""
    cdt = x.dtype
    B, T, _ = x.shape
    Dm, H, Dh = _widths(cfg)
    up = x @ p["w_up"].to(cdt)
    xi, og = up[..., :Dm], F.silu(up[..., Dm:])

    def heads(w):
        return (xi @ w.to(cdt)).reshape(B, T, H, Dh).transpose(1, 2)
    q, k, v = heads(p["w_q"]), heads(p["w_k"]), heads(p["w_v"])
    gif = (xi @ p["w_if"].to(cdt) + p["b_if"].to(cdt)).float()
    ig, fg = gif[..., :H].transpose(1, 2), gif[..., H:].transpose(1, 2)

    if cache is not None and T == 1:
        # the recurrent decode step; k and v stay in the compute dtype
        # and their outer product rounds there, as in the reference
        C, n, m = cache["C"], cache["n"], cache["m"]
        lf = shardwise(F.logsigmoid, fg[..., 0])
        m_new = torch.maximum(lf + m, ig[..., 0])
        wi = torch.exp(ig[..., 0] - m_new)
        wf = torch.exp(lf + m - m_new)
        k1, v1 = k[:, :, 0], v[:, :, 0]
        q1 = (q[:, :, 0] / math.sqrt(Dh)).float()
        C = C * wf[..., None, None] \
            + torch.einsum("bhd,bhe->bhde", k1, v1) * wi[..., None, None]
        n = n * wf[..., None] + k1 * wi[..., None]
        num = torch.einsum("bhd,bhde->bhe", q1, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", q1, n))
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        h = h[:, :, None, :]                              # (B, H, 1, Dh)
        new_cache = {"C": C, "n": n, "m": m_new}
    else:
        if cache is not None:
            state = (cache["C"], cache["n"], cache["m"])
        else:
            zeros = lambda *s: torch.zeros(  # noqa: E731
                s, dtype=torch.float32, device=x.device)
            state = (zeros(B, H, Dh, Dh), zeros(B, H, Dh), zeros(B, H))
        qf, kf, vf = q.float(), k.float(), v.float()
        nchunks = max(1, T // chunk)
        if T % chunk == 0 and nchunks > 1:
            outs = []
            for c in range(nchunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                o, state = _mlstm_chunk(qf[:, :, sl], kf[:, :, sl],
                                        vf[:, :, sl], ig[..., sl],
                                        fg[..., sl], state)
                outs.append(o)
            h = torch.cat(outs, dim=2)
        else:
            h, state = _mlstm_chunk(qf, kf, vf, ig, fg, state)
        new_cache = ({"C": state[0], "n": state[1], "m": state[2]}
                     if cache is not None else None)
    h = h.transpose(1, 2).reshape(B, T, Dm).to(cdt)
    h = h + xi @ p["skip"].to(cdt)
    out = (h * og) @ p["w_down"].to(cdt)
    return out, new_cache


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------
def slstm_params(gen: torch.Generator, cfg, *, dtype=torch.float32,
                 device="cuda") -> Params:
    """One sLSTM block's weights (the reference's ``slstm_params`` for
    one of its ``L`` stacked layers); ``r_in`` float32."""
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    ffd = int(D * 4 * cfg.xlstm.ff_factor) // 2 * 2
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in": _normal(gen, (D, 4 * D), 1 / math.sqrt(D), **kw),
        # the recurrent weights, one (Dh, 4Dh) block a head
        "r_in": _normal(gen, (H, Dh, 4 * Dh), 0.5 / math.sqrt(Dh),
                        torch.float32, device),
        "b_in": torch.zeros((4 * D,), dtype=torch.float32, device=device),
        "w_ff1": _normal(gen, (D, ffd), 1 / math.sqrt(D), **kw),
        "w_ff2": _normal(gen, (ffd, D), 1 / math.sqrt(ffd), **kw),
    }


# the reference's specs (``repro/models/xlstm.py:177-183``) without "layers"
SLSTM_SPECS = {"w_in": ("embed", "gates"),
               "r_in": ("heads", "head_dim", "gates"), "b_in": ("gates",),
               "w_ff1": ("embed", "mlp"), "w_ff2": ("mlp", "embed")}


def _scan(pre_x, r, state):
    """:func:`slstm_scan`'s hs, the final state written into ``state``
    when given.  A DTensor pre_x (the dry-run's) scans each rank's
    batch rows whole: every unit's gates read all of h, so pre_x, r and
    the state are gathered over every other mesh dim first (counted),
    once, not once a step; hs keeps the rows' placements, and r's
    gradient is a partial sum over the batch dims' ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(pre_x, DTensor):
        return slstm_scan(pre_x, r, state, out=state)[0]
    mesh = pre_x.device_mesh
    rows = [Shard(0) if q == Shard(0) else Replicate()
            for q in pre_x.placements]
    r = as_dtensor(r, mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if q == Shard(0) else Replicate()
                         for q in rows])
    local = None
    if state is not None:
        state = tuple(as_dtensor(s, mesh) for s in state)
        if any(list(s.placements) != rows for s in state):
            raise ValueError(f"sLSTM state placed "
                             f"{[s.placements for s in state]}, its rows "
                             f"{rows}")
        local = tuple(s.to_local() for s in state)
    hs, _ = slstm_scan(pre_x.redistribute(mesh, rows).to_local(), r, local,
                       out=local)
    return from_shards(hs, mesh, rows, pre_x.shape[:2] + hs.shape[2:])


def slstm_block(p: Params, x: torch.Tensor, cfg, *,
                cache: Optional[Dict[str, torch.Tensor]] = None):
    """The sequential sLSTM with exponential gating and its stabiliser,
    then its tanh-gelu feed-forward.  cache = {c, n, h, m} each (B, D)
    float32, updated in place; returns (out, cache or None)."""
    cdt = x.dtype
    pre_x = x @ p["w_in"].to(cdt) + p["b_in"].to(cdt)          # (B, T, 4D)
    state = None
    if cache is not None:
        state = tuple(cache[k] for k in ("c", "n", "h", "m"))
    hs = _scan(pre_x, p["r_in"].float(), state)
    hs = hs.to(cdt)
    out = F.gelu(hs @ p["w_ff1"].to(cdt), approximate="tanh") \
        @ p["w_ff2"].to(cdt)
    return out, cache


def init_xlstm_caches(cfg, n_m: int, n_s: int, B: int,
                      device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Every block's state, float32 and zero: ``m`` the mLSTM's (C, n,
    m) per head, ``s`` the sLSTM's (c, n, h, m) per unit."""
    D = cfg.d_model
    _, H, Dh = _widths(cfg)
    device = resolve_device(device)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
    return {"m": {"C": zeros(n_m, B, H, Dh, Dh), "n": zeros(n_m, B, H, Dh),
                  "m": zeros(n_m, B, H)},
            "s": {k: zeros(n_s, B, D) for k in ("c", "n", "h", "m")}}
