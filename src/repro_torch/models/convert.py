"""Carry the reference's weights across to the port.

``from_jax_params`` takes the pytree that the reference's
``bundle.init`` returns, with every leaf as a numpy array and the
layers stacked with a leading ``L`` (``repro/models/lm.py:99-112``), and
returns the port's parameters: one dict per layer.

Every matrix is stored in ``compute_dtype``.  The reference keeps
float32 masters but casts each matrix to the compute dtype right
before every use (``layers.py:121-124``, ``lm.py:72``, ``:80``,
``:135-137``), so a matrix rounded once at load gives the same values.
Norm scales stay float32, because ``rms_norm`` reads them as float32
(``common.py:159``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .lm import Params, resolve_device


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32)).to(
        device=device, dtype=dtype)


def from_jax_params(params_np: Dict[str, Any], cfg, *, device="cuda",
                    compute_dtype=torch.bfloat16) -> Params:
    """The port's params of a dense decoder from the reference's
    ``{"emb": ..., "main": {"attn", "norms", "ffn"}}`` pytree of numpy
    arrays."""
    dev = resolve_device(device)
    if set(params_np) != {"emb", "main"}:
        raise NotImplementedError(
            f"from_jax_params carries the dense decoder only, got groups "
            f"{sorted(params_np)}")
    emb = params_np["emb"]
    main = params_np["main"]
    mat = lambda x: _t(x, compute_dtype, dev)          # noqa: E731
    f32 = lambda x: _t(x, torch.float32, dev)          # noqa: E731
    layers = []
    for i in range(cfg.n_layers):
        layers.append({
            "attn": {n: mat(w[i]) for n, w in main["attn"].items()},
            "norms": {n: f32(w[i]) for n, w in main["norms"].items()},
            "ffn": {n: mat(w[i]) for n, w in main["ffn"].items()},
        })
    return {"emb": {"in_emb": mat(emb["in_emb"]),
                    "out_emb": mat(emb["out_emb"]),
                    "final_norm": f32(emb["final_norm"])},
            "main": layers}
