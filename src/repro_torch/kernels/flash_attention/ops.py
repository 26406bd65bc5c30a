"""Public flash-attention entry point with implementation dispatch.

  impl='dense'     -- ref.py oracle (small shapes, tests)
  impl='blockwise' -- plain online softmax over q and kv blocks
                      (memory O(bq x bk))
  impl='banded'    -- static-window band gather, O(T·window)
  impl='cuda'      -- the hand-written kernel (csrc/flash_attn_hd.cu);
                      raises on a CPU tensor
  impl='auto'      -- on a CUDA tensor always the kernel, for any
                      window or none.  On a CPU tensor exactly what the
                      reference's 'auto' picks off a TPU: banded if a
                      static int window is under a quarter of S, dense
                      for small T·S, blockwise otherwise.

The reference's TPU dispatch reaches its Pallas kernel only for a
static int window (``repro/kernels/flash_attention/ops.py:46-47``); a
``window=None`` call, such as every yi-9b prefill, falls to the jnp
``blockwise`` scan, which is the same function as the kernel.  On the
card the kernel takes that role, so every long prefill launches it.
"""
from __future__ import annotations

import numbers
from typing import Optional

from . import jnp_impl, ref
from .kernel import attention_out, check_rope, flash_attention_cuda

_DENSE_MAX = 2048 * 2048      # T*S elements below which dense is fine


def _is_static_int(x) -> bool:
    return isinstance(x, numbers.Integral)


def flash_attention(q, k, v, *, qpos, window=None, softcap: float = 0.0,
                    scale: Optional[float] = None, impl: str = "auto",
                    block_q: int = 512, block_kv: int = 1024, out=None,
                    q_rope=None, k_rope=None):
    """Causal/windowed GQA attention.  q (B,T,Hq,Dh); k (B,S,Hkv,Dh);
    v (B,S,Hkv,Dv); qpos (B,T) absolute query positions (kv position of
    slot s is s).  Returns (B,T,Hq,Dv): ``out`` where given (the kernel
    writes it through its strides; a plain version copies its result
    in), else a new tensor.

    ``q_rope`` (B,T,Hq,Dr) and ``k_rope`` (B,S,1,Dr), given together,
    are more columns of q and of every kv head's k, the RoPE key shared
    by the heads (MLA): the logits are ``(q.k + q_rope.k_rope) * scale``.
    The kernel takes them as they are; every plain version computes on
    the concatenation (``ref.join_rope``), as the reference does."""
    T = q.shape[1]
    S = k.shape[1]
    if impl == "auto":
        if q.is_cuda:
            impl = "cuda"
        elif _is_static_int(window) and int(window) * 4 < S:
            impl = "banded"
        elif T * S <= _DENSE_MAX:
            impl = "dense"
        else:
            impl = "blockwise"
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; the plain "
                             "versions are 'dense', 'blockwise', 'banded'")
        return flash_attention_cuda(q, k, v, qpos=qpos, window=window,
                                    softcap=softcap, scale=scale, out=out,
                                    q_rope=q_rope, k_rope=k_rope)
    if check_rope(q, k, q_rope, k_rope):
        q, k = ref.join_rope(q, k, q_rope, k_rope)
    if impl == "dense":
        o = ref.dense_attention(q, k, v, qpos=qpos, window=window,
                                softcap=softcap, scale=scale)
    elif impl == "blockwise":
        o = jnp_impl.blockwise_attention(
            q, k, v, qpos=qpos, window=window, softcap=softcap, scale=scale,
            block_q=block_q, block_kv=block_kv)
    elif impl == "banded":
        o = jnp_impl.banded_attention(
            q, k, v, qpos=qpos, window=int(window), softcap=softcap,
            scale=scale, block_q=block_q)
    else:
        raise ValueError(f"unknown impl {impl!r}; one of 'auto', 'cuda', "
                         f"'dense', 'blockwise', 'banded'")
    return o if out is None else attention_out(q, k, v, out).copy_(o)
