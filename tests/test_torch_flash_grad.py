"""The flash-attention gradient of the port against the reference's.

The port's plain backward (``jnp_impl._BlockwiseAttention``, the plain
version of ``csrc/flash_attn_bwd_hd.cu``) is held against ``jax.grad``
through the reference's ``blockwise_attention`` and its ``custom_vjp``
on the reference's own cases (tests/test_flash_attention.py), at the
reference's tolerance for that test, rtol = atol = 2e-4.  Inputs come
from numpy with a seed.  The backward kernel itself runs only on a card
(tests/test_torch_cuda.py); here its wrapper's contract is checked.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import jnp_impl as ref_jnp  # noqa: E402
from repro_torch.kernels.flash_attention import jnp_impl, ops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

# tests/test_flash_attention.py CASES, the float32 ones:
# B, T, S, Hq, Hkv, Dh, Dv, window, softcap, ragged
CASES = [
    (2, 64, 64, 4, 4, 32, 32, None, 0.0, False),
    (1, 128, 128, 8, 2, 16, 16, None, 0.0, False),
    (2, 96, 96, 4, 1, 32, 32, 24, 0.0, False),     # MQA + window
    (1, 64, 64, 4, 4, 32, 32, None, 30.0, False),  # softcap
    (2, 33, 77, 4, 2, 16, 48, None, 0.0, True),    # ragged, Dv != Dh
    # and the heads of 256 the card's backward takes at gemma2's
    # shape: GQA, a window under T, softcap 50
    (2, 70, 90, 4, 2, 256, 256, 24, 50.0, True),
]


def _mk(B, T, S, Hq, Hkv, Dh, Dv, ragged, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32)
    off = rng.integers(0, S - T + 1, (B,)) if ragged else np.zeros((B,),
                                                                  np.int64)
    qpos = (off[:, None] + np.arange(T)[None, :]).astype(np.int32)
    return q, k, v, qpos


def _ref_grads(q, k, v, qpos, window, softcap, block):
    def loss(q, k, v):
        return jnp.sum(jnp.square(ref_jnp.blockwise_attention(
            q, k, v, qpos=jnp.asarray(qpos), window=window, softcap=softcap,
            block_q=block, block_kv=block)))
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, qpos, window, softcap, block):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = jnp_impl.blockwise_attention(
        *leaves, qpos=torch.from_numpy(qpos), window=window, softcap=softcap,
        block_q=block, block_kv=block)
    out.square().sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("case, block", [(c, 32) for c in CASES] + [
    (CASES[1], 512), (CASES[4], 512)])      # one block of all of T and S
def test_plain_backward_matches_reference_custom_vjp(case, block):
    B, T, S, Hq, Hkv, Dh, Dv, window, softcap, ragged = case
    q, k, v, qpos = _mk(B, T, S, Hq, Hkv, Dh, Dv, ragged)
    want = _ref_grads(q, k, v, qpos, window, softcap, block)
    got = _port_grads(q, k, v, qpos, window, softcap, block)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_plain_backward_fully_masked_rows_have_zero_grad():
    """Padding rows (qpos -1) and rows whose window sees no key carry
    lse = -1e30: their p is 0, not exp of it, so every gradient is
    finite and a masked row's dq is exactly 0, as in the reference."""
    q, k, v, _ = _mk(2, 40, 56, 4, 2, 16, 16, False, seed=4)
    qpos = np.broadcast_to(np.arange(16, 56), (2, 40)).astype(np.int32)
    qpos[:, :7] = -1
    qpos[1, 10:14] = 400
    want = _ref_grads(q, k, v, qpos, 5, 0.0, 16)
    got = _port_grads(q, k, v, qpos, 5, 0.0, 16)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    assert float(got[0][:, :7].abs().sum()) == 0.0
    assert float(got[0][1, 10:14].abs().sum()) == 0.0


def test_plain_forward_saves_lse_not_blocks():
    """The saved tensors are the inputs, the float32 output and one
    log-sum-exp per row: no (T x S) probabilities."""
    q, k, v, qpos = _mk(1, 64, 64, 4, 2, 16, 16, False)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = jnp_impl.blockwise_attention(*leaves, qpos=torch.from_numpy(qpos),
                                       block_q=16, block_kv=16)
    saved = out.grad_fn.saved_tensors
    assert sum(t.numel() for t in saved) < 4 * sum(x.size for x in
                                                   (q, k, v, qpos))
    lse = saved[-1]
    assert lse.shape == (1, 2, 2, 64) and lse.dtype == torch.float32


def test_auto_dispatch_on_cpu_is_differentiable_past_the_dense_limit():
    """impl='auto' on CPU tensors with T·S > 2048² takes the blockwise
    path, whose gradient is the flash-style backward; it matches dense
    autograd."""
    rng = np.random.default_rng(5)
    T = S = 2050
    q, k, v = (torch.tensor(rng.standard_normal((1, T, 1, 8))
                            .astype(np.float32), requires_grad=True)
               for _ in range(3))
    qpos = torch.arange(T, dtype=torch.int32)[None]
    out = ops.flash_attention(q, k, v, qpos=qpos)
    assert type(out.grad_fn).__name__ == "_BlockwiseAttentionBackward"
    do = torch.from_numpy(rng.standard_normal((1, T, 1, 8))
                          .astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), do)
    dense = ops.flash_attention(q, k, v, qpos=qpos, impl="dense")
    want = torch.autograd.grad(dense, (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("dtype, Dh, Dv, want", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.float16, 64, 64, "wgmma"),
    (torch.float32, 128, 128, "ffma"), (torch.float32, 64, 64, "ffma"),
    (torch.bfloat16, 256, 256, "wgmma"), (torch.float32, 256, 256, "ffma")])
def test_backward_variant_by_dtype(dtype, Dh, Dv, want):
    assert kernel.bwd_variant(dtype, Dh, Dv) == want


@pytest.mark.parametrize("variant, B, T, S, Hq, Hkv, D, shapes", [
    ("wgmma", 1, 4096, 4096, 32, 4, 128,
     ((1, 32, 64, 2, 64), (8448,), (2, 1, 4096, 32, 128))),
    ("wgmma", 2, 100, 130, 8, 8, 64, ((2, 8, 2, 2, 64), (528,), None)),
    ("wgmma", 1, 129, 300, 8, 1, 64, ((1, 8, 4, 2, 64), (528,),
                                       (2, 1, 300, 8, 64))),
    ("ffma", 2, 100, 130, 8, 1, 64, ((2, 8, 100), None, None)),
    ("ffma", 1, 7, 9, 2, 2, 128, ((1, 2, 7), None, None)),
    # the Dh-256 training shapes: gemma2 (16 over 8 heads) and
    # recurrentgemma (10 over 1), one microbatch of 4096 tokens
    ("wgmma", 1, 4096, 4096, 16, 8, 256,
     ((1, 16, 64, 2, 64), (8448,), (2, 1, 4096, 16, 256))),
    ("wgmma", 1, 4096, 4096, 10, 1, 256,
     ((1, 10, 64, 2, 64), (8448,), (2, 1, 4096, 10, 256)))])
def test_backward_scratch_by_variant(variant, B, T, S, Hq, Hkv, D, shapes):
    """The scratch each variant's C entry reads: wgmma's per-tile lse
    and delta over 2 * ceil(T / 128) tiles of 64 rows, its row bounds
    and tile ranges, and with a GQA group the float32 partials of dk
    and dv per query head (134 MB at the training shape)."""
    got = kernel.bwd_scratch(variant, B, T, S, Hq, Hkv, D, "cpu")
    assert tuple(None if t is None else tuple(t.shape) for t in got) == shapes
    assert got[0].dtype == torch.float32
    if got[1] is not None:
        assert got[1].dtype == torch.int32
    if got[2] is not None:
        assert got[2].dtype == torch.float32
        assert got[2].numel() * 4 == 2 * B * S * Hq * D * 4


@pytest.mark.parametrize("Dh, Dv", [(32, 32), (192, 128), (128, 64)])
def test_backward_refuses_other_head_dims(Dh, Dv):
    with pytest.raises(ValueError, match="Dh = Dv in"):
        kernel.bwd_variant(torch.bfloat16, Dh, Dv)


def test_cpu_tensors_launch_no_backward_kernel():
    """On CPU tensors the gradient is the plain version's: the kernel
    counters do not move, and impl='cuda' refuses CPU tensors."""
    before = (kernel.flash_attention_bwd_cuda.launches,
              dict(kernel.flash_attention_bwd_cuda.by_variant))
    q, k, v, qpos = _mk(1, 64, 64, 4, 2, 64, 64, False)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    ops.flash_attention(*leaves, qpos=torch.from_numpy(qpos),
                        impl="blockwise").sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    assert (kernel.flash_attention_bwd_cuda.launches,
            dict(kernel.flash_attention_bwd_cuda.by_variant)) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*leaves, qpos=torch.from_numpy(qpos),
                            impl="cuda")
