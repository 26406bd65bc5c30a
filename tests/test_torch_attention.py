"""The port's flash-attention package against the reference's.

Inputs come from numpy with a seed and go through both packages.  In
float32 every plain version (dense, blockwise, banded, and the
``auto`` dispatch) is held to the reference's own bound for its Pallas
kernel, rtol = atol = 2e-5 (tests/test_pallas_parity.py); the two
frameworks sum q.k and p.v in other orders, so bit equality is not
expected.  The reference's Pallas kernel itself runs in interpret
mode, at the tiny shapes its own parity tests use, against the port's
plain versions.  The CUDA kernel runs only on a card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import jnp_impl as ref_jnp  # noqa: E402
from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import ref as ref_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro_torch.kernels.flash_attention import jnp_impl, ops, ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B=2, T=40, S=56, Hq=4, Hkv=2, Dh=16, Dv=None,
            qpos="causal"):
    rng = np.random.default_rng(seed)
    Dv = Dv or Dh
    q = rng.standard_normal((B, T, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32)
    if qpos == "causal":                       # the prefill layout
        pos = np.broadcast_to(np.arange(S - T, S), (B, T))
    elif qpos == "offset":                     # per-batch offsets, banded
        pos = np.arange(T)[None, :] + np.array([[0], [S - T]])[:B]
    else:                                      # ragged, -1 marks padding
        pos = rng.integers(-1, S + 4, (B, T))
        pos[:, :5] = -1
    return q, k, v, np.ascontiguousarray(pos, dtype=np.int32)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


CASES = [dict(), dict(window=16), dict(softcap=8.0),
         dict(window=7, softcap=5.0), dict(qpos="ragged"),
         dict(qpos="ragged", window=9), dict(Hq=4, Hkv=1, Dv=24),
         dict(T=1, S=70),
         # gemma2's heads: 16 over 8 of Dh 256, its local window, softcap
         dict(Hq=16, Hkv=8, Dh=256, window=16, softcap=50.0)]


def _split(case):
    case = dict(case)
    return case.pop("window", None), case.pop("softcap", 0.0), case


@pytest.mark.parametrize("case", CASES)
def test_dense_matches_reference(case):
    window, softcap, shape = _split(case)
    q, k, v, qpos = _inputs(1, **shape)
    want = ref_ref.dense_attention(q, k, v, qpos=qpos, window=window,
                                   softcap=softcap)
    got = ref.dense_attention(*_t(q, k, v), qpos=torch.from_numpy(qpos),
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_blockwise_matches_reference(case):
    """Blocks smaller than T and S, so the online softmax carries over
    several q and kv blocks, with ragged last blocks."""
    window, softcap, shape = _split(case)
    q, k, v, qpos = _inputs(2, **shape)
    kw = dict(window=window, softcap=softcap, block_q=16, block_kv=24)
    want = ref_jnp.blockwise_attention(q, k, v, qpos=qpos, **kw)
    got = jnp_impl.blockwise_attention(*_t(q, k, v),
                                       qpos=torch.from_numpy(qpos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = ref.dense_attention(*_t(q, k, v), qpos=torch.from_numpy(qpos),
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("window,softcap", [(8, 0.0), (13, 6.0), (40, 0.0)])
def test_banded_matches_reference(window, softcap):
    q, k, v, qpos = _inputs(3, T=40, S=56, qpos="offset")
    kw = dict(window=window, softcap=softcap, block_q=16)
    want = ref_jnp.banded_attention(q, k, v, qpos=qpos, **kw)
    got = jnp_impl.banded_attention(*_t(q, k, v),
                                    qpos=torch.from_numpy(qpos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,window,picks", [
    (dict(T=40, S=56), None, "dense"),
    (dict(T=40, S=56), 8, "banded"),          # 8 * 4 < 56
    (dict(T=40, S=56), 30, "dense"),          # 30 * 4 >= 56
    (dict(B=1, T=2100, S=2100, Hq=2, Hkv=1, Dh=8), None, "blockwise"),
])
def test_auto_picks_what_the_reference_picks_off_tpu(shape, window, picks):
    q, k, v, qpos = _inputs(4, qpos="offset" if window else "causal",
                            **shape)
    want = ref_ops.flash_attention(q, k, v, qpos=qpos, window=window)
    args = dict(qpos=torch.from_numpy(qpos), window=window)
    got = ops.flash_attention(*_t(q, k, v), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    named = ops.flash_attention(*_t(q, k, v), impl=picks, **args)
    assert torch.equal(got, named)


@pytest.mark.parametrize("case", [
    dict(), dict(window=16), dict(softcap=8.0), dict(Hq=4, Hkv=2),
    dict(qpos="ragged"), dict(Dh=8, Dv=16), dict(Hq=4, Hkv=1, window=5,
                                                  softcap=3.0)])
def test_reference_pallas_interpret_matches_port_plain(case):
    """The reference's TPU kernel (interpret mode) against the port's
    plain versions, at tests/test_pallas_parity.py's tiny shapes."""
    window, softcap, shape = _split(case)
    shape = {"B": 1, "T": 32, "S": 32, "Hq": 2, "Hkv": 2, "Dh": 8, **shape}
    q, k, v, qpos = _inputs(5, **shape)
    want = flash_attention_pallas(q, k, v, qpos=qpos, window=window,
                                  softcap=softcap, block_q=16, block_kv=16,
                                  interpret=True)
    tq = _t(q, k, v)
    for got in (ref.dense_attention(*tq, qpos=torch.from_numpy(qpos),
                                    window=window, softcap=softcap),
                jnp_impl.blockwise_attention(
                    *tq, qpos=torch.from_numpy(qpos), window=window,
                    softcap=softcap, block_q=16, block_kv=16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_bf16_matches_reference():
    """bf16 inputs: the logits are exact float32 products in both
    packages; 1e-2 covers one bf16 rounding of p and of the output."""
    q, k, v, qpos = _inputs(6, qpos="ragged")
    want = ref_ref.dense_attention(*(jnp.asarray(x, jnp.bfloat16)
                                     for x in (q, k, v)), qpos=qpos)
    got = ref.dense_attention(*(x.bfloat16() for x in _t(q, k, v)),
                              qpos=torch.from_numpy(qpos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_cuda_impl_raises_on_cpu_tensors():
    q, k, v, qpos = _inputs(7)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(*_t(q, k, v), qpos=torch.from_numpy(qpos),
                            impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(*_t(q, k, v), qpos=torch.from_numpy(qpos),
                            impl="pallas")
