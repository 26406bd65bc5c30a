"""Flash attention's RoPE operands (``q_rope``, ``k_rope``) on the CPU.

MLA's naive form passes the RoPE parts of q and of the shared key beside
q and K instead of concatenating them; the card's wgmma kernel at Dh 192
/ Dv 128 reads them in place.  On the CPU every plain version joins them
to q and k (``ref.join_rope``) and computes as before, so:

* the plain versions with the operands equal the same call on the
  concatenated tensors bit for bit;
* they match the reference's ``flash_attention`` on the concatenation
  within the reference's own bounds (``tests/test_flash_attention.py``:
  rtol = atol = 2e-5 in float32, 2e-2 in bf16);
* bad operands raise;
* the MLA layer's naive form, which now passes them, still matches the
  reference's layer as in ``tests/test_torch_mla.py`` (float32, rtol
  1e-4 plus 1e-4 of max|value|; 2e-4 of it where a bf16 cache is read
  back).

Inputs come from numpy with a seed.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig, MLACfg  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro_torch.kernels.flash_attention import jnp_impl, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    check_rope, flash_attention_cuda)
from repro_torch.models import mla  # noqa: E402

REF_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, B=2, T=40, S=56, Hq=4, Hkv=2, Dn=16, Dr=8, Dv=16,
            qpos="causal", dtype=torch.float32):
    """q (B,T,Hq,Dn), k (B,S,Hkv,Dn), v, q_rope (B,T,Hq,Dr), k_rope
    (B,S,1,Dr) and qpos, from numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    q, k, v = t(B, T, Hq, Dn), t(B, S, Hkv, Dn), t(B, S, Hkv, Dv)
    q_rope, k_rope = t(B, T, Hq, Dr), t(B, S, 1, Dr)
    if qpos == "causal":                       # the prefill layout
        pos = np.broadcast_to(np.arange(S - T, S), (B, T))
    else:                                      # ragged, -1 marks padding
        pos = rng.integers(-1, S + 4, (B, T))
        pos[:, :5] = -1
    return q, k, v, q_rope, k_rope, torch.from_numpy(
        np.ascontiguousarray(pos, dtype=np.int32))


# (name, the call with keyword operands); "banded" needs a window
CALLS = {
    "ops dense": lambda *a, **kw: ops.flash_attention(*a, impl="dense", **kw),
    "ops blockwise": lambda *a, **kw: ops.flash_attention(
        *a, impl="blockwise", block_q=16, block_kv=24, **kw),
    "ops banded": lambda *a, **kw: ops.flash_attention(
        *a, impl="banded", block_q=16, **kw),
    "ops auto": lambda *a, **kw: ops.flash_attention(*a, **kw),
    "ref.dense_attention": ref.dense_attention,
    "jnp_impl.blockwise_attention": lambda *a, **kw: (
        jnp_impl.blockwise_attention(*a, block_q=16, block_kv=24, **kw)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", list(CALLS))
def test_rope_operands_equal_the_concatenation(call, dtype):
    """Each plain version with the RoPE operands gives the bits of the
    same call on q and k with the RoPE columns appended (the key's one
    head repeated over the kv heads), with GQA, a window and a softcap
    where the version takes them."""
    q, k, v, qr, kr, qpos = _inputs(1, dtype=dtype)
    kw = dict(qpos=qpos, window=12 if "banded" in call else None,
              softcap=5.0)
    q_cat = torch.cat([q, qr], -1)
    k_cat = torch.cat([k, kr.expand(*k.shape[:3], kr.shape[-1])], -1)
    fn = CALLS[call]
    got = fn(q, k, v, q_rope=qr, k_rope=kr, **kw)
    want = fn(q_cat, k_cat, v, **kw)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", [
    dict(), dict(window=16), dict(qpos="ragged"), dict(Hq=4, Hkv=4),
    dict(Hq=4, Hkv=1, softcap=8.0), dict(T=1, S=70),
    dict(dtype=torch.bfloat16), dict(dtype=torch.bfloat16, qpos="ragged")])
def test_rope_operands_match_reference(case):
    """The port's dispatch with the operands against the reference's
    ``flash_attention`` on the concatenated q and k, within the
    reference's own bound for the dtype."""
    case = dict(case)
    window, softcap = case.pop("window", None), case.pop("softcap", 0.0)
    dtype = case.get("dtype", torch.float32)
    q, k, v, qr, kr, qpos = _inputs(2, **case)
    q_cat, k_cat = ref.join_rope(q, k, qr, kr)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = ref_flash(*(jnp.asarray(x.float().numpy(), jdt)
                       for x in (q_cat, k_cat, v)),
                     qpos=jnp.asarray(qpos.numpy()), window=window,
                     softcap=softcap)
    got = ops.flash_attention(q, k, v, q_rope=qr, k_rope=kr, qpos=qpos,
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **REF_TOL[dtype])


def _bad(q, k, qr, kr):
    B, T, Hq, _ = q.shape
    S = k.shape[1]
    return {
        "q_rope alone": (ValueError, dict(q_rope=qr)),
        "k_rope alone": (ValueError, dict(k_rope=kr)),
        "q_rope of other T": (ValueError, dict(q_rope=qr[:, 1:], k_rope=kr)),
        "q_rope of other heads": (ValueError,
                                  dict(q_rope=qr[:, :, 1:], k_rope=kr)),
        "k_rope of 2 heads": (ValueError, dict(
            q_rope=qr, k_rope=kr.expand(B, S, 2, kr.shape[-1]))),
        "k_rope of other S": (ValueError, dict(q_rope=qr, k_rope=kr[:, 1:])),
        "k_rope of other width": (ValueError,
                                  dict(q_rope=qr, k_rope=kr[..., :4])),
        "q_rope 3-d": (ValueError, dict(q_rope=qr[:, :, 0], k_rope=kr)),
        "q_rope of another dtype": (TypeError, dict(
            q_rope=qr.double(), k_rope=kr)),
        "k_rope of another dtype": (TypeError, dict(
            q_rope=qr, k_rope=kr.to(torch.bfloat16))),
        "k_rope on another device": (ValueError, dict(
            q_rope=qr, k_rope=torch.empty(kr.shape, device="meta"))),
    }


BAD = list(_bad(*_inputs(3)[:2], *_inputs(3)[3:5]))


@pytest.mark.parametrize("bad", BAD)
def test_bad_rope_operands_raise(bad):
    """Every entry point checks the operands before computing: the plain
    dispatch, each impl, and the kernel's wrapper."""
    q, k, v, qr, kr, qpos = _inputs(3)
    err, kw = _bad(q, k, qr, kr)[bad]
    for impl in ("auto", "dense", "blockwise"):
        with pytest.raises(err):
            ops.flash_attention(q, k, v, qpos=qpos, impl=impl, **kw)
    with pytest.raises(err):
        flash_attention_cuda(q, k, v, qpos=qpos, **kw)
    assert check_rope(q, k, qr, kr) == qr.shape[-1]
    assert check_rope(q, k, None, None) == 0


# ----------------------------------------------------------------------
# MLA's naive form (the one-layer config of tests/test_torch_mla.py)
# ----------------------------------------------------------------------
ref_attention = jax.jit(ref_mla.mla_attention, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def layer():
    kw = dict(name="mla-test", family="moe", n_layers=1, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=64, vocab=128, d_head=8)
    cfg = ArchConfig(**kw, mla=MLACfg(q_lora=16, kv_lora=16, d_nope=8,
                                      d_rope=4, d_v=8))
    rp = jax.jit(lambda key: jax.tree.map(
        lambda a: a[0], ref_mla.mla_params(key, cfg, n_layers=1)[0]))(
            jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    for name in ("q_norm", "kv_norm"):
        rp[name] = jnp.asarray(rng.normal(0, 0.2, rp[name].shape),
                               jnp.float32)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in rp.items()}
    return cfg, rp, tp


@pytest.mark.parametrize("cached", [False, True])
def test_mla_naive_form_passes_rope_operands_and_matches_reference(
        layer, cached, monkeypatch):
    """At T 1024 (the naive form) the layer hands flash q and K of
    d_nope columns beside q_rope and a one-head k_rope (no concatenation,
    no broadcast over the heads), from a cache and without one, and
    its output still matches the reference's layer."""
    cfg, rp, tp = layer
    m = cfg.mla
    seen = []
    real = mla.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape, kw["q_rope"].shape,
                     kw["k_rope"].shape))
        return real(q, k, v, **kw)
    monkeypatch.setattr(mla, "flash_attention", spy)
    B, T = 2, 1024
    x = np.random.default_rng(T).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    if cached:
        Tmax = T + 16
        rc = {"ckv": jnp.zeros((B, Tmax, 20), jnp.bfloat16),
              "pos": jnp.zeros((B,), jnp.int32)}
        tc = {"ckv": mla.init_mla_cache(cfg, 1, B, Tmax,
                                        device="cpu")["ckv"][0],
              "pos": torch.zeros((B,), dtype=torch.int32)}
        want, _ = ref_attention(rp, jnp.asarray(x), cfg=cfg, cache=rc)
        got, _ = mla.mla_attention(tp, torch.from_numpy(x), cfg, cache=tc)
        of_max = 2e-4
    else:
        want, _ = ref_attention(rp, jnp.asarray(x), cfg=cfg)
        got, _ = mla.mla_attention(tp, torch.from_numpy(x), cfg)
        of_max = 1e-4
    S = Tmax if cached else T
    H = cfg.n_heads
    assert seen == [(
        (B, T, H, m.d_nope), (B, S, H, m.d_nope), (B, T, H, m.d_rope),
        (B, S, 1, m.d_rope))]
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=of_max * float(np.abs(want).max()))
