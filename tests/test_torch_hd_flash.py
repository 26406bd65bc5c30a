"""``make_flash_kernel``, flash attention as an HDArray device kernel,
against the reference's on the CPU.

One sequence of T positions as 2-D ``(T, heads*dim)`` HDArrays, the
queries row-partitioned over 4 ranks, K and V read whole (ALL_2D), O
defined on each rank's rows.  The port runs on its resident executor
(``backend="torch"``, ``device="cpu"``: the plain versions) and on its
``sim`` oracle, the reference on its ``sim`` backend with the Pallas
kernel in interpret mode; inputs float32 from a numpy seed.  Both are
held to each other and to the dense attention over the whole sequence
within the flash bound in float32 (2e-5: the reference's
``tests/test_pallas_parity.py``), for Dh = Dv (GQA, 4/2 heads of 16)
and Dh != Dv (4/4 heads of 24 and 16, the shape of MLA's naive form),
with and without a window.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.kernels.hd as ref_hd  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.kernels.hd as port_hd  # noqa: E402
from repro_torch.kernels.flash_attention import dense_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_cuda  # noqa: E402

NPROC = 4
FLASH_F32_TOL = 2e-5
SHAPES = {  # T, heads, kv_heads, dim, out_dim
    "Dh=Dv gqa": (64, 4, 2, 16, 16),
    "Dh!=Dv": (72, 4, 4, 24, 16)}


def _inputs(T, Hq, Hkv, Dh, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, Hq * Dh)).astype(np.float32),
            rng.standard_normal((T, Hkv * Dh)).astype(np.float32),
            rng.standard_normal((T, Hkv * Dv)).astype(np.float32))


def _flash_program(mod, rt, kernel, q, k, v, out_width):
    """Q row-partitioned, K and V whole, O on each rank's rows; one
    apply_kernel.  Returns O as the ranks left it."""
    T = q.shape[0]
    arrs = [rt.create("Q", q.shape), rt.create("K", k.shape),
            rt.create("V", v.shape), rt.create("O", (T, out_width))]
    part = rt.partition_row(q.shape)
    rt.write(arrs[0], q, part)
    rt.write_replicated(arrs[1], k)
    rt.write_replicated(arrs[2], v)
    rt.write(arrs[3], np.zeros((T, out_width), np.float32),
             rt.partition_row((T, out_width)))
    rt.apply_kernel("flash", part, kernel, arrs,
                    uses={"Q": mod.ROW_ALL, "K": mod.ALL_2D,
                          "V": mod.ALL_2D},
                    defs={"O": mod.ROW_ALL})
    return rt.read_coherent(arrs[3])


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_flash_kernel_matches_reference_sim(name, window):
    T, Hq, Hkv, Dh, Dv = SHAPES[name]
    q, k, v = _inputs(T, Hq, Hkv, Dh, Dv)
    kw = dict(heads=Hq, dim=Dh, kv_heads=Hkv, out_dim=Dv, window=window)
    flash_attention_cuda.launches = 0
    want = _flash_program(
        ref, ref.HDArrayRuntime(NPROC, backend="sim"),
        ref_hd.make_flash_kernel(impl="pallas", **kw), q, k, v, Hq * Dv)
    kern = port_hd.make_flash_kernel(**kw)
    rt = port.HDArrayRuntime(NPROC, backend="torch", device="cpu")
    got = _flash_program(port, rt, kern, q, k, v, Hq * Dv)
    sim = _flash_program(port, port.HDArrayRuntime(NPROC, backend="sim"),
                         kern, q, k, v, Hq * Dv)
    assert got.dtype == np.float32 and got.shape == (T, Hq * Dv)
    np.testing.assert_allclose(got, want, rtol=FLASH_F32_TOL,
                               atol=FLASH_F32_TOL)
    assert np.array_equal(got, sim)
    # the whole sequence at once, dense: causality held across the bands
    whole = dense_attention(
        torch.from_numpy(q).reshape(1, T, Hq, Dh),
        torch.from_numpy(k).reshape(1, T, Hkv, Dh),
        torch.from_numpy(v).reshape(1, T, Hkv, Dv),
        qpos=torch.arange(T, dtype=torch.int32)[None], window=window)
    np.testing.assert_allclose(got, whole.reshape(T, Hq * Dv).numpy(),
                               rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)
    assert rt.executor.device_kernel_launches == 1
    # CPU tensors run the plain version: the CUDA kernel never launched
    assert flash_attention_cuda.launches == 0


def test_flash_kernel_writes_only_its_band():
    """Each rank's call writes its own rows of O in place, through the
    rows' pitch, and leaves every other row as it was."""
    T, Hq, Hkv, Dh, Dv = SHAPES["Dh!=Dv"]
    q, k, v = _inputs(T, Hq, Hkv, Dh, Dv, seed=1)
    kern = port_hd.make_flash_kernel(heads=Hq, dim=Dh, kv_heads=Hkv,
                                     out_dim=Dv)
    o = torch.full((T, Hq * Dv), 7.0)
    base = o.data_ptr()

    class Region:
        bounds = ((16, 40), (0, Hq * Dh))

    out = kern(Region(), {"Q": torch.from_numpy(q), "K": torch.from_numpy(k),
                          "V": torch.from_numpy(v), "O": o})
    assert out["O"] is o and o.data_ptr() == base
    assert torch.all(o[:16] == 7.0) and torch.all(o[40:] == 7.0)
    assert not torch.any(o[16:40] == 7.0)
    with pytest.raises(ValueError, match="share memory"):
        kern(Region(), {"Q": torch.from_numpy(q), "K": torch.from_numpy(k),
                        "V": torch.from_numpy(v),
                        "O": torch.from_numpy(q)[:, :Hq * Dv]})
