"""The port's hand-written CUDA kernels and its main path on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device; on a card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports only torch, numpy and ``repro_torch``, so it runs
where the reference package (and jax) is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (Box, COL_ALL, HDArrayRuntime, IDENTITY_2D,
                              ROW_ALL, stencil)
from repro_torch.kernels.gemm_hd import kernel as gemm_kernel
from repro_torch.kernels.gemm_hd.ops import gemm
from repro_torch.kernels.hd import make_gemm_kernel, make_jacobi_kernel
from repro_torch.kernels.stencil_hd import kernel as jacobi_kernel
from repro_torch.kernels.stencil_hd.ops import jacobi_step
from repro_torch.kernels.stencil_hd.ref import jacobi_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(37, 53), (300, 64), (1030, 700)])
def test_jacobi_cuda_bit_identical_to_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    big = torch.randn((shape[0] + 4, shape[1]), generator=g, device=cuda)
    x = big[2:2 + shape[0]]                   # a row-band view
    assert torch.equal(jacobi_step(x), jacobi_ref(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 48, 32), (33, 512, 17),
                                   (300, 1100, 257)])
def test_gemm_cuda_matches_f64(cuda, shape, dtype):
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    big = torch.randn((M + 3, K), generator=g, device=cuda).to(dtype)
    a = big[1:1 + M]                          # a row-band view
    b = torch.randn((K, N), generator=g, device=cuda).to(dtype)
    out = gemm(a, b, alpha=1.5)
    assert out.dtype == dtype
    o = 1.5 * (a.double() @ b.double())
    tol = 5e-5 if dtype == torch.float32 else 4e-3
    assert float(torch.linalg.norm(out.double() - o)
                 / torch.linalg.norm(o)) <= tol


@pytest.mark.parametrize("window", [((1, 299), (1, 63)), ((0, 300), (0, 64)),
                                    ((17, 250), (5, 40)), ((298, 300), (0, 9))])
def test_jacobi_cuda_window_into_pitched_band(cuda, window):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((300, 64), generator=g, device=cuda)
    (i0, i1), (j0, j1) = window
    dst = torch.full((310, 90), 7.0, device=cuda)
    band = dst[4:4 + i1 - i0, 3:3 + j1 - j0]   # row pitch 90, not j1 - j0
    assert jacobi_step(x, window=window, out=band) is band
    assert torch.equal(band, jacobi_ref(x)[i0:i1, j0:j1])
    dst[4:4 + i1 - i0, 3:3 + j1 - j0] = 7.0
    assert torch.equal(dst, torch.full_like(dst, 7.0))


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
def test_gemm_cuda_mixed_dtypes_into_pitched_band(cuda, dtypes):
    """The two mixed builds (float32 in, bfloat16 out and back), each
    writing through a row pitch wider than the product."""
    din, dout = dtypes
    M, K, N = 130, 257, 99
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((M, K), generator=g, device=cuda).to(din)
    b = torch.randn((K, N), generator=g, device=cuda).to(din)
    dst = torch.full((M + 6, N + 20), 5.0, dtype=dout, device=cuda)
    band = dst[3:3 + M, 7:7 + N]
    assert gemm(a, b, alpha=1.5, out=band) is band
    assert gemm(a, b, alpha=1.5, out_dtype=dout).dtype == dout
    o = 1.5 * (a.double() @ b.double())
    # bf16 inputs are exact in the float64 product, so a float32 output
    # keeps the float32 bound; a bf16 output carries its own rounding
    tol = 5e-5 if dout == torch.float32 else 4e-3
    assert float(torch.linalg.norm(band.double() - o)
                 / torch.linalg.norm(o)) <= tol
    dst[3:3 + M, 7:7 + N] = 5.0
    assert torch.equal(dst, torch.full_like(dst, 5.0))


def test_cuda_wrappers_count_launches_and_reject_bad_strides(cuda):
    jacobi_kernel.jacobi_cuda.launches = 0
    gemm_kernel.gemm_cuda.launches = 0
    x = torch.ones((16, 16), device=cuda)
    jacobi_step(x)
    gemm(x, x)
    assert jacobi_kernel.jacobi_cuda.launches == 1
    assert gemm_kernel.gemm_cuda.launches == 1
    with pytest.raises(ValueError, match="contiguous rows"):
        jacobi_step(x.t()[:, :8])
    with pytest.raises(ValueError, match="contiguous rows"):
        gemm(x.t()[:, :8], x[:8])
    with pytest.raises(ValueError, match="contiguous rows"):
        gemm(x, x, out=torch.empty((16, 16), device=cuda).t())
    with pytest.raises(TypeError):
        jacobi_step(x.double())


def _jacobi_pipeline(rt, n=96, sweeps=6):
    init = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=Box.make((1, n - 1), (1, n - 1)))
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    ab, ba = make_jacobi_kernel("A", "B"), make_jacobi_kernel("B", "A")
    fp = stencil(2, 1)
    rt.run_pipeline([
        dict(kernel_name="jab", part_id=pw, kernel=ab, arrays=[A, B],
             uses={"A": fp}, defs={"B": IDENTITY_2D}) if i % 2 == 0 else
        dict(kernel_name="jba", part_id=pw, kernel=ba, arrays=[A, B],
             uses={"B": fp}, defs={"A": IDENTITY_2D})
        for i in range(sweeps)])
    return rt.read_coherent(A), rt.read_coherent(B)


def test_jacobi_path_on_card_bit_identical_to_cpu(cuda):
    jacobi_kernel.jacobi_cuda.launches = 0
    rt = HDArrayRuntime(4)                 # the default: torch on the card
    got = _jacobi_pipeline(rt)
    ex = rt.executor
    assert ex.device_class == "cuda"
    assert jacobi_kernel.jacobi_cuda.launches == 6 * 4
    assert ex.h2d_transfers == 2           # the two writes
    assert ex.d2h_transfers == 2           # the two reads
    want = _jacobi_pipeline(HDArrayRuntime(4, device="cpu"))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_gemm_path_on_card(cuda):
    n = 160
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    gemm_kernel.gemm_cuda.launches = 0
    rt = HDArrayRuntime(4)
    part = rt.partition_row((n, n))
    hA, hB, hC = (rt.create(s, (n, n)) for s in "abc")
    rt.write(hA, a, part)
    rt.write(hB, b, part)
    rt.write(hC, np.zeros((n, n), np.float32), part)
    mm = make_gemm_kernel("a", "b", "c", alpha=1.5)
    for _ in range(2):
        rt.apply_kernel("gemm", part, mm, [hA, hB, hC],
                        uses={"a": ROW_ALL, "b": COL_ALL},
                        defs={"c": IDENTITY_2D})
    assert gemm_kernel.gemm_cuda.launches == 2 * 4
    assert rt.comm_log[-1][1] == 0         # the second call moves nothing
    o = 1.5 * (a.astype(np.float64) @ b.astype(np.float64))
    c = rt.read(hC, part)
    assert np.linalg.norm(c - o) / np.linalg.norm(o) <= 5e-5
