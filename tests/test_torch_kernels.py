"""The port's tile kernels against the reference's.

On the CPU every op runs its plain PyTorch version, which is held
against the reference package's Pallas kernels (interpret mode, as
test_pallas_parity.py runs them) and its jnp oracles: the Jacobi sweep
bit for bit, the GEMM within the stated tolerances (the CPU BLAS
accumulates in another order than XLA's dot).  The CUDA kernels
themselves run only on a card: test_torch_cuda.py holds them.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.gemm_hd.ops import gemm as ref_gemm
from repro.kernels.stencil_hd.ops import jacobi_step as ref_jacobi
from repro_torch.kernels.gemm_hd import kernel as gemm_kernel
from repro_torch.kernels.gemm_hd.ops import gemm
from repro_torch.kernels.gemm_hd.ref import gemm_ref
from repro_torch.kernels.stencil_hd import kernel as jacobi_kernel
from repro_torch.kernels.stencil_hd.ops import jacobi_step
from repro_torch.kernels.stencil_hd.ref import jacobi_ref


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# -- Jacobi: bit-identical to the reference -----------------------------
@pytest.mark.parametrize("shape", [(37, 53), (300, 64)])
def test_jacobi_plain_bit_identical_to_reference(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    got = jacobi_step(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(ref_jacobi(x, impl="pallas")))
    assert np.array_equal(got, np.asarray(ref_jacobi(x, impl="ref")))


def test_jacobi_plain_matches_numpy_oracle(rng):
    x = rng.standard_normal((41, 29)).astype(np.float32)
    got = jacobi_ref(torch.from_numpy(x)).numpy()
    o = x.copy()
    o[1:-1, 1:-1] = (x[1:-1, :-2] + x[1:-1, 2:]
                     + x[:-2, 1:-1] + x[2:, 1:-1]) * np.float32(0.25)
    assert np.array_equal(got, o)
    # edges pass through untouched
    assert np.array_equal(got[0], x[0]) and np.array_equal(got[-1], x[-1])
    assert np.array_equal(got[:, 0], x[:, 0])
    assert np.array_equal(got[:, -1], x[:, -1])


# -- GEMM: within tolerance of the reference ----------------------------
@pytest.mark.parametrize("shape", [(64, 48, 32), (33, 512, 17)])
def test_gemm_plain_matches_reference_pallas(rng, shape):
    M, K, N = shape
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    got = gemm(torch.from_numpy(a), torch.from_numpy(b), alpha=1.5).numpy()
    want = np.asarray(ref_gemm(a, b, alpha=1.5, impl="pallas"))
    assert got.dtype == np.float32
    # the two CPU products sum K float32 terms in different orders: at
    # K=512 the entries reach ~50 and one in 561 differs by 2.8e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_gemm_plain_matches_f64_oracle(rng):
    M, K, N = 40, 600, 24
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    got = gemm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    o = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got, o, rtol=1e-4, atol=1e-3)


def test_gemm_plain_bf16_accumulates_in_f32(rng):
    a = torch.from_numpy(rng.standard_normal((16, 300)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    ab, bb = a.bfloat16(), b.bfloat16()
    out = gemm(ab, bb, alpha=0.5)
    assert out.dtype == torch.bfloat16
    want = (0.5 * (ab.float() @ bb.float())).bfloat16()
    assert torch.equal(out, want)
    assert gemm(ab, bb, out_dtype=torch.float32).dtype == torch.float32


# -- writing into a band of a larger buffer ------------------------------
@pytest.mark.parametrize("window", [((1, 36), (1, 52)), ((0, 37), (0, 53)),
                                    ((5, 20), (3, 50)), ((4, 4), (1, 9))])
def test_jacobi_window_writes_only_its_band(rng, window):
    x = torch.from_numpy(rng.standard_normal((37, 53)).astype(np.float32))
    (i0, i1), (j0, j1) = window
    dst = torch.full((45, 60), 7.0)
    band = dst[3:3 + i1 - i0, 2:2 + j1 - j0]
    assert jacobi_step(x, window=window, out=band) is band
    assert torch.equal(band, jacobi_ref(x)[i0:i1, j0:j1])
    dst[3:3 + i1 - i0, 2:2 + j1 - j0] = 7.0
    assert torch.equal(dst, torch.full((45, 60), 7.0))
    assert torch.equal(jacobi_step(x, window=window),
                       jacobi_ref(x)[i0:i1, j0:j1])


def test_jacobi_window_and_out_are_checked():
    x = torch.zeros((10, 12))
    with pytest.raises(ValueError, match="window"):
        jacobi_step(x, window=((0, 11), (0, 12)))
    with pytest.raises(ValueError, match="window"):
        jacobi_step(x, window=((1, 9), (5, 4)))
    with pytest.raises(ValueError, match="does not hold"):
        jacobi_step(x, window=((1, 9), (1, 11)), out=torch.zeros((8, 9)))
    with pytest.raises(ValueError, match="share memory"):
        jacobi_step(x[:5], out=x[5:])


def test_gemm_out_writes_into_a_pitched_band(rng):
    a = torch.from_numpy(rng.standard_normal((13, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 9)).astype(np.float32))
    dst = torch.full((20, 16), -3.0)
    band = dst[4:17, 5:14]
    assert gemm(a, b, alpha=1.5, out=band) is band
    assert torch.equal(band, gemm_ref(a, b, alpha=1.5))
    dst[4:17, 5:14] = -3.0
    assert torch.equal(dst, torch.full((20, 16), -3.0))
    # out's dtype is the output dtype
    lo = torch.zeros((13, 9), dtype=torch.bfloat16)
    gemm(a, b, out=lo)
    assert torch.equal(lo, gemm_ref(a, b, out_dtype=torch.bfloat16))


def test_gemm_out_is_checked():
    a, b = torch.zeros((6, 4)), torch.zeros((4, 5))
    with pytest.raises(ValueError, match="does not hold"):
        gemm(a, b, out=torch.zeros((5, 6)))
    with pytest.raises(TypeError, match="out_dtype"):
        gemm(a, b, out_dtype=torch.bfloat16, out=torch.zeros((6, 5)))
    with pytest.raises(ValueError, match="share memory"):
        buf = torch.zeros((6, 9))
        gemm(buf[:, :4], b, out=buf[:, 4:])
    with pytest.raises(ValueError, match="do not chain"):
        gemm(a, a)


# -- dispatch on the CPU -------------------------------------------------
def test_cuda_impl_on_cpu_tensor_raises():
    x = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        jacobi_step(x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        gemm(x, x, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        jacobi_step(x, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        gemm(x, x, impl="pallas")


def test_auto_on_cpu_runs_plain_version_without_launching():
    jacobi_kernel.jacobi_cuda.launches = 0
    gemm_kernel.gemm_cuda.launches = 0
    x = torch.randn((20, 20), generator=torch.Generator().manual_seed(0))
    assert torch.equal(jacobi_step(x), jacobi_ref(x))
    assert torch.equal(gemm(x, x), gemm_ref(x, x))
    assert jacobi_kernel.jacobi_cuda.launches == 0
    assert gemm_kernel.gemm_cuda.launches == 0


def test_kernel_modules_import_without_nvcc(tmp_path):
    """Importing builds nothing: the modules load with no nvcc on PATH."""
    code = ("import repro_torch.kernels.hd, repro_torch.kernels.build as b, "
            "repro_torch.kernels.gemm_hd.kernel, "
            "repro_torch.kernels.stencil_hd.kernel; "
            "assert not b._loaded")
    env = {"PATH": str(tmp_path),
           "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
