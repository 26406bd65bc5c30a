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

from repro_torch.configs import get_config
from repro_torch.executors import halo_split
from repro_torch.core import (Box, COL_ALL, HDArrayRuntime, IDENTITY_2D,
                              ROW_ALL, stencil)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import dense_attention
from repro_torch.kernels.gemm_hd import kernel as gemm_kernel
from repro_torch.kernels.gemm_hd.ops import gemm
from repro_torch.kernels.hd import make_gemm_kernel, make_jacobi_kernel
from repro_torch.kernels.stencil_hd import kernel as jacobi_kernel
from repro_torch.kernels.stencil_hd.ops import jacobi_step
from repro_torch.kernels.stencil_hd.ref import jacobi_ref
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig

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


# -- the §4.2 schedule on the card: fused steps, captured cycles, overlap --
# Launch counts are executions: a launch captured into a CUDA graph
# counts once per replay, never at capture.
def _ping_pong(rt, n, sweeps, seed=3):
    """The ping-pong Jacobi program on ``rt`` and its initial data."""
    init = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=Box.make((1, n - 1), (1, n - 1)))
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    ab, ba = make_jacobi_kernel("A", "B"), make_jacobi_kernel("B", "A")
    fp = stencil(2, 1)
    prog = [dict(kernel_name="jab", part_id=pw, kernel=ab, arrays=[A, B],
                 uses={"A": fp}, defs={"B": IDENTITY_2D}) if i % 2 == 0 else
            dict(kernel_name="jba", part_id=pw, kernel=ba, arrays=[A, B],
                 uses={"B": fp}, defs={"A": IDENTITY_2D})
            for i in range(sweeps)]
    return A, B, prog, init


def _sweep_launches(rt, prog, plans, split=True):
    """Jacobi kernel executions of a run: one per rank and step, or,
    where a step sweeps under the exact halo split, one per interior
    and boundary box."""
    n = 0
    for st, plan in zip(prog, plans):
        regions = rt.parts[st["part_id"]].regions
        cut = halo_split(plan, regions, st["uses"], st["defs"]) \
            if split else None
        boxes = list(regions) if cut is None else \
            [b for half in cut for rank in half for b in rank]
        n += sum(1 for b in boxes if not b.is_empty())
    return n


def _plain_sweeps(x, sweeps, dev):
    x = torch.from_numpy(np.asarray(x)).to(dev)
    for _ in range(sweeps):
        x = jacobi_ref(x)
    return x.cpu().numpy()


def test_jacobi_path_on_card_bit_identical_to_cpu(cuda):
    rt = HDArrayRuntime(4)                 # the default: torch on the card
    A, B, prog, _init = _ping_pong(rt, 96, 6)
    jacobi_kernel.jacobi_cuda.launches = 0
    plans = rt.run_pipeline(prog)
    got = rt.read_coherent(A), rt.read_coherent(B)
    ex = rt.executor
    assert ex.device_class == "cuda"
    assert jacobi_kernel.jacobi_cuda.launches == _sweep_launches(rt, prog,
                                                                 plans)
    assert ex.h2d_transfers == 2           # the two writes
    assert ex.d2h_transfers == 2           # the two reads
    cpu = HDArrayRuntime(4, device="cpu")
    A, B, prog, _init = _ping_pong(cpu, 96, 6)
    cpu.run_pipeline(prog)
    want = cpu.read_coherent(A), cpu.read_coherent(B)
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


@pytest.mark.parametrize("sweeps", [20, 41])
def test_captured_jacobi_pipeline_bit_identical_to_plain_sweeps(cuda, sweeps):
    rt = HDArrayRuntime(4)
    ex = rt.executor
    A, B, prog, init = _ping_pong(rt, 160, sweeps)
    jacobi_kernel.jacobi_cuda.launches = 0
    plans = rt.run_pipeline(prog)
    st = rt.planner.stats
    # steps 6-9 are the two-period witness; the window from step 10
    # is captured, an odd last step runs fused
    assert st.scan_captures == 1 and st.fused_steps == 10 + sweeps % 2
    assert jacobi_kernel.jacobi_cuda.launches == _sweep_launches(rt, prog,
                                                                 plans)
    assert ex.device_kernel_launches == sweeps
    assert any(k[0] == "scan" for k in ex._graphs)
    assert any(k[0] == "step" for k in ex._graphs)
    assert (ex.h2d_transfers, ex.d2h_transfers) == (2, 0)
    last = A if sweeps % 2 == 0 else B
    assert np.array_equal(rt.read_coherent(last),
                          _plain_sweeps(init, sweeps, cuda))
    rt.close()
    assert ex._graphs == {}


def test_fused_apply_kernel_loop_replays_step_graphs(cuda):
    rt = HDArrayRuntime(4)
    ex = rt.executor
    A, _B, prog, init = _ping_pong(rt, 160, 12)
    jacobi_kernel.jacobi_cuda.launches = 0
    plans = [rt.apply_kernel(st["kernel_name"], st["part_id"], st["kernel"],
                             st["arrays"], st["uses"], st["defs"])
             for st in prog]
    assert rt.planner.stats.fused_steps == 12
    assert jacobi_kernel.jacobi_cuda.launches == _sweep_launches(rt, prog,
                                                                 plans)
    assert sorted(k[0] for k in ex._graphs) == ["step", "step"]
    assert np.array_equal(rt.read_coherent(A), _plain_sweeps(init, 12, cuda))


@pytest.mark.parametrize("pipeline", [False, True])
def test_overlapped_jacobi_bit_identical_to_plain_sweeps(cuda, pipeline):
    sweeps = 40
    rt = HDArrayRuntime(4, overlap=True)
    ex = rt.executor
    A, _B, prog, init = _ping_pong(rt, 256, sweeps)
    jacobi_kernel.jacobi_cuda.launches = 0
    if pipeline:
        plans = rt.run_pipeline(prog)
    else:
        plans = [rt.apply_kernel(st["kernel_name"], st["part_id"],
                                 st["kernel"], st["arrays"], st["uses"],
                                 st["defs"])
                 for st in prog]
    sched = rt._scheduler
    assert sched.steps_overlapped == sweeps
    # the pipeline never splits; apply_kernel splits every step here,
    # sweeping its interior and its boundary strips
    assert sched.halo_splits == (0 if pipeline else sweeps)
    assert jacobi_kernel.jacobi_cuda.launches == _sweep_launches(
        rt, prog, plans, split=not pipeline)
    if pipeline:
        assert jacobi_kernel.jacobi_cuda.launches == sweeps * 4
    assert (ex.h2d_transfers, ex.d2h_transfers) == (2, 0)
    assert np.array_equal(rt.read_coherent(A),
                          _plain_sweeps(init, sweeps, cuda))
    rt.close()


def test_overlap_with_host_kernels_on_card_matches_cpu(cuda):
    """Host kernels read the mirrors while the comm stream copies: the
    download waits for the copies, and the result is the CPU's."""
    def run(rt):
        n = 64
        init = np.random.default_rng(4).standard_normal((n, n)).astype(
            np.float32)
        A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
        pd = rt.partition_row((n, n))
        pw = rt.partition_row((n, n), region=Box.make((1, n - 1), (1, n - 1)))
        rt.write(A, init, pd)
        rt.write(B, init, pd)
        fp = stencil(2, 1)

        def jac(region, bufs):
            (r0, r1), (c0, c1) = region.bounds
            x = bufs["B"]
            bufs["A"][r0:r1, c0:c1] = (
                x[r0:r1, c0 - 1:c1 - 1] + x[r0:r1, c0 + 1:c1 + 1]
                + x[r0 - 1:r1 - 1, c0:c1] + x[r0 + 1:r1 + 1, c0:c1]) / 4

        def cp(region, bufs):
            sl = region.to_slices()
            bufs["B"][sl] = bufs["A"][sl]

        for _ in range(5):
            rt.apply_kernel("jac", pw, jac, [A, B], uses={"B": fp},
                            defs={"A": IDENTITY_2D})
            rt.apply_kernel("copy", pw, cp, [A, B], uses={"A": IDENTITY_2D},
                            defs={"B": IDENTITY_2D})
        return rt.read_coherent(B)

    got = run(HDArrayRuntime(4, overlap=True))
    want = run(HDArrayRuntime(4, device="cpu"))
    assert np.array_equal(got, want)


def test_freed_array_never_replays_a_stale_graph(cuda):
    rt = HDArrayRuntime(4)
    ex = rt.executor
    A, B, prog, init = _ping_pong(rt, 160, 20)
    rt.run_pipeline(prog)
    assert ex._graphs
    ex.free(A)
    assert not any("A" in g.names for g in ex._graphs.values())
    ex.free(B)
    assert ex._graphs == {}
    # the same names again, new data: new graphs, right values
    rt.arrays.clear()
    A, B, prog, init = _ping_pong(rt, 160, 20, seed=5)
    jacobi_kernel.jacobi_cuda.launches = 0
    plans = rt.run_pipeline(prog)
    assert jacobi_kernel.jacobi_cuda.launches == _sweep_launches(rt, prog,
                                                                 plans)
    assert np.array_equal(rt.read_coherent(A), _plain_sweeps(init, 20, cuda))
    # a host kernel between captured windows: the replay sees its write
    pw = prog[0]["part_id"]

    def halve(region, bufs):
        sl = region.to_slices()
        bufs["A"][sl] = bufs["A"][sl] * 0.5

    rt.apply_kernel("halve", pw, halve, [A], uses={"A": IDENTITY_2D},
                    defs={"A": IDENTITY_2D})
    start = rt.read_coherent(A)
    h2d = ex.h2d_transfers
    captures = rt.planner.stats.scan_captures
    rt.run_pipeline(prog)
    assert ex.h2d_transfers == h2d + 1          # A's mirrors, once
    assert rt.planner.stats.scan_captures == captures + 1
    assert np.array_equal(rt.read_coherent(A), _plain_sweeps(start, 20, cuda))


def test_gemm_steps_fuse_on_card(cuda):
    n = 160
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    fn = gemm_kernel.gemm_cuda
    fn.launches = 0
    fn.by_variant = dict.fromkeys(fn.by_variant, 0)
    rt = HDArrayRuntime(4)
    part = rt.partition_row((n, n))
    hA, hB, hC = (rt.create(s, (n, n)) for s in "abc")
    rt.write(hA, a, part)
    rt.write(hB, b, part)
    rt.write(hC, np.zeros((n, n), np.float32), part)
    mm = make_gemm_kernel("a", "b", "c")
    for _ in range(4):
        rt.apply_kernel("gemm", part, mm, [hA, hB, hC],
                        uses={"a": ROW_ALL, "b": COL_ALL},
                        defs={"c": IDENTITY_2D})
    # step 1 gathers B, steps 2-4 move nothing: two signatures, each
    # eager at first sight, then one graph of the no-traffic step
    assert rt.planner.stats.fused_steps == 4
    assert fn.by_variant == {"tiled": 0, "pipelined": 4 * 4}
    assert [k[0] for k in rt.executor._graphs] == ["step"]
    c = rt.read(hC, part)
    o = a.astype(np.float64) @ b.astype(np.float64)
    assert np.linalg.norm(c - o) / np.linalg.norm(o) <= 5e-5


# -- flash attention ------------------------------------------------------
# bf16/fp16: a few ulps of the 16-bit type, from rounding p (normalized
# in the plain version, unnormalized per kv tile in the kernel) before
# the PV product.  float32: the reference's own bound for its Pallas
# kernel (tests/test_pallas_parity.py).
_FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}


def _flash_inputs(dev, dtype, B=2, T=100, S=130, Hq=4, Hkv=2, Dh=64,
                  Dv=None, qpos="causal", seed=0):
    """q, and k and v as strided views of one interleaved buffer."""
    Dv = Dv or Dh
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, Hq, Dh), generator=g, device=dev).to(dtype)
    kv = torch.randn((B, S, 2, Hkv, max(Dh, Dv)), generator=g,
                     device=dev).to(dtype)
    k, v = kv[:, :, 0, :, :Dh], kv[:, :, 1, :, :Dv]
    if qpos == "causal":                     # the prefill layout
        pos = torch.arange(S - T, S, device=dev).expand(B, T)
    else:                                    # ragged, -1 marks padding
        pos = torch.randint(-1, S + 8, (B, T), generator=g, device=dev)
        pos[:, :7] = -1
    return q, k, v, pos.to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("case", [
    dict(), dict(window=16), dict(softcap=8.0), dict(qpos="ragged"),
    dict(qpos="ragged", window=9, softcap=5.0), dict(Dh=256, Hkv=1),
    dict(Dh=192, Dv=128), dict(Dh=72, Dv=40, T=1, S=300),
    dict(B=1, T=257, S=513, Hq=8, Hkv=2, Dh=128),
    dict(Hq=16, Hkv=8, Dh=256, window=16, softcap=50.0)])
def test_flash_cuda_matches_plain(cuda, dtype, case):
    case = dict(case)
    window, softcap = case.pop("window", None), case.pop("softcap", 0.0)
    q, k, v, qpos = _flash_inputs(cuda, dtype, **case)
    got = flash_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    want = dense_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    assert got.dtype == dtype and got.shape == want.shape
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_cuda_fully_masked_rows_are_zero(cuda, dtype):
    q, k, v, _ = _flash_inputs(cuda, dtype, T=70, S=32)
    qpos = torch.arange(70, dtype=torch.int32, device=cuda).repeat(2, 1)
    qpos[0, 5:40] = -1                       # padding rows
    qpos[1, 3:9] = 100                       # window 4: keys 97..100 > S
    out = flash_attention(q, k, v, qpos=qpos, window=4)
    assert torch.equal(out[0, 5:40], torch.zeros_like(out[0, 5:40]))
    assert torch.equal(out[1, 3:9], torch.zeros_like(out[1, 3:9]))
    assert bool(out[0, :5].abs().sum() > 0)


def test_flash_cuda_counts_launches_and_rejects_bad_input(cuda):
    q, k, v, qpos = _flash_inputs(cuda, torch.bfloat16)
    flash_kernel.flash_attention_cuda.launches = 0
    flash_attention(q, k, v, qpos=qpos)
    flash_attention(q, k, v, qpos=qpos, impl="cuda")
    assert flash_kernel.flash_attention_cuda.launches == 2
    with pytest.raises(ValueError, match="unit-stride last dim"):
        wide = torch.zeros((2, 130, 2, 128), dtype=torch.bfloat16,
                           device=cuda)
        flash_attention(q, wide[..., ::2], v, qpos=qpos)
    with pytest.raises(ValueError, match="16-byte aligned"):
        big = torch.zeros((2, 130, 2, 72), dtype=torch.bfloat16, device=cuda)
        flash_attention(q, big[..., 4:68], v, qpos=qpos)
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), v, qpos=qpos)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double(), qpos=qpos)
    for dh in (20, 264):
        q2, k2, v2, p2 = _flash_inputs(cuda, torch.bfloat16, Dh=dh)
        with pytest.raises(ValueError, match="multiples of 8 up to 256"):
            flash_attention(q2, k2, v2, qpos=p2)
    with pytest.raises(ValueError, match="do not group"):
        flash_attention(q[:, :, :3], k, v, qpos=qpos)
    assert flash_kernel.flash_attention_cuda.launches == 2



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", [
    dict(T=128, S=128), dict(T=200, S=300), dict(T=257, S=513, window=40),
    dict(T=100, S=130, softcap=8.0), dict(T=96, S=80, qpos="ragged"),
    dict(T=150, S=330, qpos="ragged", window=9, softcap=5.0)])
def test_flash_wgmma_variant_matches_dense(cuda, dtype, D, case):
    """The wgmma + TMA kernel on the head dims it takes, with T and S off
    its 128-row and 64-key tiles, ragged qpos with padding rows, windows
    and softcaps, k and v as strided views of one interleaved cache;
    against the dense oracle."""
    case = dict(case)
    window, softcap = case.pop("window", None), case.pop("softcap", 0.0)
    q, k, v, qpos = _flash_inputs(cuda, dtype, B=2, Hq=8, Hkv=2, Dh=D,
                                  **case)
    assert k.stride(1) == 2 * 2 * D            # interleaved k and v rows
    n0 = flash_kernel.flash_attention_cuda.by_variant["wgmma"]
    got = flash_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    assert flash_kernel.flash_attention_cuda.by_variant["wgmma"] == n0 + 1
    want = dense_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_wgmma_extent_one_dims_and_strided_q(cuda):
    """One batch and one kv head (dims whose stride the wrapper passes
    as 0; the tensor maps take the packed stride) and q as a strided
    view of a wider buffer."""
    g = torch.Generator(device=cuda).manual_seed(11)
    wide = torch.randn((1, 130, 4, 256), generator=g, device=cuda)
    q = wide.bfloat16()[..., 64:192]               # strides (.., 1024, 256, 1)
    kv = torch.randn((1, 200, 2, 1, 128), generator=g,
                     device=cuda).bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    qpos = torch.arange(70, 200, dtype=torch.int32, device=cuda)[None]
    n0 = flash_kernel.flash_attention_cuda.by_variant["wgmma"]
    got = flash_attention(q, k, v, qpos=qpos, window=50)
    assert flash_kernel.flash_attention_cuda.by_variant["wgmma"] == n0 + 1
    want = dense_attention(q, k, v, qpos=qpos, window=50)
    tol = _FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_fully_masked_rows_are_zero(cuda, dtype):
    q, k, v, _ = _flash_inputs(cuda, dtype, T=300, S=200, Dh=128)
    qpos = torch.arange(300, dtype=torch.int32, device=cuda).repeat(2, 1)
    qpos[0, 5:140] = -1                      # padding, across two blocks
    qpos[1, 130:140] = 400                   # window 4: keys 397..400 > S
    out = flash_kernel.flash_attention_cuda(q, k, v, qpos=qpos, window=4)
    assert torch.equal(out[0, 5:140], torch.zeros_like(out[0, 5:140]))
    assert torch.equal(out[1, 130:140], torch.zeros_like(out[1, 130:140]))
    assert bool(out[0, :5].abs().sum() > 0)
    assert bool(out[1, 140:].abs().sum() > 0)


def test_flash_cuda_counts_launches_by_variant(cuda):
    fn = flash_kernel.flash_attention_cuda
    fn.launches = 0
    fn.by_variant = dict.fromkeys(fn.by_variant, 0)
    for dtype, D, Dv in ((torch.bfloat16, 128, 128), (torch.float16, 64, 64),
                         (torch.bfloat16, 256, 256), (torch.float32, 128, 128),
                         (torch.bfloat16, 192, 128)):
        q, k, v, qpos = _flash_inputs(cuda, dtype, Dh=D, Dv=Dv)
        flash_attention(q, k, v, qpos=qpos)
    assert fn.by_variant == {"ffma": 1, "mma_sync": 2, "wgmma": 2}
    assert fn.launches == 5


_RAGGED = (1, 127, 129, 1000)


@pytest.mark.parametrize("M, K, N", [
    (1, 1, 1), (127, 129, 1000), (129, 1000, 127), (1000, 127, 129),
    (1000, 1000, 1), (1, 1000, 129), (129, 127, 1000), (1000, 129, 127)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
def test_gemm_cuda_ragged_pitched_bands(cuda, M, K, N, dtypes):
    """Ragged M, N and K, A a band of a wider buffer (pitch and offset
    off 16 bytes), C written through a wider pitch with alpha; float32
    takes the pipelined kernel, the bf16 builds the tiled one."""
    assert {M, K, N} <= set(_RAGGED)
    din, dout = dtypes
    g = torch.Generator(device=cuda).manual_seed(M + 7 * K + 13 * N)
    a = torch.randn((M + 2, K + 3), generator=g, device=cuda).to(din)[
        1:1 + M, 2:2 + K]
    b = torch.randn((K, N), generator=g, device=cuda).to(din)
    dst = torch.full((M + 4, N + 5), 3.0, dtype=dout, device=cuda)
    band = dst[2:2 + M, 1:1 + N]
    variant = gemm_kernel.gemm_variant(din, dout)
    n0 = gemm_kernel.gemm_cuda.by_variant[variant]
    assert gemm(a, b, alpha=0.75, out=band) is band
    assert gemm_kernel.gemm_cuda.by_variant[variant] == n0 + 1
    o = 0.75 * (a.double() @ b.double())
    tol = 5e-5 if dout == torch.float32 else 4e-3
    assert float(torch.linalg.norm(band.double() - o)
                 / torch.linalg.norm(o)) <= tol
    dst[2:2 + M, 1:1 + N] = 3.0
    assert torch.equal(dst, torch.full_like(dst, 3.0))


def test_gemm_cuda_counts_launches_by_variant(cuda):
    """float32 products launch the pipelined kernel on aligned tiles,
    ragged edges and odd pitches alike; any bfloat16 operand or output
    launches the tiled one."""
    fn = gemm_kernel.gemm_cuda
    fn.by_variant = dict.fromkeys(fn.by_variant, 0)
    g = torch.Generator(device=cuda).manual_seed(9)
    for M, K, N in ((256, 512, 384), (300, 1100, 257), (129, 1000, 127)):
        a = torch.randn((M, K), generator=g, device=cuda)
        b = torch.randn((K, N), generator=g, device=cuda)
        o = 1.25 * (a.double() @ b.double())
        got = fn(a, b, alpha=1.25).double()
        assert float(torch.linalg.norm(got - o) / torch.linalg.norm(o)) <= 5e-5
    fn(a.bfloat16(), b.bfloat16())
    fn(a, b, out_dtype=torch.bfloat16)
    assert fn.by_variant == {"tiled": 2, "pipelined": 3}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _serve(eng, prompts, steps):
    sids = [eng.add_request(p) for p in prompts]
    for _ in range(steps):
        eng.step()
    return [eng.finish(s) for s in sids]


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b", "qwen3-moe-30b-a3b"])
def test_reduced_engine_on_card_matches_cpu(cuda, arch):
    """The same seeded reduced model, its weights drawn on the CPU and
    carried to the card: a 1024-token prompt takes the flash kernel
    (one launch per layer, none in decode), a 30-token one the dense
    path, and the greedy tokens agree with the CPU run (float32
    compute, TF32 off; the reduced MoE is dropless)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 1024), rng.integers(0, 256, 30)]
    cfg = get_config(arch).reduced()
    bundle = build(cfg, torch.float32, "cpu")
    params = bundle.init(3)
    host = Engine(bundle, params, ServeConfig(max_seq=1100, slots=2))
    card = Engine(build(cfg, torch.float32, "cuda"), _tree_to(params, cuda),
                  ServeConfig(max_seq=1100, slots=2))
    want = _serve(host, prompts, 8)
    flash_kernel.flash_attention_cuda.launches = 0
    got = _serve(card, prompts, 8)
    assert flash_kernel.flash_attention_cuda.launches == host.cfg.n_layers
    assert got == want


def test_failed_capture_raises(cuda):
    """A step that cannot be captured (it synchronises with the host)
    runs eagerly at the first sight of its signature and raises at its
    capture: nothing falls back to eager execution, and the launches
    the failed capture recorded never count."""
    from repro_torch.executors import device_kernel

    ab = make_jacobi_kernel("A", "B")

    @device_kernel
    def syncing(region, bufs):
        out = ab(region, bufs)
        float(bufs["B"].sum())            # a d2h sync: not capturable
        return out

    rt = HDArrayRuntime(4)
    A, _B, prog, _init = _ping_pong(rt, 96, 1)
    st = dict(prog[0], kernel=syncing)
    jacobi_kernel.jacobi_cuda.launches = 0
    plans = []
    with pytest.raises(RuntimeError):
        for _ in range(4):                # a new signature runs eagerly
            plans.append(rt.apply_kernel(
                "s", st["part_id"], syncing, st["arrays"], st["uses"],
                st["defs"]))
    assert 1 <= len(plans) <= 3
    assert rt.planner.stats.fused_steps == len(plans)
    assert jacobi_kernel.jacobi_cuda.launches == _sweep_launches(
        rt, [st] * len(plans), plans)
    assert rt.executor._graphs == {}
    torch.cuda.synchronize()


# -- the resilience layer on the card -------------------------------------
def _weighted_ping_pong(rt, n, sweeps, weights):
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    init = np.random.default_rng(5).standard_normal((n, n)).astype(
        np.float32)
    pd = rt.partition_row((n, n), weights=weights)
    pw = rt.partition_row((n, n), region=Box.make((1, n - 1), (1, n - 1)),
                          weights=weights)
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    ab, ba = make_jacobi_kernel("A", "B"), make_jacobi_kernel("B", "A")
    fp = stencil(2, 1)
    prog = [dict(kernel_name="jab", part_id=pw, kernel=ab, arrays=[A, B],
                 uses={"A": fp}, defs={"B": IDENTITY_2D}) if i % 2 == 0 else
            dict(kernel_name="jba", part_id=pw, kernel=ba, arrays=[A, B],
                 uses={"B": fp}, defs={"A": IDENTITY_2D})
            for i in range(sweeps)]
    return A, pd, prog, init


def test_rank_times_from_cuda_events(cuda):
    """With ``time_ranks`` a step runs unfused and reports each rank's
    kernel time from CUDA events; the rank with twice the rows takes
    longer.  Without it steps stay fused and report none."""
    rt = HDArrayRuntime(4)
    A, _pd, prog, init = _weighted_ping_pong(rt, 2050, 6, (2, 1, 1, 1))
    ex = rt.executor
    ex.time_ranks = True
    for st in prog[:4]:
        rt.apply_kernel(st["kernel_name"], st["part_id"], st["kernel"],
                        st["arrays"], st["uses"], st["defs"])
        times = ex.last_rank_times
        assert len(times) == 4 and all(t > 0 for t in times)
    assert times[0] > max(times[1:])
    assert rt.planner.stats.fused_steps == 0
    ex.time_ranks = False
    for st in prog[4:]:
        rt.apply_kernel(st["kernel_name"], st["part_id"], st["kernel"],
                        st["arrays"], st["uses"], st["defs"])
        assert ex.last_rank_times is None
    assert rt.planner.stats.fused_steps == 2
    assert np.array_equal(rt.read_coherent(A), _plain_sweeps(init, 6, cuda))


def _recovery_policy(tmp_path, pd, specs, **kw):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ft import FaultInjector, RecoveryPolicy

    return RecoveryPolicy(checkpoint=CheckpointManager(str(tmp_path)),
                          interval=4, injector=FaultInjector(specs),
                          data_parts={"A": pd, "B": pd}, **kw)


@pytest.mark.parametrize("overlap", [False, True])
def test_recovery_on_card_bit_identical_to_plain_sweeps(cuda, tmp_path,
                                                        overlap):
    """A transient fault, rank 2 lost at a commit (under overlap while
    the comm stream's copies are in flight) and its rejoin: the values
    equal plain sweeps, and a mesh change drops the graphs of the old
    partitions."""
    from repro_torch.ft import FaultSpec

    rt = HDArrayRuntime(4, overlap=overlap)
    A, pd, prog, init = _weighted_ping_pong(rt, 130, 20, None)
    specs = [FaultSpec(3, site="commit"),
             FaultSpec(9, site="commit", kind="rank", rank=2),
             FaultSpec(14, kind="join", rank=2)]
    pol = _recovery_policy(tmp_path, pd, specs)
    jacobi_kernel.jacobi_cuda.launches = 0
    rt.run_pipeline(prog, recovery=pol)
    st = rt.planner.stats
    assert [r["kind"] for r in rt.recovery_log] == ["rank_loss", "rank_join"]
    assert st.recoveries == 2 and st.elastic_shrinks == st.elastic_grows == 1
    assert jacobi_kernel.jacobi_cuda.launches > 0
    if not overlap:
        assert st.fused_steps > 0
        # the graphs of the 3-rank mesh went at the grow: every graph
        # left sweeps rank 2's rows
        graphs = rt.executor._graphs
        assert graphs
        empty = Box.make((0, 0), (0, 0)).bounds
        assert all(step_key[2][2] != empty
                   for key in graphs for step_key in key[1])
    assert np.array_equal(rt.read_coherent(A), _plain_sweeps(init, 20, cuda))


def test_rebalance_on_card_evens_measured_times(cuda):
    from repro_torch.ft import Rebalancer

    rt = HDArrayRuntime(4)
    # rank 0's sweep about 0.3 ms: well above the launch latency
    A, pd, prog, init = _weighted_ping_pong(rt, 16386, 24, (2, 1, 1, 1))
    reb = Rebalancer(data_parts={"A": pd, "B": pd}, min_duration=1e-5)
    rt.run_pipeline(prog, rebalance=reb)
    recs = [r for r in rt.recovery_log if r["kind"] == "rebalance"]
    # the ranks sweep rows at one speed: the measured weights undo the
    # declared (2, 1, 1, 1), to within 10% of even
    assert recs and max(abs(w - 0.25) for w in recs[-1]["weights"]) <= 0.025
    assert np.array_equal(rt.read_coherent(A), _plain_sweeps(init, 24, cuda))


def test_recovery_engine_failover_on_card(cuda, tmp_path):
    """bf16 KV leaves live on the card as int16 bits; a failover and a
    rejoin keep the greedy stream of an uninterrupted run."""
    from repro_torch.serve import RecoveryEngine

    cfg = get_config("yi-9b").reduced()
    bundle = build(cfg, torch.bfloat16, "cuda")
    params = bundle.init(0)
    scfg = ServeConfig(max_seq=48, slots=2)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, 12)
    want = Engine(bundle, params, scfg).generate(prompt, 10)
    eng = RecoveryEngine(bundle, params, scfg, instances=2,
                         checkpoint_interval=3, ckpt_dir=str(tmp_path))
    ex = eng.rt.executor
    assert ex.device.type == "cuda"
    assert all(t.dtype in (torch.int16, torch.int32)
               for t in ex._device.values())
    sid = eng.add_request(prompt)
    for _ in range(5):
        eng.step()
    h2d = ex.h2d_transfers
    eng.step()                             # the mirror is a device copy
    assert ex.h2d_transfers == h2d
    eng.step()
    eng.fail_instance(1)                   # replays the 7th step
    eng.step()
    eng.rejoin_instance(1)
    eng.step()
    assert eng.finish(sid) == want
    assert [r["kind"] for r in eng.recovery_log] == ["instance_loss",
                                                     "instance_join"]
    assert eng.recovery_log[0]["steps_replayed"] == 1


# -- the flash backward kernel (csrc/flash_attn_bwd_hd.cu) ----------------
# Against float64 dense autograd on the same (rounded) inputs.  float32:
# the reference's own bound for its custom VJP, rtol = atol = 2e-4
# (tests/test_flash_attention.py).  16-bit: p and dz are rounded to the
# operand type before their products and dq, dk, dv to it at the end
# (2**-9 relative each in bf16); their Frobenius-relative error stays
# well under 2e-2 at these sizes
BWD_FRO_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2}
BWD_F32_TOL = 2e-4

BWD_SHAPES = [  # B, T, S, Hq, Hkv, D, window, softcap, qpos
    (2, 100, 130, 8, 1, 64, None, 0.0, "tail"),
    (2, 100, 130, 8, 1, 64, 16, 0.0, "tail"),
    (1, 257, 300, 8, 8, 128, None, 8.0, "tail"),
    (2, 200, 200, 16, 2, 128, 40, 5.0, "tail"),
    (2, 96, 80, 4, 2, 128, 5, 0.0, "ragged"),
    (1, 130, 130, 8, 1, 64, None, 0.0, "ragged"),
]


def _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, D, kind, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                             (B, T, Hq, D)))
    if kind == "tail":
        qpos = torch.arange(S - T, S, dtype=torch.int32,
                            device=cuda).repeat(B, 1)
    else:                       # ragged, with padding and unseeing rows
        qpos = torch.randint(-1, S + 10, (B, T), generator=g, device=cuda,
                             dtype=torch.int32)
        qpos[:, :9] = -1
        qpos[-1, 20:30] = S + 200
    return q, k, v, do, qpos


def _dense64(q, k, v, qpos, window=None, softcap=0.0):
    """Dense attention in float64 whose masked logits are -1e300, not
    -inf: a fully masked row's softmax is then finite (and zeroed), so
    its backward carries no NaN into dk and dv."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kk, vv = (x.repeat_interleave(Hq // Hkv, 2) for x in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q, kk) / D ** 0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=q.device)
    qp = qpos.long()[:, None, :, None]
    seen = (kpos <= qp) & (qp >= 0)
    if window is not None:
        seen &= kpos > qp - window
    p = torch.softmax(torch.where(seen, s, -1e300), dim=-1)
    p = torch.where(seen.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhts,bshd->bthd", p, vv)


def _dense_grads(q, k, v, do, qpos, **kw):
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    out = _dense64(*leaves, qpos=qpos, **kw)
    out.backward(do.double())
    return out.detach(), [x.grad for x in leaves]


def _bwd(do, q, k, v, qpos, **kw):
    """dq, dk, dv through autograd (FlashAttentionFunction)."""
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_kernel.flash_attention_cuda(*leaves, qpos=qpos, **kw).backward(do)
    return [x.grad for x in leaves]


def _check_grads(got, want, dtype):
    for x, w in zip(got, want):
        assert x.dtype == dtype and torch.isfinite(x).all()
        if dtype == torch.float32:
            torch.testing.assert_close(x.double(), w, rtol=BWD_F32_TOL,
                                       atol=BWD_F32_TOL)
        else:
            err = torch.linalg.norm(x.double() - w) / torch.linalg.norm(w)
            assert float(err) <= BWD_FRO_TOL[dtype], float(err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_cuda_matches_f64_dense_autograd(cuda, dtype, shape):
    B, T, S, Hq, Hkv, D, window, softcap, kind = shape
    q, k, v, do, qpos = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, D, kind)
    kw = dict(window=window, softcap=softcap)
    _, want = _dense_grads(q, k, v, do, qpos, **kw)
    fn = flash_kernel.flash_attention_bwd_cuda
    variant = "ffma" if dtype == torch.float32 else "wgmma"
    before, by = fn.launches, fn.by_variant[variant]
    got = _bwd(do, q, k, v, qpos, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.by_variant[variant]) == (before + 1, by + 1)
    _check_grads(got, want, dtype)


# shapes at the wgmma kernels' TMA and tiling edges: T and S off 64 and
# 128, T != S, GQA groups of 1 and 8, a window shorter than a tile, Dh
# 64 and 128; k and v strided views of one interleaved cache
BWD_EDGES = [  # B, T, S, Hq, Hkv, D, window, softcap, qpos
    (1, 1, 3, 2, 1, 64, None, 0.0, "tail"),
    (2, 63, 65, 4, 4, 128, None, 0.0, "tail"),
    (1, 129, 127, 8, 1, 64, None, 0.0, "ragged"),
    (2, 190, 333, 8, 8, 128, 7, 0.0, "tail"),
    (1, 300, 300, 16, 2, 128, 50, 0.0, "ragged"),
    (2, 64, 200, 8, 1, 128, None, 3.0, "tail"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", BWD_EDGES)
def test_flash_bwd_wgmma_edges_match_f64(cuda, dtype, shape):
    B, T, S, Hq, Hkv, D, window, softcap, kind = shape
    q, k, v, do, qpos = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, D, kind,
                                    seed=T + S)
    cache = torch.stack([k, v], 2)                 # (B, S, 2, Hkv, D)
    k, v = cache[:, :, 0], cache[:, :, 1]          # strided views
    kw = dict(window=window, softcap=softcap)
    _, want = _dense_grads(q, k, v, do, qpos, **kw)
    got = _bwd(do, q, k, v, qpos, **kw)
    torch.cuda.synchronize()
    _check_grads(got, want, dtype)


def test_flash_bwd_wgmma_extent_one_dims_and_strided_q(cuda):
    """One batch and one kv head (dims whose stride the wrapper passes
    as 0; the tensor maps take the packed stride), q and dO as strided
    views of wider buffers."""
    g = torch.Generator(device=cuda).manual_seed(12)
    wide = torch.randn((1, 130, 4, 256), generator=g, device=cuda)
    q = wide.bfloat16()[..., 64:192]               # strides (.., 1024, 256, 1)
    do = torch.randn((1, 130, 4, 256), generator=g,
                     device=cuda).bfloat16()[..., 128:]
    kv = torch.randn((1, 200, 2, 1, 128), generator=g,
                     device=cuda).bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    qpos = torch.arange(70, 200, dtype=torch.int32, device=cuda)[None]
    _, want = _dense_grads(q, k, v, do, qpos, window=50)
    got = _bwd(do, q, k, v, qpos, window=50)
    torch.cuda.synchronize()
    _check_grads(got, want, torch.bfloat16)


def test_flash_bwd_wgmma_is_deterministic(cuda):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, do, qpos = _bwd_inputs(cuda, torch.bfloat16, 2, 300, 300, 16,
                                    2, 128, "tail", seed=5)
    out, lse = flash_kernel._forward(q, k, v, qpos, None, 0.0, None,
                                     with_lse=True)
    runs = [flash_kernel.flash_attention_bwd_cuda(
        do, q, k, v, out, lse, qpos=qpos) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_bwd_wgmma_mid_shape_matches_f64(cuda):
    """A mid shape of the training layout (32 query heads over 4 kv
    heads of 128, 1024 tokens, causal), where the dK, dV grid has more
    blocks than the card has SMs, within the 2e-2 bound."""
    q, k, v, do, qpos = _bwd_inputs(cuda, torch.bfloat16, 1, 1024, 1024, 32,
                                    4, 128, "tail", seed=6)
    _, want = _dense_grads(q, k, v, do, qpos)
    got = _bwd(do, q, k, v, qpos)
    torch.cuda.synchronize()
    _check_grads(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_lse_matches_plain(cuda, dtype):
    """The forward's log-sum-exp against float64: masked rows -1e30."""
    B, T, S, Hq, Hkv, D = 2, 96, 80, 8, 2, 128
    q, k, v, _, qpos = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, D,
                                   "ragged")
    out, lse = flash_kernel._forward(q, k, v, qpos, 7, 0.0, None,
                                     with_lse=True)
    z = torch.einsum("bthd,bshd->bhts", q.double(),
                     k.double().repeat_interleave(Hq // Hkv, 2)) / D ** 0.5
    kpos = torch.arange(S, device=cuda)
    qp = qpos.long()[:, None, :, None]
    seen = (kpos <= qp) & (kpos > qp - 7) & (qp >= 0)
    want = torch.logsumexp(torch.where(seen, z, -torch.inf), dim=-1)
    masked = ~seen.any(-1).expand_as(want)
    assert bool((lse[masked] == -1e30).all())
    torch.testing.assert_close(lse[~masked].double(), want[~masked],
                               rtol=0, atol=2e-5 if dtype == torch.float32
                               else 1e-3)


def test_flash_with_grad_has_grad_fn_and_model_grads_finite(cuda):
    """A forward with grad gives a grad_fn on the card; every parameter
    of a small model at T >= FLASH_MIN_T (so each layer runs the kernel
    pair) gets a finite, non-zero gradient."""
    import dataclasses

    from repro_torch.models.layers import FLASH_MIN_T
    from repro_torch.train.step import TrainConfig, make_loss_fn

    q = torch.randn((1, 64, 4, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    qpos = torch.arange(64, device=cuda, dtype=torch.int32)[None]
    out = flash_kernel.flash_attention_cuda(q, kv, kv, qpos=qpos)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert flash_kernel.flash_attention_cuda(
            q, kv, kv, qpos=qpos).grad_fn is None

    cfg = dataclasses.replace(get_config("yi-9b").reduced(), n_layers=2,
                              d_head=64)
    bundle = build(cfg, torch.bfloat16, "cuda")
    params = bundle.init(0, dtype=torch.float32)
    T = FLASH_MIN_T
    toks = torch.randint(0, cfg.vocab, (1, T + 1), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = [p for layer in params["main"] for d in layer.values()
              for p in d.values()] + list(params["emb"].values())
    for p in leaves:
        p.requires_grad_(True)
    fwd = flash_kernel.flash_attention_cuda.launches
    bwd = flash_kernel.flash_attention_bwd_cuda.launches
    loss, _ = make_loss_fn(bundle, TrainConfig())(params, batch)
    loss.backward()
    torch.cuda.synchronize()
    # forward and its recompute under the per-layer checkpoint
    assert flash_kernel.flash_attention_cuda.launches - fwd == 2 * 2
    assert flash_kernel.flash_attention_bwd_cuda.launches - bwd == 2
    for p in leaves:
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert float(p.grad.abs().max()) > 0
