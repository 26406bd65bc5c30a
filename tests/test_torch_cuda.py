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
from repro_torch.core import (ALL_2D, Box, COL_ALL, HDArrayRuntime,
                              IDENTITY_2D, ROW_ALL, stencil)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import dense_attention
from repro_torch.kernels.gemm_hd import kernel as gemm_kernel
from repro_torch.kernels.gemm_hd.ops import gemm
from repro_torch.kernels.hd import (make_flash_kernel, make_gemm_kernel,
                                    make_jacobi_kernel)
from repro_torch.kernels.rglru_scan import kernel as rglru_kernel
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd_ref,
                                            rglru_scan_ref)
from repro_torch.kernels.slstm_scan import kernel as slstm_kernel
from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_ref
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

# gemma2's heads at Dh 256: 16 query heads over 8 kv heads
_DH256 = dict(Hq=16, Hkv=8, Dh=256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [
    dict(T=200, S=300), dict(T=128, S=64), dict(T=257, S=513, window=40),
    dict(T=200, S=330, window=40, softcap=50.0, q_scale=30.0),
    dict(T=150, S=330, qpos="ragged", window=9, softcap=5.0),
    dict(T=96, S=80, qpos="ragged")])
def test_flash_wgmma_dh256_matches_dense(cuda, dtype, case):
    """The wgmma kernel at Dh 256 (gemma2's and recurrentgemma's head
    dim), with T and S off its 128-row and 64-key tiles, a window that
    binds, the softcap on logits of about 30 (q x 30, so the cap bends
    them), ragged qpos with padding rows, k and v strided views of one
    interleaved cache; against the dense oracle."""
    case = dict(case)
    window, softcap = case.pop("window", None), case.pop("softcap", 0.0)
    q_scale = case.pop("q_scale", 1.0)
    q, k, v, qpos = _flash_inputs(cuda, dtype, B=2, **_DH256, **case)
    q = q * q_scale
    assert k.stride(1) == 2 * 8 * 256             # interleaved k and v rows
    n0 = flash_kernel.flash_attention_cuda.by_variant["wgmma"]
    got = flash_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    assert flash_kernel.flash_attention_cuda.by_variant["wgmma"] == n0 + 1
    want = dense_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_dh256_extent_one_dims_and_strided_q(cuda, dtype):
    """Dh 256 with one batch and one kv head (strides passed as 0) and q
    a strided view of a wider buffer, with gemma2's softcap."""
    g = torch.Generator(device=cuda).manual_seed(13)
    wide = torch.randn((1, 130, 4, 512), generator=g, device=cuda)
    q = wide.to(dtype)[..., 128:384]               # strides (.., 2048, 512, 1)
    kv = torch.randn((1, 200, 2, 1, 256), generator=g, device=cuda).to(dtype)
    k, v = kv[:, :, 0], kv[:, :, 1]
    qpos = torch.arange(70, 200, dtype=torch.int32, device=cuda)[None]
    n0 = flash_kernel.flash_attention_cuda.by_variant["wgmma"]
    got = flash_attention(q, k, v, qpos=qpos, window=50, softcap=50.0)
    assert flash_kernel.flash_attention_cuda.by_variant["wgmma"] == n0 + 1
    want = dense_attention(q, k, v, qpos=qpos, window=50, softcap=50.0)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_dh256_fully_masked_rows_are_zero(cuda, dtype):
    q, k, v, _ = _flash_inputs(cuda, dtype, T=300, S=200, **_DH256)
    qpos = torch.arange(300, dtype=torch.int32, device=cuda).repeat(2, 1)
    qpos[0, 5:140] = -1                      # padding, across two blocks
    qpos[1, 130:140] = 400                   # window 4: keys 397..400 > S
    n0 = flash_kernel.flash_attention_cuda.by_variant["wgmma"]
    out = flash_kernel.flash_attention_cuda(q, k, v, qpos=qpos, window=4,
                                            softcap=50.0)
    assert flash_kernel.flash_attention_cuda.by_variant["wgmma"] == n0 + 1
    assert torch.equal(out[0, 5:140], torch.zeros_like(out[0, 5:140]))
    assert torch.equal(out[1, 130:140], torch.zeros_like(out[1, 130:140]))
    assert bool(out[0, :5].abs().sum() > 0)
    assert bool(out[1, 140:].abs().sum() > 0)
    want = dense_attention(q, k, v, qpos=qpos, window=4, softcap=50.0)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


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
                         (torch.bfloat16, 192, 128), (torch.float16, 96, 96)):
        q, k, v, qpos = _flash_inputs(cuda, dtype, Dh=D, Dv=Dv)
        flash_attention(q, k, v, qpos=qpos)
    assert fn.by_variant == {"ffma": 1, "mma_sync": 1, "wgmma": 4}
    assert fn.launches == 6


# MLA's naive form at full width: Dh 192 (128 + the 64 RoPE columns),
# Dv 128, here over GQA groups too
_MLA = dict(Hq=8, Hkv=2, Dh=192, Dv=128)


def _mla_split(q, k, dev, seed=17):
    """q's and k's last 64 columns as the RoPE operands: q 128 wide and
    q_rope, strided views of q; one RoPE key a position, k_rope (B, S, 1,
    64), a strided view of a cache-like (B, S, 576) buffer; and the
    concatenated k that the split launch must equal."""
    B, S = k.shape[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = torch.randn((B, S, 576), generator=g, device=dev).to(k.dtype)
    k_rope = cache[..., None, 512:]
    k_cat = torch.cat([k[..., :128], k_rope.expand(*k.shape[:3], 64)], -1)
    return q[..., :128], q[..., 128:], k[..., :128], k_rope, k_cat


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [
    dict(T=128, S=128), dict(T=200, S=330), dict(T=257, S=513, window=40),
    dict(T=96, S=80, qpos="ragged"),
    dict(T=150, S=330, qpos="ragged", window=9, softcap=5.0),
    dict(T=130, S=200, strided_q=True)])
def test_flash_wgmma_mla_matches_f64(cuda, dtype, case):
    """The wgmma kernel at Dh 192 / Dv 128 with T and S off its 128-row
    and 64-key tiles, ragged qpos with padding rows, windows, a softcap,
    k and v strided views of one interleaved cache and, in one case, q
    a strided view of a wider buffer; against float64 dense attention.
    The same call with the RoPE columns as operands of their own gives
    the same bits."""
    case = dict(case)
    window, softcap = case.pop("window", None), case.pop("softcap", 0.0)
    strided = case.pop("strided_q", False)
    q, k, v, qpos = _flash_inputs(cuda, dtype, B=2, **_MLA, **case)
    if strided:
        wide = torch.randn((2, q.shape[1], 8, 320), device=cuda).to(dtype)
        q = wide[..., 64:256]                     # strides (.., 2560, 320, 1)
    fn = flash_kernel.flash_attention_cuda
    n0 = fn.by_variant["wgmma"]
    got = flash_attention(q, k, v, qpos=qpos, window=window, softcap=softcap)
    assert fn.by_variant["wgmma"] == n0 + 1
    want = _dense64(q.double(), k.double(), v.double(), qpos, window,
                    softcap)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(got.double(), want, rtol=tol, atol=tol)
    qn, qr, kn, kr, k_cat = _mla_split(q, k, cuda)
    split = flash_attention(qn, kn, v, qpos=qpos, window=window,
                            softcap=softcap, q_rope=qr, k_rope=kr)
    assert fn.by_variant["wgmma"] == n0 + 2
    assert torch.equal(split, flash_attention(
        q, k_cat, v, qpos=qpos, window=window, softcap=softcap))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_wgmma_mla_fully_masked_rows_are_zero(cuda, dtype):
    """Padding rows across two blocks and rows whose window holds no key
    write exactly 0 at Dh 192 / Dv 128, split or concatenated."""
    q, k, v, _ = _flash_inputs(cuda, dtype, T=300, S=200, **_MLA)
    qpos = torch.arange(300, dtype=torch.int32, device=cuda).repeat(2, 1)
    qpos[0, 5:140] = -1                      # padding, across two blocks
    qpos[1, 130:140] = 400                   # window 4: keys 397..400 > S
    qn, qr, kn, kr, k_cat = _mla_split(q, k, cuda)
    for out in (flash_kernel.flash_attention_cuda(q, k, v, qpos=qpos,
                                                  window=4),
                flash_kernel.flash_attention_cuda(
                    qn, kn, v, qpos=qpos, window=4, q_rope=qr, k_rope=kr)):
        assert torch.equal(out[0, 5:140], torch.zeros_like(out[0, 5:140]))
        assert torch.equal(out[1, 130:140], torch.zeros_like(out[1, 130:140]))
        assert bool(out[0, :5].abs().sum() > 0)
        assert bool(out[1, 140:].abs().sum() > 0)


def test_flash_rope_operands_on_card_route_and_checks(cuda):
    """The RoPE operands reach the kernel as they are only at 128 + 64 /
    128 in 16-bit types; another split (96 + 32 / 64, mma_sync) and
    float32 (ffma) are concatenated first and give the concatenated
    launch's bits.  A misaligned k_rope raises instead of launching."""
    fn = flash_kernel.flash_attention_cuda
    for dtype, Dn, Dr, Dv, variant in (
            (torch.bfloat16, 96, 32, 64, "mma_sync"),
            (torch.float32, 128, 64, 128, "ffma")):
        q, k, v, qpos = _flash_inputs(cuda, dtype, Dh=Dn + Dr, Dv=Dv)
        k_rope = k[:, :, :1, Dn:]
        k_cat = torch.cat([k[..., :Dn], k_rope.expand(*k.shape[:3], Dr)],
                          -1)
        n0 = fn.by_variant[variant]
        got = fn(q[..., :Dn], k[..., :Dn], v, qpos=qpos, q_rope=q[..., Dn:],
                 k_rope=k_rope)
        assert fn.by_variant[variant] == n0 + 1
        assert torch.equal(got, fn(q, k_cat, v, qpos=qpos))
    q, k, v, qpos = _flash_inputs(cuda, torch.bfloat16, **_MLA)
    buf = torch.zeros((2, 130, 1, 72), dtype=torch.bfloat16, device=cuda)
    n0 = fn.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(q[..., :128], k[..., :128], v, qpos=qpos, q_rope=q[..., 128:],
           k_rope=buf[..., 4:68])
    assert fn.launches == n0


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


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-9b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
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
    # Dh 256: gemma2's heads with softcap 50 and a window, recurrentgemma's
    # MQA with a window, ragged rows with padding and unseeing rows
    (2, 100, 130, 16, 8, 256, 40, 50.0, "tail"),
    (1, 200, 200, 10, 1, 256, 64, 0.0, "tail"),
    (2, 96, 80, 4, 2, 256, 5, 0.0, "ragged"),
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
    (1, 33, 97, 4, 1, 256, None, 0.0, "tail"),
    (2, 161, 161, 4, 2, 256, 70, 50.0, "ragged"),
    # Dh 256's 64-key blocks and 64-row parts: T and S off 64 on both
    # sides, recurrentgemma's MQA (10 over 1), a window of 7 (under a
    # part), rows past S and before 0 (fully masked), gemma2's softcap
    (1, 63, 65, 10, 1, 256, None, 0.0, "tail"),
    (2, 65, 63, 4, 2, 256, 7, 0.0, "ragged"),
    (1, 127, 200, 16, 8, 256, None, 50.0, "tail"),
    (1, 200, 127, 10, 1, 256, 7, 0.0, "tail"),
    (2, 200, 200, 8, 1, 256, 7, 50.0, "ragged"),
]


# MLA's Dh 192 / Dv 128: deepseek-v3's MHA (G = 1), a GQA group with a
# window (the GQA sum over partials of two widths), ragged rows with
# padding, T and S off 64, one query
BWD_MLA_SHAPES = [  # B, T, S, Hq, Hkv, window, qpos
    (2, 100, 130, 4, 4, None, "tail"),
    (1, 200, 200, 8, 2, 40, "tail"),
    (2, 96, 80, 4, 4, None, "ragged"),
    (1, 63, 65, 2, 1, 7, "tail"),
    (1, 1, 3, 2, 2, None, "tail"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", BWD_MLA_SHAPES)
def test_flash_bwd_mla_dims_match_f64(cuda, dtype, shape):
    """q and k 192 wide, v and dO 128, scale 1/sqrt(192): the wgmma
    backward against float64 dense autograd, one launch each."""
    B, T, S, Hq, Hkv, window, kind = shape
    q, k, _, _, qpos = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, 192, kind,
                                   seed=T + S)
    _, _, v, do, _ = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, 128, kind,
                                 seed=T + S + 1)
    _, want = _dense_grads(q, k, v, do, qpos, window=window)
    fn = flash_kernel.flash_attention_bwd_cuda
    before, by = fn.launches, fn.by_variant["wgmma"]
    got = _bwd(do, q, k, v, qpos, window=window)
    torch.cuda.synchronize()
    assert (fn.launches, fn.by_variant["wgmma"]) == (before + 1, by + 1)
    assert [tuple(x.shape) for x in got] == [q.shape, k.shape, v.shape]
    _check_grads(got, want, dtype)


# the ffma pair at widths the forward takes and wgmma does not: the
# reduced launcher's Dh 16 and reduced MLA's 24 / 16, float32 at 192 /
# 128, bf16 at 96 and 32, fp16 at 40 / 72, a window with a softcap, a
# GQA group of 4; T and S off its 16-row and 64-key tiles, ragged rows
BWD_FFMA_SHAPES = [  # dtype, B, T, S, Hq, Hkv, Dh, Dv, window, softcap, qpos
    (torch.bfloat16, 2, 200, 200, 4, 1, 16, 16, None, 0.0, "tail"),
    (torch.bfloat16, 2, 130, 130, 4, 4, 24, 16, None, 0.0, "tail"),
    (torch.float32, 1, 256, 256, 4, 4, 192, 128, None, 0.0, "tail"),
    (torch.bfloat16, 1, 300, 300, 8, 2, 96, 96, None, 0.0, "ragged"),
    (torch.bfloat16, 2, 100, 130, 8, 8, 32, 32, None, 0.0, "tail"),
    (torch.float16, 2, 100, 130, 4, 2, 40, 72, None, 0.0, "tail"),
    (torch.bfloat16, 2, 161, 161, 4, 2, 16, 16, 16, 50.0, "ragged"),
    (torch.bfloat16, 1, 200, 330, 12, 3, 48, 48, 40, 5.0, "tail"),
]


@pytest.mark.parametrize("shape", BWD_FFMA_SHAPES)
def test_flash_bwd_ffma_every_width_matches_f64(cuda, shape):
    """The ffma pair through autograd, one launch counted as ``ffma``,
    against float64 dense autograd on the same rounded inputs."""
    dtype, B, T, S, Hq, Hkv, Dh, Dv, window, softcap, kind = shape
    q, k, _, _, qpos = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, Dh, kind,
                                   seed=T + Dh)
    _, _, v, do, _ = _bwd_inputs(cuda, dtype, B, T, S, Hq, Hkv, Dv, kind,
                                 seed=T + Dh + 1)
    kw = dict(window=window, softcap=softcap)
    _, want = _dense_grads(q, k, v, do, qpos, **kw)
    fn = flash_kernel.flash_attention_bwd_cuda
    assert flash_kernel.bwd_variant(dtype, Dh, Dv) == "ffma"
    before, by = fn.launches, fn.by_variant["ffma"]
    got = _bwd(do, q, k, v, qpos, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.by_variant["ffma"]) == (before + 1, by + 1)
    assert [tuple(x.shape) for x in got] == [q.shape, k.shape, v.shape]
    _check_grads(got, want, dtype)


def test_flash_bwd_mla_rope_operands_sum_the_shared_key(cuda):
    """With grad, q_rope and k_rope (one RoPE key a position for every
    head) are joined to q and k and the backward runs at 192 / 128:
    dq_rope is dq's last 64 columns, and dk_rope the sum over the heads
    of dk's, against float64 dense autograd on the joined operands."""
    g = torch.Generator(device=cuda).manual_seed(9)
    B, T, H = 1, 300, 4
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).bfloat16()
                   for s in ((B, T, H, 128), (B, T, H, 128), (B, T, H, 128),
                             (B, T, H, 128)))
    qr = torch.randn((B, T, H, 64), generator=g, device=cuda).bfloat16()
    kr = torch.randn((B, T, 1, 64), generator=g, device=cuda).bfloat16()
    qpos = torch.arange(T, dtype=torch.int32, device=cuda)[None]
    leaves = [x.clone().requires_grad_() for x in (q, k, v, qr, kr)]
    fn = flash_kernel.flash_attention_bwd_cuda
    before = fn.launches
    out = flash_kernel.flash_attention_cuda(
        *leaves[:3], qpos=qpos, q_rope=leaves[3], k_rope=leaves[4])
    out.backward(do)
    assert fn.launches == before + 1
    joined = [torch.cat([q, qr], -1), torch.cat([k, kr.expand(-1, -1, H, -1)],
                                                -1)]
    _, (dq, dk, dv) = _dense_grads(*joined, v, do, qpos)
    want = [dq[..., :128], dk[..., :128], dv, dq[..., 128:],
            dk[..., 128:].sum(2, keepdim=True)]
    for x, w in zip((l.grad for l in leaves), want):
        err = torch.linalg.norm(x.double() - w) / torch.linalg.norm(w)
        assert float(err) <= BWD_FRO_TOL[torch.bfloat16], float(err)


def test_flash_bwd_mla_training_shape_is_deterministic(cuda):
    """deepseek-v3's training microbatch, 128 heads over 128 at 4096
    tokens: two launches give the same bits, finite."""
    q, k, _, _, qpos = _bwd_inputs(cuda, torch.bfloat16, 1, 4096, 4096,
                                   128, 128, 192, "tail", seed=30)
    _, _, v, do, _ = _bwd_inputs(cuda, torch.bfloat16, 1, 4096, 4096, 128,
                                 128, 128, "tail", seed=31)
    out, lse = flash_kernel._forward(q, k, v, qpos, None, 0.0, None,
                                     with_lse=True)
    runs = [flash_kernel.flash_attention_bwd_cuda(do, q, k, v, out, lse,
                                                  qpos=qpos)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(bool(torch.isfinite(x).all()) for x in runs[0])


def test_flash_bwd_mla_training_shape_matches_plain_and_f64(cuda):
    """deepseek-v3's training microbatch (q, k (1, 4096, 128, 192), v,
    dO (1, 4096, 128, 128), causal): the dK/dV pass takes its 64-key
    blocks' parts two at a time, key blocks with an odd and an even count
    of parts alike; against the plain blockwise backward (every head)
    and float64 dense autograd (heads 0-7) within BWD_FRO_TOL, two
    launches bit-identical; the pass's two probes launch on the same
    operands and leave the function's bits unchanged after them."""
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention

    q, k, _, _, qpos = _bwd_inputs(cuda, torch.bfloat16, 1, 4096, 4096,
                                   128, 128, 192, "tail", seed=32)
    _, _, v, do, _ = _bwd_inputs(cuda, torch.bfloat16, 1, 4096, 4096, 128,
                                 128, 128, "tail", seed=33)
    out, lse = flash_kernel._forward(q, k, v, qpos, None, 0.0, None,
                                     with_lse=True)

    def kernel():
        return flash_kernel.flash_attention_bwd_cuda(do, q, k, v, out, lse,
                                                     qpos=qpos)
    got = kernel()
    for probe in {**flash_kernel.BWD_PROBES, **flash_kernel.BWD_PARTS}:
        flash_kernel.flash_attention_bwd_probe(do, q, k, v, out, lse,
                                               qpos=qpos, probe=probe)
    again = kernel()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        blockwise_attention(*plain, qpos=qpos, window=None), plain, do)
    for x, w in zip(got, want):
        err = torch.linalg.norm(x.double() - w.double()) / \
            torch.linalg.norm(w.double())
        assert float(err) <= BWD_FRO_TOL[torch.bfloat16], float(err)
    del plain, want
    heads = slice(0, 8)
    _, want64 = _dense_grads(q[:, :, heads], k[:, :, heads], v[:, :, heads],
                             do[:, :, heads], qpos)
    _check_grads([x[:, :, heads] for x in got], want64, torch.bfloat16)


def test_slstm_scan_bwd_training_shape_matches_plain_and_f64(cuda):
    """xlstm-125m's training microbatch (1, 4096, 768), 4 heads, bf16
    pre_x: the backward kernel's dpre (the gate step's forward half
    computed a step ahead, off the chain) within _SLSTM_TOL of its
    largest against float64 autograd through the recurrence and against
    the plain reverse loop; two launches bit-identical; its two probes
    launch on the same operands and leave the function's bits unchanged
    after them."""
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref

    B, T, D, H = 1, 4096, 768, 4
    pre_x, r, _ = _slstm_inputs(B, T, D, H, torch.bfloat16, False, cuda, 40)
    pre_x = pre_x.contiguous()
    dhs = torch.randn((B, T, D), generator=torch.Generator(
        device=cuda).manual_seed(41), device=cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    saved = (torch.empty((B, T, 4 * D), **f32),
             *(torch.empty((B, T, D), **f32) for _ in range(3)))
    slstm_kernel.slstm_scan_kernel(pre_x, r, None,
                                   slstm_kernel.VARIANTS.index("cluster"),
                                   saved)
    got = slstm_kernel.slstm_scan_bwd_cuda(dhs, r, saved)[0]
    for probe in slstm_kernel.BWD_PROBES:
        slstm_kernel.slstm_scan_bwd_probe(dhs, r, saved, probe)
    again = slstm_kernel.slstm_scan_bwd_cuda(dhs, r, saved)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    plain = slstm_scan_bwd_ref(dhs, pre_x, r)[0]
    leaf = pre_x.double().requires_grad_()
    hs64, _ = slstm_scan_ref(leaf, r.double(), None)
    (want,) = torch.autograd.grad((hs64 * dhs.double()).sum(), leaf)
    top = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= _SLSTM_TOL * top
    assert float((got.double() - plain.double()).abs().max()) \
        <= _SLSTM_TOL * top


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


@pytest.mark.parametrize("Hq, Hkv, window, softcap", [(16, 8, 1000, 50.0),
                                                     (10, 1, 500, 0.0)])
def test_flash_bwd_wgmma_dh256_is_deterministic_and_matches_f64(
        cuda, Hq, Hkv, window, softcap):
    """Dh 256 at gemma2's and recurrentgemma's heads over 1536 tokens,
    with a window that binds: two launches agree bit for bit (no
    atomics; the GQA sum in head order) and the gradients are within
    the 2e-2 bound of float64."""
    q, k, v, do, qpos = _bwd_inputs(cuda, torch.bfloat16, 1, 1536, 1536, Hq,
                                    Hkv, 256, "tail", seed=Hq)
    kw = dict(window=window, softcap=softcap)
    out, lse = flash_kernel._forward(q, k, v, qpos, window, softcap, None,
                                     with_lse=True)
    runs = [flash_kernel.flash_attention_bwd_cuda(
        do, q, k, v, out, lse, qpos=qpos, **kw) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    _, want = _dense_grads(q, k, v, do, qpos, **kw)
    torch.cuda.synchronize()
    _check_grads(runs[0], want, torch.bfloat16)


@pytest.mark.parametrize("Hq, Hkv, window, softcap", [(16, 8, None, 50.0),
                                                     (10, 1, 2048, 0.0)])
def test_flash_bwd_dh256_training_shapes_are_deterministic(cuda, Hq, Hkv,
                                                           window, softcap):
    """At gemma2's and recurrentgemma's training microbatch (4096
    tokens) two launches of the Dh-256 backward agree bit for bit: no
    atomics, the dK/dV pass's per-head partials summed in head order."""
    q, k, v, do, qpos = _bwd_inputs(cuda, torch.bfloat16, 1, 4096, 4096, Hq,
                                    Hkv, 256, "tail", seed=Hkv)
    kw = dict(window=window, softcap=softcap)
    out, lse = flash_kernel._forward(q, k, v, qpos, window, softcap, None,
                                     with_lse=True)
    runs = [flash_kernel.flash_attention_bwd_cuda(
        do, q, k, v, out, lse, qpos=qpos, **kw) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.isfinite(a).all() and torch.equal(a, b)


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
@pytest.mark.parametrize("D", [128, 256])
def test_flash_forward_lse_matches_plain(cuda, dtype, D):
    """The forward's log-sum-exp against float64: masked rows -1e30."""
    B, T, S, Hq, Hkv = 2, 96, 80, 8, 2
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


# ----------------------------------------------------------------------
# recurrentgemma: the RG-LRU scan kernel, flash at its heads, the engine
# ----------------------------------------------------------------------
def _f64_scan(x, ga, gi, lam, h0):
    """The RG-LRU recurrence of rglru_scan_ref in float64."""
    x, ga, gi, lam = (t.double() for t in (x, ga, gi, lam))
    log_a = -8.0 * torch.nn.functional.softplus(lam) * torch.sigmoid(ga)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12)) \
        * torch.sigmoid(gi) * x
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.double()
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


# the scan against float64 and its plain float32 loop, relative to
# max|h|: with decays up to a = 0.998 (lam -6) the float32 recurrence
# carries about 1 / (1 - a) = 500 roundings of 2**-24 at worst, 3e-5;
# the kernel's accurate expf, log1pf and sqrtf differ from torch's by
# an ulp or two; 2e-4 bounds both
_SCAN_TOL = 2e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 257, 2048])
@pytest.mark.parametrize("W", [100, 2560])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_cuda_matches_plain_and_f64(cuda, dtype, T, W, with_h0):
    """W = 100 is not a multiple of the kernel's 64-thread block, T = 257
    not one of its 16-step chunks; x and gate_i are strided views of one
    buffer, h0 a view with a batch stride wider than W."""
    g = torch.Generator(device=cuda).manual_seed(T + W)
    B = 3
    xi = torch.randn((B, T, 2, W), generator=g, device=cuda).to(dtype)
    x, gi = xi[:, :, 0], xi[:, :, 1]
    ga = torch.randn((B, T, W), generator=g, device=cuda).to(dtype)
    lam = torch.rand((W,), generator=g, device=cuda) * 10 - 6
    h0 = torch.randn((B, W + 8), generator=g, device=cuda)[:, :W] \
        if with_h0 else None
    n0 = rglru_kernel.rglru_scan_cuda.launches
    got = rglru_scan(x, ga, gi, lam, h0)
    assert rglru_kernel.rglru_scan_cuda.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (B, T, W)
    want = _f64_scan(x, ga, gi, lam, h0)
    plain = rglru_scan_ref(x, ga, gi, lam, h0)
    top = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= _SCAN_TOL * top
    assert float((got - plain).abs().max()) <= _SCAN_TOL * top


def test_rglru_scan_cuda_rejects_bad_input_and_grad(cuda):
    x = torch.randn((2, 8, 64), device=cuda, dtype=torch.bfloat16)
    lam = torch.zeros(64, device=cuda)
    n0 = rglru_kernel.rglru_scan_cuda.launches
    with pytest.raises(TypeError):
        rglru_scan(x, x.float(), x, lam)
    with pytest.raises(TypeError):
        rglru_scan(x.half(), x.half(), x.half(), lam)
    with pytest.raises(ValueError, match="unit-stride last dim"):
        wide = torch.zeros((2, 8, 128), device=cuda, dtype=torch.bfloat16)
        rglru_scan(x, wide[..., ::2], x, lam)
    with pytest.raises(ValueError, match="lam"):
        rglru_scan(x, x, x, lam.bfloat16())
    with pytest.raises(ValueError, match="h0"):
        rglru_scan(x, x, x, lam, torch.zeros((2, 64), device=cuda,
                                             dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one CUDA device"):
        rglru_scan(x, x, x, lam.cpu())
    assert rglru_kernel.rglru_scan_cuda.launches == n0
    # with grad: one forward launch, and the backward kernel's gradients
    # within the scan's bound of the plain backward's
    leaves = [t.clone().requires_grad_() for t in (x, x, x, lam)]
    b0 = rglru_kernel.rglru_scan_bwd_cuda.launches
    h = rglru_scan(*leaves)
    assert h.grad_fn is not None
    g = torch.randn(h.shape, device=cuda)
    got = torch.autograd.grad(h, leaves, g)
    assert rglru_kernel.rglru_scan_cuda.launches == n0 + 1
    assert rglru_kernel.rglru_scan_bwd_cuda.launches == b0 + 1
    want = rglru_scan_bwd_ref(g, x, x, x, lam, None, h.detach())
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert _scan_bwd_close(a, w, float(w.abs().max()))


# the scan's backward against float64 autograd through the plain forward
# and against the plain backward, relative to each gradient's largest
# magnitude: the forward's own bound (the same float32 recurrence, run
# in reverse, carries the same roundings); a bf16 gradient may also sit
# one bf16 ulp of its own (2**-7 relative) off, since two float32 values
# a hair apart can round to neighbouring bf16 values
_SCAN_BWD_TOL = 2e-4


def _scan_bwd_close(got, want, top):
    err = (got.double() - want.double()).abs()
    slack = want.double().abs() * 2.0 ** -7 \
        if got.dtype == torch.bfloat16 else 0.0
    return bool((err <= _SCAN_BWD_TOL * top + slack).all())


def _scan_grads_f64(x, ga, gi, lam, h0, g):
    leaves = [t.double().requires_grad_()
              for t in (x, ga, gi, lam) + ((h0,) if h0 is not None else ())]
    out = _f64_scan(*leaves[:4], leaves[4] if h0 is not None else None)
    return torch.autograd.grad(out, leaves, g.double())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, T, W", [(1, 1, 64), (2, 9, 100), (3, 257, 2560),
                                     (1, 4096, 2560), (1, 2061, 2560),
                                     (4, 1000, 2560)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_cuda_matches_plain_and_f64(cuda, dtype, B, T, W,
                                                   with_h0):
    """The backward kernel through autograd, from the forward's h: each
    gradient within 2e-4 of float64 autograd and of the plain backward
    (bf16 ones also within one bf16 ulp of their own), and
    two launches bit-identical, dlam included.  lam spreads decays up
    to a near 1 (lam -6) and, in its first two channels, reaches a = 1
    in float32 (lam -25), where 1 - a^2 is 0 and the clamp binds, in
    the kernel and in the plain backward alike; in float64 a is not 1
    there and mult is 15 times larger, so those two channels are held
    to the plain backward alone."""
    g = torch.Generator(device=cuda).manual_seed(T + W + B)
    x, ga, gi = (torch.randn((B, T, W), generator=g, device=cuda).to(dtype)
                 for _ in range(3))
    lam = torch.rand((W,), generator=g, device=cuda) * 10 - 6
    lam[:2] = -25.0
    h0 = torch.randn((B, W), generator=g, device=cuda) if with_h0 else None
    dh = torch.randn((B, T, W), generator=g, device=cuda)
    leaves = [t.clone().requires_grad_()
              for t in (x, ga, gi, lam) + ((h0,) if with_h0 else ())]
    h = rglru_scan(*leaves[:4], leaves[4] if with_h0 else None)
    got = torch.autograd.grad(h, leaves, dh)
    again = rglru_kernel.rglru_scan_bwd_cuda(dh, x, ga, gi, lam, h0,
                                            h.detach())
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    plain = rglru_scan_bwd_ref(dh, x, ga, gi, lam, h0, h.detach())
    want = _scan_grads_f64(x, ga, gi, lam, h0, dh)
    for i, (a, p, w) in enumerate(zip(got, plain, want)):
        assert a.dtype == (dtype if i < 3 else torch.float32)
        top = float(w.abs().max())
        assert _scan_bwd_close(a[..., 2:], w[..., 2:], top), i
        assert _scan_bwd_close(a, p, top), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_cuda_copy_paths_agree(cuda, dtype, with_h0):
    """Inputs whose rows start off 16 bytes (views one element into a
    wider buffer) take the backward's per-thread copies, contiguous ones
    its 16-byte block copies; the arithmetic and its order are the
    same, so the gradients agree bit for bit.  T spans several rounds
    of the cluster with a ragged last window."""
    B, W = 2, 2560
    T = 3 * rglru_kernel.CHUNK_WINDOW * rglru_kernel.BWD_CLUSTER + 11
    g = torch.Generator(device=cuda).manual_seed(29)
    wide = [torch.randn((B, T, W + 1), generator=g, device=cuda).to(dtype)
            for _ in range(3)]
    views = [t[..., 1:] for t in wide]
    lam = torch.rand((W,), generator=g, device=cuda) * 10 - 6
    h0 = torch.randn((B, W), generator=g, device=cuda) if with_h0 else None
    dh = torch.randn((B, T, W), generator=g, device=cuda)
    h = rglru_kernel.rglru_scan_cuda(*views, lam, h0)
    got = rglru_kernel.rglru_scan_bwd_cuda(dh, *views, lam, h0, h)
    want = rglru_kernel.rglru_scan_bwd_cuda(
        dh, *(v.contiguous() for v in views), lam, h0, h)
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        assert a is None or torch.equal(a, w)


# T on each side of the variant threshold and of the chunked kernel's
# sub-chunk and window, and over several rounds of its cluster with a
# ragged last window
_SCAN_EDGE_T = sorted({
    rglru_kernel.CHUNKED_MIN_T - 1, rglru_kernel.CHUNKED_MIN_T,
    rglru_kernel.CHUNK_STEPS - 1, rglru_kernel.CHUNK_STEPS,
    rglru_kernel.CHUNK_STEPS + 1, rglru_kernel.CHUNK_WINDOW - 1,
    rglru_kernel.CHUNK_WINDOW, rglru_kernel.CHUNK_WINDOW + 1,
    5 * rglru_kernel.CHUNK_WINDOW * rglru_kernel.CHUNK_CLUSTER + 13})


def _scan_inputs(dev, B, T, W, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x, ga, gi = (torch.randn((B, T, W), generator=g, device=dev).to(dtype)
                 for _ in range(3))
    lam = torch.rand((W,), generator=g, device=dev) * 10 - 6
    h0 = torch.randn((B, W), generator=g, device=dev)
    return x, ga, gi, lam, h0


def _assert_scan_close(got, x, ga, gi, lam, h0):
    want = _f64_scan(x, ga, gi, lam, h0)
    plain = rglru_scan_ref(x, ga, gi, lam, h0)
    top = float(want.abs().max())
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert float((got.double() - want).abs().max()) <= _SCAN_TOL * top
    assert float((got - plain).abs().max()) <= _SCAN_TOL * top


@pytest.mark.parametrize("variant", rglru_kernel.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", _SCAN_EDGE_T)
@pytest.mark.parametrize("W", [100, 2560])
def test_rglru_scan_variants_match_f64_at_window_edges(cuda, variant, dtype,
                                                       T, W):
    """Both variants by name, from a state h0, at every edge of the
    chunked kernel's decomposition; W = 100 leaves a strip part full."""
    args = _scan_inputs(cuda, 3, T, W, dtype, T * 7 + W)
    got = rglru_kernel.rglru_scan_cuda(*args, variant=variant)
    _assert_scan_close(got, *args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W", [101, 2560])
def test_rglru_scan_chunked_takes_unpaired_channels(cuda, dtype, W):
    """Inputs one element off a 4-byte boundary (and W = 101 odd): the
    chunked kernel's bfloat16 lanes cannot load channel pairs as one
    word, so it takes one channel a lane and loads through registers."""
    B, T = 2, 3 * rglru_kernel.CHUNK_WINDOW * rglru_kernel.CHUNK_CLUSTER + 9
    g = torch.Generator(device=cuda).manual_seed(W)
    buf = torch.randn((3, B, T, W + 1), generator=g, device=cuda).to(dtype)
    x, ga, gi = buf[0, ..., 1:], buf[1, ..., 1:], buf[2, ..., 1:]
    lam = torch.rand((W,), generator=g, device=cuda) * 10 - 6
    h0 = torch.randn((B, W), generator=g, device=cuda)
    got = rglru_kernel.rglru_scan_cuda(x, ga, gi, lam, h0, variant="chunked")
    _assert_scan_close(got, x, ga, gi, lam, h0)


@pytest.mark.parametrize("variant", rglru_kernel.VARIANTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rglru_scan_carries_the_state_across_every_boundary(cuda, variant,
                                                             dtype):
    """x = 0 after step 0 and a large h0, decays near 1: h_t = h_0 times
    the product of a, so a carry dropped or doubled at a sub-chunk,
    window or cluster-round boundary puts the element off by about its
    own size.  Held elementwise, relative to each |h_t|."""
    B, W = 2, 2560
    T = 3 * rglru_kernel.CHUNK_WINDOW * rglru_kernel.CHUNK_CLUSTER + 5
    x, ga, gi, _, h0 = _scan_inputs(cuda, B, T, W, dtype, 11)
    x[:, 1:] = 0
    ga = (ga.float() * 0.1 - 2).to(dtype)      # a near 0.9976 at lam -6
    lam = torch.full((W,), -6.0, device=cuda)
    h0 = h0 * 100
    got = rglru_kernel.rglru_scan_cuda(x, ga, gi, lam, h0, variant=variant)
    want = _f64_scan(x, ga, gi, lam, h0)
    assert bool((want.abs() > 0).all())
    rel = (got.double() - want).abs() / want.abs()
    assert float(rel.max()) <= _SCAN_TOL


@pytest.mark.parametrize("B", [1, 12])
def test_rglru_scan_chunked_one_row_and_many_waves(cuda, B):
    """B = 1, and B = 12 at lru_width 2560: 1,920 blocks, more than the
    card holds at once, so clusters of a later wave carry too."""
    T = 2 * rglru_kernel.CHUNK_WINDOW * rglru_kernel.CHUNK_CLUSTER + 7
    args = _scan_inputs(cuda, B, T, 2560, torch.bfloat16, B)
    got = rglru_kernel.rglru_scan_cuda(*args, variant="chunked")
    _assert_scan_close(got, *args)


def test_rglru_scan_chunked_math_is_ieee(cuda):
    """The chunked kernel's branch-free reciprocal and square root round
    as IEEE division and sqrtf on every float32 the kernel gives them
    (d in [1, 2^126], x in [1e-12, 1])."""
    import ctypes

    from repro_torch.kernels import build
    bad = torch.zeros(2, dtype=torch.int64, device=cuda)
    lib = build.load("rglru_scan")
    assert lib.rglru_scan_math_check(
        ctypes.c_void_p(bad.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) == 0
    assert bad.tolist() == [0, 0]


def test_rglru_scan_counts_launches_by_variant(cuda):
    """Each call adds one launch, to the variant scan_variant names for
    its shape."""
    fn = rglru_kernel.rglru_scan_cuda
    W = 256
    for T in (1, rglru_kernel.CHUNKED_MIN_T - 1, rglru_kernel.CHUNKED_MIN_T,
              2048):
        args = _scan_inputs(cuda, 4, T, W, torch.bfloat16, T)
        n0, v0 = fn.launches, dict(fn.by_variant)
        rglru_scan(*args)
        want = rglru_kernel.scan_variant(4, T, W)
        assert fn.launches == n0 + 1
        assert fn.by_variant == {v: n + (v == want) for v, n in v0.items()}


@pytest.mark.parametrize("T, S", [(2100, 2100), (300, 2600)])
def test_flash_wgmma_dh256_recurrentgemma_heads(cuda, T, S):
    """recurrentgemma's ring prefill: 10 query heads over 1 kv head of
    256, window 2048, S beyond the window so that it binds."""
    q, k, v, qpos = _flash_inputs(cuda, torch.bfloat16, B=1, T=T, S=S,
                                  Hq=10, Hkv=1, Dh=256)
    n0 = flash_kernel.flash_attention_cuda.by_variant["wgmma"]
    got = flash_attention(q, k, v, qpos=qpos, window=2048)
    assert flash_kernel.flash_attention_cuda.by_variant["wgmma"] == n0 + 1
    want = dense_attention(q, k, v, qpos=qpos, window=2048)
    tol = _FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_reduced_recurrentgemma_engine_on_card_matches_cpu(cuda):
    """The seeded reduced model in float32 on the card and on the CPU:
    every prefill launches flash once (its one attention layer) and the
    scan once per recurrent layer, every decode step the scan alone;
    the 40-token prompt takes the scan's chunked variant, the 9-token
    one (under CHUNKED_MIN_T) and the decode steps its sequential one;
    the greedy tokens agree."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 40), rng.integers(0, 256, 9)]
    cfg = get_config("recurrentgemma-2b").reduced()
    bundle = build(cfg, torch.float32, "cpu")
    params = bundle.init(3)
    for layer in params["rec"]:            # decays that carry the state
        layer["lam"] = torch.linspace(-6, 4, cfg.rg.lru_width)
    host = Engine(bundle, params, ServeConfig(max_seq=64, slots=2))
    card = Engine(build(cfg, torch.float32, "cuda"), _tree_to(params, cuda),
                  ServeConfig(max_seq=64, slots=2))
    want = _serve(host, prompts, 24)
    flash, scan = flash_kernel.flash_attention_cuda, rglru_kernel.rglru_scan_cuda
    f0, s0, v0 = flash.launches, scan.launches, dict(scan.by_variant)
    got = _serve(card, prompts, 24)
    assert flash.launches - f0 == len(prompts)
    assert scan.launches - s0 == 3 * (len(prompts) + 24)
    assert [rglru_kernel.scan_variant(2, len(p), cfg.rg.lru_width)
            for p in prompts] == ["chunked", "sequential"]
    assert scan.by_variant["chunked"] - v0["chunked"] == 3
    assert scan.by_variant["sequential"] - v0["sequential"] == 3 * (1 + 24)
    assert got == want


def test_recurrentgemma_with_grad_on_card_raises(cuda):
    """No longer raises: the reduced model (heads of 256) trains on the
    card.  Its loss and every gradient through the kernels (the scan's forward and
    backward, flash at T >= FLASH_MIN_T) within 1e-4 of the plain path's
    (the plain scan and blockwise attention on the same card) in
    float32, and each kernel launched: the scan twice a recurrent layer
    (the forward and the checkpoint's recompute) and its backward once,
    flash and its backward once a layer."""
    import functools

    import repro_torch.models.layers as LY
    import repro_torch.models.rglru as RG
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.layers import FLASH_MIN_T
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)
    from repro_torch.tree import tree_leaves

    import dataclasses

    # heads of 256, as the full model's (the flash backward's head dims)
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              d_head=256)
    bundle = build(cfg, torch.float32, "cuda")
    params = bundle.init(0, dtype=torch.float32)
    for layer in params["rec"]:            # decays that carry the state
        layer["lam"] = torch.linspace(-6, 4, cfg.rg.lru_width, device=cuda)
    toks = torch.randint(0, cfg.vocab, (1, FLASH_MIN_T + 1), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grad_fn = value_and_grad(make_loss_fn(bundle, TrainConfig()))
    scan, flash = rglru_kernel, flash_kernel
    n_rec, n_att = len(params["rec"]), len(params["attn"])
    before = (scan.rglru_scan_cuda.launches, scan.rglru_scan_bwd_cuda.launches,
              flash.flash_attention_cuda.launches,
              flash.flash_attention_bwd_cuda.launches)
    loss, _, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    after = (scan.rglru_scan_cuda.launches, scan.rglru_scan_bwd_cuda.launches,
             flash.flash_attention_cuda.launches,
             flash.flash_attention_bwd_cuda.launches)
    assert [b - a for a, b in zip(before, after)] == [
        2 * n_rec, n_rec, 2 * n_att, n_att]
    real_scan, real_flash = RG.rglru_scan, LY.flash_attention
    RG.rglru_scan = rglru_scan_ref
    LY.flash_attention = functools.partial(flash_ops.flash_attention,
                                           impl="blockwise")
    try:
        loss_p, _, plain = grad_fn(params, batch)
    finally:
        RG.rglru_scan, LY.flash_attention = real_scan, real_flash
    assert [b - a for a, b in zip(after, (
        scan.rglru_scan_cuda.launches, scan.rglru_scan_bwd_cuda.launches,
        flash.flash_attention_cuda.launches,
        flash.flash_attention_bwd_cuda.launches))] == [0, 0, 0, 0]
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(grads), tree_leaves(plain)):
        assert torch.isfinite(a).all()
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * max(top, 1e-30)


# ----------------------------------------------------------------------
# xlstm: the sLSTM recurrence kernel, the engine
# ----------------------------------------------------------------------
def _f64_slstm(pre_x, r, state):
    """hs and the final state of slstm_scan_ref's recurrence in float64."""
    B, T, D4 = pre_x.shape
    D, (H, Dh, _) = D4 // 4, r.shape
    c, n, h, m = (torch.zeros((B, D), dtype=torch.float64, device=r.device)
                  if s is None else s.double()
                  for s in (state or (None,) * 4))
    r = r.double()
    hs = torch.empty((B, T, D), dtype=torch.float64, device=r.device)
    for t in range(T):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r)
        i_, f_, z_, o_ = torch.split(pre_x[:, t].double()
                                     + rec.reshape(B, 4 * D), D, dim=-1)
        m_new = torch.maximum(f_ + m, i_)
        i_g, f_g = torch.exp(i_ - m_new), torch.exp(f_ + m - m_new)
        c, n = f_g * c + i_g * torch.tanh(z_), f_g * n + i_g
        h = torch.sigmoid(o_) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs[:, t] = h
    return hs, (c, n, h, m)


# the sLSTM kernel against float64 and its plain float32 loop, relative
# to max|h| (|h| <= 1 from a state the recurrence can reach).  The
# recurrence feeds each step's rounding back through r, so the float32
# loop itself drifts from float64 along T: by 0.9-1.6e-4 of max|h| at
# T 2048 on xlstm-125m's width from pre_x ~ N(0, 1) in bf16 (the
# model's pre-activations; chip_smoke.py's slstm_phase on an H100),
# about 1e-5 at T 256.  Kernel and plain loop each
# drift that much, in other directions (the kernel sums the recurrent
# product in another order, with FMAs); 1e-3 bounds both, while a gate
# read from its head's own outputs parts by over 1e-2 in one step
# (tests/test_torch_xlstm_blocks.py)
_SLSTM_TOL = 1e-3


def _slstm_inputs(B, T, D, H, dtype, with_state, device, seed):
    """pre_x (B, T, 4D) as a view with batch and time strides of its own
    (a slice of a longer buffer), r with the model's scale, and a state
    the recurrence can reach (n > 0, |c| <= n) or None."""
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn((B, T + 3, 4 * D), generator=g, device=device)
    pre_x = buf.to(dtype)[:, 2:2 + T]
    Dh = D // H
    r = torch.randn((H, Dh, 4 * Dh), generator=g, device=device) \
        * (0.5 / Dh ** 0.5)
    state = None
    if with_state:
        n = torch.rand((B, D), generator=g, device=device) * 4 + 0.1
        c = n * (torch.rand((B, D), generator=g, device=device) * 2 - 1)
        h = torch.rand((B, D), generator=g, device=device) * 2 - 1
        m = torch.randn((B, D), generator=g, device=device) * 3
        state = (c, n, h, m)
    return pre_x, r, state


def _slstm_close(hs, st, pre_x, r, state, check_plain=True):
    """hs within _SLSTM_TOL of max|h| of float64 (and of the plain loop),
    the final state of float64's, and the final h the last step's."""
    want, want_st = _f64_slstm(pre_x, r, state)
    top = float(want.abs().max())
    assert top <= 1.0
    assert float((hs.double() - want).abs().max()) <= _SLSTM_TOL * top
    if check_plain:
        plain, _ = slstm_scan_ref(pre_x, r, state)
        assert float((hs - plain).abs().max()) <= _SLSTM_TOL * top
    assert torch.equal(st[2], hs[:, -1])
    for got, w64 in zip(st, want_st):
        assert float((got.double() - w64).abs().max()) <= \
            _SLSTM_TOL * max(1.0, float(w64.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 2, 7, 256, 2048])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_cuda_matches_plain_and_f64(cuda, dtype, T, B,
                                               with_state):
    """xlstm-125m's width (D 768, 4 heads of 192), each T on the variant
    slstm_variant names for it (``step`` below STEP_MAX_T, ``cluster``
    from there); the final state is the last step's."""
    pre_x, r, state = _slstm_inputs(B, T, 768, 4, dtype, with_state, cuda,
                                    T + B)
    sk = slstm_kernel.slstm_scan_cuda
    v = slstm_kernel.slstm_variant(B, T, 768, 4)
    n0, v0 = sk.launches, sk.by_variant[v]
    hs, st = slstm_scan(pre_x, r, state)
    assert sk.launches == n0 + 1 and sk.by_variant[v] == v0 + 1
    assert hs.dtype == torch.float32 and hs.shape == (B, T, 768)
    _slstm_close(hs, st, pre_x, r, state)


@pytest.mark.parametrize("variant", slstm_kernel.VARIANTS)
@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_slstm_scan_each_variant_at_each_T(cuda, variant, T):
    """Both kernels, forced, take every T: ``step`` loops its steps with
    a grid barrier between them, ``cluster`` takes a decode step too."""
    pre_x, r, state = _slstm_inputs(4, T, 768, 4, torch.bfloat16, True,
                                    cuda, 40 + T)
    hs, st = slstm_kernel.slstm_scan_kernel(
        pre_x, r, state, slstm_kernel.VARIANTS.index(variant))
    _slstm_close(hs, st, pre_x, r, state)


@pytest.mark.parametrize("B, T, D", [(4, 1, 768), (4, 2, 768), (4, 3, 768),
                                     (4, 64, 768), (2, 8, 1024),
                                     (64, 1, 768)])
def test_slstm_scan_hd_takes_the_wrappers_variant(cuda, B, T, D):
    """The C entry slstm_scan_hd, which picks its kernel itself, gives the
    bits of the variant the wrapper launches and counts for the shape,
    and not the other's (the two sum the product in other orders): on
    both sides of STEP_MAX_T, where only `step` fits (D 1024) and where
    only `cluster` does (B 64)."""
    pre_x, r, state = _slstm_inputs(B, T, D, 4, torch.bfloat16, True, cuda,
                                    B + T + D)
    v = slstm_kernel.slstm_variant(B, T, D, 4)
    hs, st = slstm_kernel.slstm_scan_kernel(
        pre_x, r, state, slstm_kernel.VARIANTS.index(v))
    hs_c = torch.empty_like(hs)
    st_c = tuple(torch.empty_like(s) for s in state)
    err = slstm_kernel._entry("slstm_scan_hd")(
        pre_x.data_ptr(), r.data_ptr(), *(s.data_ptr() for s in state),
        hs_c.data_ptr(), *(s.data_ptr() for s in st_c), 1, B, T, D, 4,
        pre_x.stride(0), pre_x.stride(1),
        slstm_kernel._stream(torch.cuda.current_device()))
    assert err == 0
    assert torch.equal(hs_c, hs)
    assert all(torch.equal(a, b) for a, b in zip(st_c, st))
    other = "cluster" if v == "step" else "step"
    if slstm_kernel.cluster_fits(D, 4) if other == "cluster" \
            else slstm_kernel.step_fits(B, D):
        hs_o, _ = slstm_kernel.slstm_scan_kernel(
            pre_x, r, state, slstm_kernel.VARIANTS.index(other))
        assert not torch.equal(hs_o, hs)


@pytest.mark.parametrize("T", [1, 300])
@pytest.mark.parametrize("B, D, H", [(3, 64, 4), (5, 72, 4), (2, 48, 2),
                                     (3, 30, 2), (2, 1024, 4)])
def test_slstm_scan_cuda_ragged_shapes(cuda, B, D, H, T):
    """Rows that do not fill a row group, blocks with empty units (D 72:
    5 units a `cluster` block, 80 places; heads of 18, not a multiple of
    4), two gates in one head (2 heads), columns that are not 4 aligned
    neighbours in one head (D 30: each kernel's scalar path), and D
    1024, which only `step` takes (64 units a cluster block), at any
    T."""
    pre_x, r, state = _slstm_inputs(B, T, D, H, torch.bfloat16, True,
                                    cuda, D + T)
    want_v = "step" if T == 1 or D == 1024 else "cluster"
    assert slstm_kernel.slstm_variant(B, T, D, H) == want_v
    hs, st = slstm_scan(pre_x, r, state)
    _slstm_close(hs, st, pre_x, r, state, check_plain=False)


@pytest.mark.parametrize("B, T, D", [(4, 33, 768), (4, 1, 768),
                                     (4, 2, 768), (8, 1, 768),
                                     (4, 1, 1536)])
def test_slstm_scan_cuda_writes_the_state_in_place(cuda, B, T, D):
    """``out`` = the state's own tensors, rows of a cache: the final state
    lands there, equal to the launch that wrote elsewhere, and the
    neighbouring rows stay as they were.  On ``step`` (T 1, 2) every
    block reads all of h_{-1} and writes its units' h over it: at B 8,
    D 768 and at B 4, D 1536 its 192 blocks spread over the card, so a
    block that wrote before another had read would show here."""
    pre_x, r, state = _slstm_inputs(B, T, D, 4, torch.bfloat16, True, cuda,
                                    9 + B + D)
    want_hs, want_st = slstm_scan(pre_x, r, state)
    cache = torch.zeros((4, 2, B, D), device=cuda)
    for k, s in enumerate(state):
        cache[k, 1] = s
    rows = tuple(cache[k, 1] for k in range(4))
    for _ in range(3):
        for k, s in enumerate(state):
            rows[k].copy_(s)
        hs, st = slstm_scan(pre_x, r, rows, out=rows)
        assert all(a is b for a, b in zip(st, rows))
        assert torch.equal(hs, want_hs)
        assert all(torch.equal(a, b) for a, b in zip(rows, want_st))
        assert float(cache[:, 0].abs().max()) == 0.0
    _slstm_close(want_hs, want_st, pre_x, r, state, check_plain=False)


def test_slstm_scan_cuda_rejects_bad_input_and_grad(cuda):
    pre_x, r, state = _slstm_inputs(2, 8, 64, 4, torch.bfloat16, True, cuda,
                                    1)
    n0 = slstm_kernel.slstm_scan_cuda.launches
    with pytest.raises(TypeError):
        slstm_scan(pre_x.half(), r)
    with pytest.raises(ValueError, match="unit-stride last dim"):
        wide = torch.zeros((2, 8, 512), device=cuda, dtype=torch.bfloat16)
        slstm_scan(wide[..., ::2], r)
    with pytest.raises(ValueError, match="r must be"):
        slstm_scan(pre_x, r.bfloat16())
    with pytest.raises(ValueError, match="r must be"):
        slstm_scan(pre_x, r.reshape(2, 32, 64))
    with pytest.raises(ValueError, match="state must hold"):
        slstm_scan(pre_x, r, tuple(s.bfloat16() for s in state))
    with pytest.raises(ValueError, match="device of pre_x"):
        slstm_scan(pre_x, r, tuple(s.cpu() for s in state))
    with pytest.raises(ValueError, match="takes D up to"):
        wide, rw = _slstm_inputs(64, 8, 4096, 16, torch.bfloat16, False,
                                 cuda, 2)[:2]
        slstm_scan(wide, rw)
    # with grad the kernel runs (a backward exists), but takes no out=
    # and at most BWD_MAX_HEADS heads
    with pytest.raises(ValueError, match="no out= with grad"):
        slstm_scan(pre_x, r.clone().requires_grad_(), state, out=state)
    with pytest.raises(ValueError, match="backward takes"):
        p8, r8 = _slstm_inputs(2, 8, 64, 8, torch.bfloat16, False, cuda,
                               3)[:2]
        slstm_scan(p8, r8.requires_grad_())
    hs, _ = slstm_scan(pre_x, r.clone().requires_grad_())
    assert hs.grad_fn is not None
    with torch.no_grad():
        slstm_scan(pre_x, r.clone().requires_grad_())
    assert slstm_kernel.slstm_scan_cuda.launches == n0 + 2


# the backward kernel against float64 autograd and the plain reverse
# loop, each gradient within _SLSTM_TOL of its largest magnitude
@pytest.mark.parametrize("B, T, D, H", [(1, 300, 768, 4), (2, 64, 64, 4),
                                        (3, 7, 48, 2), (2, 1, 768, 4),
                                        (1, 2, 96, 1), (2, 40, 72, 4)])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_bwd_cuda_matches_plain_and_f64(cuda, B, T, D, H,
                                                   with_state):
    """Through autograd (SlstmScanFunction): d pre_x in pre_x's bf16, dr,
    and with a state dc, dn, dh, dm, with the final state's gradients
    given too; one forward and one backward launch; two backward
    launches bit-identical."""
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref

    pre_x, r, state = _slstm_inputs(B, T, D, H, torch.bfloat16, with_state,
                                    cuda, 7 * T + D)
    g = torch.Generator(device=cuda).manual_seed(T)
    dhs = torch.randn((B, T, D), generator=g, device=cuda)
    dfin = [torch.randn((B, D), generator=g, device=cuda) for _ in range(4)]
    leaves = [x.detach().clone().requires_grad_()
              for x in (pre_x, r) + (state or ())]
    sk, bk = slstm_kernel.slstm_scan_cuda, slstm_kernel.slstm_scan_bwd_cuda
    n0, b0 = sk.launches, bk.launches
    hs, fin = slstm_scan(leaves[0], leaves[1],
                         tuple(leaves[2:]) if with_state else None)
    loss = (hs * dhs).sum() + sum((a * b).sum() for a, b in zip(fin, dfin))
    got = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert (sk.launches - n0, bk.launches - b0) == (1, 1)
    assert got[0].dtype == torch.bfloat16
    plain = slstm_scan_bwd_ref(dhs, pre_x, r, state, dfin)
    want64 = [x.double().detach().requires_grad_()
              for x in (pre_x, r) + (state or ())]
    hs64, fin64 = slstm_scan_ref(want64[0], want64[1],
                                 tuple(want64[2:]) if with_state else None)
    loss64 = (hs64 * dhs.double()).sum() + sum(
        (a * b.double()).sum() for a, b in zip(fin64, dfin))
    want = torch.autograd.grad(loss64, want64)
    ref_list = [plain[0], plain[1]] + (list(plain[2]) if with_state else [])
    for a, p, w in zip(got, ref_list, want):
        top = float(w.abs().max())
        # bf16 d pre_x: one bf16 ulp of its own on top
        slack = w.abs() * 2.0 ** -7 if a.dtype == torch.bfloat16 else 0.0
        assert bool(((a.double() - w).abs() <= _SLSTM_TOL * top + slack)
                    .all())
        assert bool(((a.double() - p.double()).abs()
                     <= _SLSTM_TOL * top + slack).all())
    # forward and backward again: the same bits
    hs2, fin2 = slstm_scan(leaves[0], leaves[1],
                           tuple(leaves[2:]) if with_state else None)
    loss2 = (hs2 * dhs).sum() + sum((a * b).sum()
                                    for a, b in zip(fin2, dfin))
    again = torch.autograd.grad(loss2, leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_reduced_xlstm_engine_on_card_matches_cpu(cuda):
    """The seeded reduced model in float32 on the card and on the CPU:
    every prefill and every decode step launches the sLSTM kernel once
    per sLSTM layer (2) and nothing else; a 512-token prompt takes the
    mLSTM's chunk scan, a 40-token one a single chunk; the greedy tokens
    agree."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 512), rng.integers(0, 256, 40)]
    cfg = get_config("xlstm-125m").reduced()
    bundle = build(cfg, torch.float32, "cpu")
    params = bundle.init(3)
    host = Engine(bundle, params, ServeConfig(max_seq=64, slots=2))
    card = Engine(build(cfg, torch.float32, "cuda"), _tree_to(params, cuda),
                  ServeConfig(max_seq=64, slots=2))
    want = _serve(host, prompts, 24)
    flash, sl = flash_kernel.flash_attention_cuda, slstm_kernel.slstm_scan_cuda
    f0, s0 = flash.launches, sl.launches
    got = _serve(card, prompts, 24)
    assert flash.launches == f0
    assert sl.launches - s0 == 2 * (len(prompts) + 24)
    assert got == want


def test_xlstm_with_grad_on_card_raises(cuda):
    """No longer raises: reduced xlstm (2 mLSTM, 2 sLSTM blocks) trains on
    the card, at T 40 and 512.  In float32, its loss and every gradient
    through the sLSTM kernels (forward twice a layer, the checkpoint's
    recompute included, and the backward once) within 1e-3 of each
    leaf's largest of the plain loop's on the same card.  In bf16, where
    the model's own gradients part under changes far below an ulp
    (tests/test_torch_xlstm_spread.py), every gradient finite and each
    sLSTM layer's kernels held on the microbatch's own inputs: hs, d
    pre_x (one bf16 ulp more) and dr within 1e-3 of their largest of the
    plain loops'; the logits of a forward without grad finite."""
    import repro_torch.models.xlstm as XL
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref
    from repro_torch.train.step import (TrainConfig, make_loss_fn,
                                        value_and_grad)
    from repro_torch.tree import tree_leaves

    cfg = get_config("xlstm-125m").reduced()
    sk, bk = slstm_kernel.slstm_scan_cuda, slstm_kernel.slstm_scan_bwd_cuda
    real = XL.slstm_scan
    for dtype in (torch.float32, torch.bfloat16):
        bundle = build(cfg, dtype, "cuda")
        params = bundle.init(0, dtype=torch.float32)
        grad_fn = value_and_grad(make_loss_fn(bundle, TrainConfig()))
        n_s = len(params["slstm"])
        for T in (40, 512):
            toks = torch.randint(0, cfg.vocab, (2, T + 1), device=cuda)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            taps = []

            def scan(pre_x, r, state=None, out=None):
                hs, fin = real(pre_x, r, state, out=out)
                tap = {"pre_x": pre_x.detach(), "r": r.detach(),
                       "hs": hs.detach()}
                hs.register_hook(lambda g: tap.__setitem__("dhs", g))
                pre_x.register_hook(lambda g: tap.__setitem__("dpre", g))
                taps.append(tap)
                return hs, fin
            n0, b0 = sk.launches, bk.launches
            XL.slstm_scan = scan
            try:
                loss, _, grads = grad_fn(params, batch)
                torch.cuda.synchronize()
            finally:
                XL.slstm_scan = real
            assert (sk.launches - n0, bk.launches - b0) == (2 * n_s, n_s)
            for a in tree_leaves(grads):
                assert torch.isfinite(a).all()
            if dtype == torch.bfloat16:
                taps = [t for t in taps if "dhs" in t]
                assert len(taps) == n_s
                for t, g in zip(taps, grads["slstm"]):
                    hs, _ = slstm_scan_ref(t["pre_x"], t["r"])
                    dpre, dr, _ = slstm_scan_bwd_ref(t["dhs"].float(),
                                                     t["pre_x"], t["r"])
                    for x, w, slack in ((t["hs"], hs, 0.0),
                                        (t["dpre"], dpre, 2.0 ** -7),
                                        (g["r_in"], dr, 0.0)):
                        err = (x.double() - w.double()).abs()
                        assert bool((err <= 1e-3 * float(w.abs().max())
                                     + slack * w.double().abs()).all())
                with torch.no_grad():
                    logits, _ = bundle.forward(params, batch)
                assert bool(torch.isfinite(logits).all())
                continue
            XL.slstm_scan = slstm_scan_ref
            try:
                loss_p, _, plain = grad_fn(params, batch)
            finally:
                XL.slstm_scan = real
            torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=1e-6)
            for a, b in zip(tree_leaves(grads), tree_leaves(plain)):
                top = float(b.abs().max())
                assert float((a - b).abs().max()) <= 1e-3 * max(top, 1e-30)


@pytest.mark.parametrize("Dh, Dv", [(128, 128), (48, 32)])
def test_flash_out_writes_through_its_strides(cuda, Dh, Dv):
    """``out=`` a band of a wider buffer: the kernel writes the same bits
    as into a fresh tensor, through the band's row pitch, and nothing
    else; an ``out`` sharing memory with q raises."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((1, 100, 4, Dh), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, 120, 2, Dh), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, 120, 2, Dv), generator=g, device=cuda).bfloat16()
    qpos = torch.arange(20, 120, dtype=torch.int32, device=cuda)[None]
    want = flash_attention(q, k, v, qpos=qpos)
    buf = torch.full((130, 4 * Dv + 24), 7.0, device=cuda).bfloat16()
    band = buf[10:110, 8:8 + 4 * Dv].unflatten(1, (4, Dv))[None]
    assert flash_attention(q, k, v, qpos=qpos, out=band) is band
    assert torch.equal(band, want)
    assert torch.all(buf[:10] == 7.0) and torch.all(buf[110:] == 7.0)
    assert torch.all(buf[:, :8] == 7.0) and torch.all(buf[:, 8 + 4 * Dv:]
                                                        == 7.0)
    with pytest.raises(ValueError, match="share memory"):
        flash_attention(q, k, v, qpos=qpos, out=q[..., :Dv])


def test_mla_naive_form_takes_mma_sync_on_card(cuda):
    """One MLA layer of reduced deepseek-v3 in bf16 at T 1030: the naive
    form launches flash's mma_sync once (Dh 24 / Dv 16) and agrees with
    the absorbed form within tests/test_torch_mla.py's bf16 bound."""
    from repro_torch.models import mla

    cfg = get_config("deepseek-v3-671b").reduced()
    p = mla.mla_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                       dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 1030, cfg.d_model), generator=g,
                    device=cuda).bfloat16()
    fn = flash_kernel.flash_attention_cuda
    n0, m0 = fn.launches, fn.by_variant["mma_sync"]
    naive, _ = mla.mla_attention(p, x, cfg)
    assert (fn.launches - n0, fn.by_variant["mma_sync"] - m0) == (1, 1)
    absorbed, _ = mla.mla_attention(p, x, cfg, naive=False)
    assert fn.launches - n0 == 1
    err = torch.linalg.norm(naive.double() - absorbed.double()) \
        / torch.linalg.norm(absorbed.double())
    assert float(err) <= 2e-2


@pytest.mark.parametrize("Hq, Hkv, Dh, Dv, variant", [
    (8, 2, 64, 64, "wgmma"), (8, 8, 48, 32, "mma_sync")])
def test_make_flash_kernel_on_the_torch_backend(cuda, Hq, Hkv, Dh, Dv,
                                                variant):
    """One fp16 sequence of 512 tokens, its query rows over 4 ranks:
    one launch of the variant a rank, the result within 1e-2 of the
    plain blockwise version over the whole sequence."""
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention

    T = 512
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((T, w), np.float32).astype(np.float16)
               for w in (Hq * Dh, Hkv * Dh, Hkv * Dv))
    rt = HDArrayRuntime(4)
    arrs = [rt.create(n, a.shape, np.float16)
            for n, a in (("Q", q), ("K", k), ("V", v))]
    arrs.append(rt.create("O", (T, Hq * Dv), np.float16))
    part = rt.partition_row(q.shape)
    rt.write(arrs[0], q, part)
    rt.write_replicated(arrs[1], k)
    rt.write_replicated(arrs[2], v)
    rt.write(arrs[3], np.zeros((T, Hq * Dv), np.float16),
             rt.partition_row((T, Hq * Dv)))
    fn = flash_kernel.flash_attention_cuda
    n0, v0 = fn.launches, fn.by_variant[variant]
    rt.apply_kernel("flash", part, make_flash_kernel(
        heads=Hq, dim=Dh, kv_heads=Hkv, out_dim=Dv), arrs,
        uses={"Q": ROW_ALL, "K": ALL_2D, "V": ALL_2D}, defs={"O": ROW_ALL})
    assert (fn.launches - n0, fn.by_variant[variant] - v0) == (4, 4)
    got = torch.from_numpy(rt.read_coherent(arrs[3])).to(cuda).float()
    qt, kt, vt = (torch.from_numpy(a).to(cuda) for a in (q, k, v))
    want = blockwise_attention(
        qt.view(1, T, Hq, Dh), kt.view(1, T, Hkv, Dh), vt.view(1, T, Hkv, Dv),
        qpos=torch.arange(T, dtype=torch.int32, device=cuda)[None],
        window=None).view(T, Hq * Dv).float()
    assert torch.all((got - want).abs() <= 1e-2 * (1 + want.abs()))
    rt.close()
