"""TorchExecutor (on the CPU) against the reference's SimExecutor oracle.

The three programs of test_executors.py cover every CommKind:

  * gemm        -> ALL_GATHER
  * jacobi      -> HALO
  * repartition -> ALL_TO_ALL / P2P

Each runs on the port's ``TorchExecutor(device="cpu")`` and on the
reference's ``SimExecutor``; values must be bit-identical, the kinds
equal and ``bytes_moved`` the planned bytes.  Residency is
counter-verified: a device-kernel pipeline moves no full buffer
between host and device once its arrays are written.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.executors import (SimExecutor, TorchExecutor, device_kernel,
                                   kernel_put, make_executor)


def _rt(mod, nproc):
    if mod is port:
        return port.HDArrayRuntime(nproc, backend="torch", device="cpu")
    return ref.HDArrayRuntime(nproc, backend="sim")


# ----------------------------------------------------------------------
# programs (each runs the same source data on a given runtime)
# ----------------------------------------------------------------------
def _gemm(mod, rt, n=24, iters=2):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)).astype(np.float32)
    B = rng.normal(size=(n, n)).astype(np.float32)
    part = rt.partition_row((n, n))
    hA, hB, hC = (rt.create(s, (n, n)) for s in "abc")
    rt.write(hA, A, part)
    rt.write(hB, B, part)
    rt.write(hC, np.zeros((n, n), np.float32), part)

    def k(region, bufs):
        rows = region.to_slices()[0]
        bufs["c"][rows, :] = bufs["a"][rows, :] @ bufs["b"]

    plans = [rt.apply_kernel("gemm", part, k, [hA, hB, hC],
                             uses={"a": mod.ROW_ALL, "b": mod.COL_ALL},
                             defs={"c": mod.IDENTITY_2D})
             for _ in range(iters)]
    return rt.read(hC, part), plans


def _jacobi(mod, rt, n=32, iters=4):
    rng = np.random.default_rng(2)
    B0 = rng.normal(size=(n, n)).astype(np.float32)
    interior = mod.Box.make((1, n - 1), (1, n - 1))
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=interior)
    hA, hB = rt.create("A", (n, n)), rt.create("B", (n, n))
    rt.write(hA, B0, pd)
    rt.write(hB, B0, pd)
    fp = mod.AccessSpec.of((0, -1), (0, 1), (-1, 0), (1, 0), (0, 0))

    def jac(region, bufs):
        (r0, r1), (c0, c1) = region.bounds
        Bv = bufs["B"]
        bufs["A"][r0:r1, c0:c1] = (
            Bv[r0:r1, c0 - 1:c1 - 1] + Bv[r0:r1, c0 + 1:c1 + 1]
            + Bv[r0 - 1:r1 - 1, c0:c1] + Bv[r0 + 1:r1 + 1, c0:c1]) / 4

    def cp(region, bufs):
        sl = region.to_slices()
        bufs["B"][sl] = bufs["A"][sl]

    plans = []
    for _ in range(iters):
        plans.append(rt.apply_kernel("jac", pw, jac, [hA, hB],
                                     uses={"B": fp},
                                     defs={"A": mod.IDENTITY_2D}))
        plans.append(rt.apply_kernel("copy", pw, cp, [hA, hB],
                                     uses={"A": mod.IDENTITY_2D},
                                     defs={"B": mod.IDENTITY_2D}))
    return rt.read_coherent(hB), plans


def _repartition(mod, rt, n=24):
    X = np.arange(n * n, dtype=np.float32).reshape(n, n)
    p_row = rt.partition_row((n, n))
    p_col = rt.partition_col((n, n))
    p_blk = rt.partition_block((n, n))
    h = rt.create("x", (n, n))
    rt.write(h, X, p_row)
    plans = [rt.repartition(h, p_row, p_col),
             rt.repartition(h, p_col, p_blk),
             rt.repartition(h, p_blk, p_row)]
    return rt.read(h, p_row), plans


PROGRAMS = {"gemm": _gemm, "jacobi": _jacobi, "repartition": _repartition}


def _kinds(plans):
    return {ap.kind.value for p in plans for ap in p.arrays if ap.messages}


@pytest.mark.parametrize("nproc", [2, 4, 8])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_torch_backend_bit_identical_to_reference_sim(program, nproc):
    run = PROGRAMS[program]
    want, plans_s = run(ref, _rt(ref, nproc))
    rt = _rt(port, nproc)
    got, plans_t = run(port, rt)
    np.testing.assert_array_equal(got, want)
    assert _kinds(plans_t) == _kinds(plans_s)
    ex = rt.executor
    assert ex.bytes_moved == sum(p.bytes_total for p in plans_s)
    # every kind the plans used was carried as section copies
    for kind in _kinds(plans_t):
        assert ex.copy_counts[kind] > 0
    assert sum(ex.copy_counts.values()) == ex.messages_executed


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_send_and_recv_boxes_disjoint_per_device(program):
    """The copy schedule applies messages in order; that equals the
    reference's collect-then-apply order because no device ever sends
    a box it also receives in the same plan."""
    for nproc in (2, 4, 8):
        _got, plans = PROGRAMS[program](port, _rt(port, nproc))
        for plan in plans:
            for ap in plan.arrays:
                for p in range(nproc):
                    sent = [m for (s, _d), m in ap.messages.items() if s == p]
                    recv = [m for (_s, d), m in ap.messages.items() if d == p]
                    for a in sent:
                        for b in recv:
                            assert a.intersect(b).is_empty()


# ----------------------------------------------------------------------
# residency
# ----------------------------------------------------------------------
FP_SPEC = ((0, -1), (0, 1), (-1, 0), (1, 0), (0, 0))


@device_kernel
def _jac_t(region, bufs):
    (r0, r1), (c0, c1) = region.bounds
    Bv = bufs["B"]
    new = (Bv[r0:r1, c0 - 1:c1 - 1] + Bv[r0:r1, c0 + 1:c1 + 1]
           + Bv[r0 - 1:r1 - 1, c0:c1] + Bv[r0 + 1:r1 + 1, c0:c1]) / 4
    return {"A": kernel_put(bufs["A"], (slice(r0, r1), slice(c0, c1)), new)}


@device_kernel
def _cp_t(region, bufs):
    sl = region.to_slices()
    return {"B": kernel_put(bufs["B"], sl, bufs["A"][sl])}


def _jacobi_device(mod, rt, jac, cp, n=32, iters=4):
    rng = np.random.default_rng(7)
    B0 = rng.normal(size=(n, n)).astype(np.float32)
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=mod.Box.make((1, n - 1), (1, n - 1)))
    hA, hB = rt.create("A", (n, n)), rt.create("B", (n, n))
    rt.write(hA, B0, pd)
    rt.write(hB, B0, pd)
    fp = mod.AccessSpec.of(*FP_SPEC)
    for _ in range(iters):
        rt.apply_kernel("jac", pw, jac, [hA, hB],
                        uses={"B": fp}, defs={"A": mod.IDENTITY_2D})
        rt.apply_kernel("copy", pw, cp, [hA, hB],
                        uses={"A": mod.IDENTITY_2D},
                        defs={"B": mod.IDENTITY_2D})
    return hB


def _ref_jacobi_device_result():
    from repro.executors import device_kernel as ref_dk, kernel_put as ref_put

    @ref_dk
    def jac(region, bufs):
        (r0, r1), (c0, c1) = region.bounds
        Bv = bufs["B"]
        new = (Bv[r0:r1, c0 - 1:c1 - 1] + Bv[r0:r1, c0 + 1:c1 + 1]
               + Bv[r0 - 1:r1 - 1, c0:c1] + Bv[r0 + 1:r1 + 1, c0:c1]) / 4
        return {"A": ref_put(bufs["A"], (slice(r0, r1), slice(c0, c1)), new)}

    @ref_dk
    def cp(region, bufs):
        sl = region.to_slices()
        return {"B": ref_put(bufs["B"], sl, bufs["A"][sl])}

    rt = _rt(ref, 4)
    return rt.read_coherent(_jacobi_device(ref, rt, jac, cp)), rt.comm_log


def test_residency_round_trip_zero_host_syncs():
    want, want_log = _ref_jacobi_device_result()
    rt = _rt(port, 4)
    hB = _jacobi_device(port, rt, _jac_t, _cp_t)
    ex = rt.executor
    assert ex.h2d_transfers == 2          # the two writes, nothing since
    assert ex.d2h_transfers == 0
    assert ex.device_kernel_launches == 8  # 4x (jac + copy)
    assert ex.last_rank_times is None
    got = rt.read_coherent(hB)             # the ONE materialization
    assert ex.d2h_transfers == 1
    np.testing.assert_array_equal(got, want)
    assert rt.comm_log == want_log


def test_steady_state_transfers_stay_flat():
    rt = _rt(port, 4)
    _jacobi_device(port, rt, _jac_t, _cp_t, iters=2)
    ex = rt.executor
    h2d, d2h = ex.h2d_transfers, ex.d2h_transfers
    arrs = [rt.arrays["A"], rt.arrays["B"]]
    pw = 1  # the interior work partition created by _jacobi_device
    fp = port.AccessSpec.of(*FP_SPEC)
    for _ in range(3):
        rt.apply_kernel("jac", pw, _jac_t, arrs,
                        uses={"B": fp}, defs={"A": port.IDENTITY_2D})
        rt.apply_kernel("copy", pw, _cp_t, arrs,
                        uses={"A": port.IDENTITY_2D},
                        defs={"B": port.IDENTITY_2D})
    assert (ex.h2d_transfers, ex.d2h_transfers) == (h2d, d2h)


def test_host_kernel_fallback_syncs_and_stays_bit_identical():
    """An unmarked numpy kernel runs on the host mirrors: one d2h per
    stale array before it, one h2d of what it defined at the next
    device use, values bit-identical to the reference oracle."""
    got, _ = _jacobi(port, _rt(port, 4), iters=2)
    want, _ = _jacobi(ref, _rt(ref, 4), iters=2)
    np.testing.assert_array_equal(got, want)
    rt = _rt(port, 4)
    _jacobi(port, rt, iters=2)
    ex = rt.executor
    assert ex.device_kernel_launches == 0
    assert ex.d2h_transfers >= 2 and ex.h2d_transfers >= 2


# ----------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("layout", ["row", "col", "block"])
def test_reduce_bit_identical_to_reference(op, layout):
    def run(mod):
        n = 20
        rt = _rt(mod, 4)
        rng = np.random.default_rng(5)
        # values near 1 keep the product finite
        X = (1 + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
        h = rt.create("x", (n, n))
        rt.write(h, X, rt.partition_row((n, n)))
        pid = getattr(rt, f"partition_{layout}")((n, n))
        return rt.reduce(h, op, pid), rt.comm_log[-1]

    (got, got_log), (want, want_log) = run(port), run(ref)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert got_log == want_log


# ----------------------------------------------------------------------
# lifecycle and construction
# ----------------------------------------------------------------------
def test_drop_and_add_rank_match_reference_semantics():
    def run(mod):
        rt = _rt(mod, 4)
        h = rt.create("x", (8, 8))
        rt.write(h, np.arange(64, dtype=np.float32).reshape(8, 8),
                 rt.partition_row((8, 8)))
        rt.executor.drop_rank(h, 1)
        rt.executor.sync_host(h)
        dropped = [np.array(b) for b in rt.executor.buffers["x"]]
        rt.executor.add_rank(h, 2)
        rt.executor.sync_host(h)
        added = [np.array(b) for b in rt.executor.buffers["x"]]
        return dropped, added

    for got, want in zip(run(port), run(ref)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)   # NaN == NaN here


def test_write_replicated_and_read_parity():
    def run(mod):
        rt = _rt(mod, 3)
        h = rt.create("x", (9, 5))
        X = np.arange(45, dtype=np.float32).reshape(9, 5)
        rt.write_replicated(h, X)
        pid = rt.partition_col((9, 5))
        return rt.read(h, pid), rt.read_coherent(h)

    for g, w in zip(run(port), run(ref)):
        np.testing.assert_array_equal(g, w)


def test_backends_and_device_selection():
    assert isinstance(make_executor("sim"), SimExecutor)
    ex = make_executor("torch", nproc=2, device="cpu")
    assert isinstance(ex, TorchExecutor) and ex.device_class == "cpu"
    with pytest.raises(ValueError):
        TorchExecutor(device="meta")
    with pytest.raises(ValueError):
        make_executor("jax")
    if torch.cuda.is_available():
        assert port.HDArrayRuntime(2).executor.device_class == "cuda"
    else:
        # the card is the default: without one the caller must ask for
        # the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.HDArrayRuntime(2)
        with pytest.raises(RuntimeError):
            TorchExecutor()
