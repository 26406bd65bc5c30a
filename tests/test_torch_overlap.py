"""The port's §4.2 overlap schedule (``executors/overlap.py``) on the
CPU, against the reference.

* ``halo_split`` returns the reference's interior/boundary boxes (and
  None where the reference gives None) on the plans of seeded programs,
  including the offset-work-partition Jacobi idiom, where halos reach
  deeper than the stencil radius;
* ``HDArrayRuntime(overlap=True)`` on the port's torch backend
  (``device="cpu"``) and on its Sim is bit-identical to the reference's
  serial Sim, with an equal ``comm_log`` (the port of
  ``tests/test_executors.py``'s overlap tests);
* device kernels under overlap stay resident, and the comm thread's
  exceptions surface.
"""
import numpy as np
import pytest

import repro.core as ref
import repro.executors as ref_ex
import repro_torch.core as port
import repro_torch.executors as port_ex

BACKENDS = ("torch", "sim")


def _rt(mod, nproc, backend="sim", overlap=False):
    if mod is port and backend == "torch":
        return port.HDArrayRuntime(nproc, backend="torch", device="cpu",
                                   overlap=overlap)
    return mod.HDArrayRuntime(nproc, backend=backend, overlap=overlap)


# ----------------------------------------------------------------------
# programs of tests/test_executors.py (host kernels, numpy semantics)
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

    for _ in range(iters):
        rt.apply_kernel("gemm", part, k, [hA, hB, hC],
                        uses={"a": mod.ROW_ALL, "b": mod.COL_ALL},
                        defs={"c": mod.IDENTITY_2D})
    return rt.read(hC, part)


def _jacobi(mod, rt, n=32, iters=4):
    rng = np.random.default_rng(2)
    B0 = rng.normal(size=(n, n)).astype(np.float32)
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=mod.Box.make((1, n - 1), (1, n - 1)))
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

    for _ in range(iters):
        rt.apply_kernel("jac", pw, jac, [hA, hB], uses={"B": fp},
                        defs={"A": mod.IDENTITY_2D})
        rt.apply_kernel("copy", pw, cp, [hA, hB], uses={"A": mod.IDENTITY_2D},
                        defs={"B": mod.IDENTITY_2D})
    return rt.read_coherent(hB)


def _repartition(mod, rt, n=24):
    X = np.arange(n * n, dtype=np.float32).reshape(n, n)
    p_row = rt.partition_row((n, n))
    p_col = rt.partition_col((n, n))
    p_blk = rt.partition_block((n, n))
    h = rt.create("x", (n, n))
    rt.write(h, X, p_row)
    rt.repartition(h, p_row, p_col)
    rt.repartition(h, p_col, p_blk)
    rt.repartition(h, p_blk, p_row)
    return rt.read(h, p_row)


PROGRAMS = {"gemm": _gemm, "jacobi": _jacobi, "repartition": _repartition}


# ----------------------------------------------------------------------
# halo_split against the reference's
# ----------------------------------------------------------------------
def _split_bounds(split):
    if split is None:
        return None
    return tuple(tuple(tuple(b.bounds for b in boxes) for boxes in half)
                 for half in split)


def _stencil_steps(mod, layout, n, nproc):
    """(name, part, arrays, uses, defs) of a two-array ping-pong stencil
    over an interior work partition laid out by ``layout``."""
    rt = mod.HDArrayRuntime(nproc, backend="null")
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    interior = mod.Box.make((1, n - 1), (1, n - 1))
    new = getattr(rt, f"partition_{layout}")
    pd = new((n, n))
    pw = new((n, n), region=interior)
    rt.write(A, np.zeros((n, n), np.float32), pd)
    rt.write(B, np.zeros((n, n), np.float32), pd)
    fp = mod.AccessSpec.of((0, -1), (0, 1), (-1, 0), (1, 0), (0, 0))
    wide = mod.AccessSpec.of((0, 0), (2, 0), (-2, 0), (0, 2), (0, -2))
    steps = []
    for i in range(4):
        use = fp if i < 2 else wide
        if i % 2 == 0:
            steps.append(("ab", pw, [A, B], {"A": use},
                          {"B": mod.IDENTITY_2D}))
        else:
            steps.append(("ba", pw, [A, B], {"B": use},
                          {"A": mod.IDENTITY_2D}))
    # a step that defines the array it reads, and a whole-row use
    steps.append(("inplace", pw, [A], {"A": fp}, {"A": mod.IDENTITY_2D}))
    steps.append(("rows", pw, [A, B], {"A": mod.ROW_ALL},
                  {"B": mod.IDENTITY_2D}))
    return rt, steps


def _splits(mod, ex_mod, layout, n, nproc):
    rt, steps = _stencil_steps(mod, layout, n, nproc)
    out = []
    for name, pid, arrays, uses, defs in steps:
        part = rt.parts[pid]
        plan = rt.planner.plan(name, part, arrays, uses, defs)
        out.append(_split_bounds(ex_mod.halo_split(plan, part.regions,
                                                   uses, defs)))
        rt.planner.commit(plan, arrays, part)
    return out


@pytest.mark.parametrize("nproc", [3, 4, 8])
@pytest.mark.parametrize("layout", ["row", "col", "block"])
def test_halo_split_matches_reference(layout, nproc):
    got = _splits(port, port_ex, layout, 24, nproc)
    want = _splits(ref, ref_ex, layout, 24, nproc)
    assert got == want
    assert any(s is not None for s in got)          # the split engages


def test_halo_split_reaches_past_the_radius_on_offset_partitions():
    """Row partition of the data over [0, n), work over [1, n-1): rank
    0's work band ends one row before its data band, so the halo it
    receives from rank 1 lands two rows past its last work row's
    neighbour — the boundary strip is deeper than the stencil radius."""
    n, nproc = 24, 4
    rt, steps = _stencil_steps(port, "row", n, nproc)
    name, pid, arrays, uses, defs = steps[0]
    part = rt.parts[pid]
    rt.planner.commit(rt.planner.plan(name, part, arrays, uses, defs),
                      arrays, part)
    name, pid, arrays, uses, defs = steps[1]
    plan = rt.planner.plan(name, part, arrays, uses, defs)
    interior, boundary = port_ex.halo_split(plan, part.regions, uses, defs)
    for q, region in enumerate(part.regions):
        got = port.SectionSet(interior[q]).union(port.SectionSet(boundary[q]))
        assert got == port.SectionSet.of(region)      # a partition of it
        assert port.SectionSet(interior[q]).intersect(
            port.SectionSet(boundary[q])).is_empty()
    (r0, r1), _ = part.regions[1].bounds
    rows = sorted({r for b in boundary[1] for r in range(*b.bounds[0])})
    assert rows[0] == r0 and rows[-1] == r1 - 1


# ----------------------------------------------------------------------
# overlap schedule vs the serial oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_overlap_preserves_serial_oracle(program, backend):
    nproc = 4
    run = PROGRAMS[program]
    rt_ref = _rt(ref, nproc)
    want = run(ref, rt_ref)
    rt = _rt(port, nproc, backend, overlap=True)
    got = run(port, rt)
    np.testing.assert_array_equal(got, want)
    assert rt.comm_log == rt_ref.comm_log
    assert rt._scheduler.steps_overlapped > 0
    assert rt.planner.stats.python_dispatches_per_step == 2.0
    rt.close()
    assert rt._scheduler._pool._shutdown


@pytest.mark.parametrize("backend", BACKENDS)
def test_overlap_halo_split_engages_on_stencil(backend):
    rt = _rt(port, 4, backend, overlap=True)
    _jacobi(port, rt)
    assert rt._scheduler.halo_splits > 0
    rt_ref = _rt(ref, 4, overlap=True)
    _jacobi(ref, rt_ref)
    assert rt._scheduler.halo_splits == rt_ref._scheduler.halo_splits


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_matches_sequential(backend):
    """run_pipeline (next-step planning overlapped with comm) is
    bit-identical to the sequential schedule and hits the §4.2 plan
    cache the same way."""
    n, nproc, iters = 16, 4, 3
    rng = np.random.default_rng(1)
    A, B = (rng.normal(size=(n, n)).astype(np.float32) for _ in range(2))

    def build(mod, backend, overlap):
        rt = _rt(mod, nproc, backend, overlap=overlap)
        part = rt.partition_row((n, n))
        ha, hb, hc = (rt.create(s, (n, n)) for s in "abc")
        rt.write(ha, A, part)
        rt.write(hb, B, part)
        rt.write(hc, np.zeros((n, n), np.float32), part)

        def k(region, bufs):
            rows = region.to_slices()[0]
            bufs["c"][rows, :] = bufs["a"][rows, :] @ bufs["b"]

        steps = [dict(kernel_name="mm", part_id=part, kernel=k,
                      arrays=[ha, hb, hc],
                      uses={"a": mod.ROW_ALL, "b": mod.COL_ALL},
                      defs={"c": mod.IDENTITY_2D})
                 for _ in range(iters)]
        plans = rt.run_pipeline(steps)
        return rt.read(hc, part), plans, rt.comm_log

    c0, plans0, log0 = build(ref, "sim", False)
    c1, plans1, log1 = build(port, backend, True)
    np.testing.assert_array_equal(c1, c0)
    assert [p.cached for p in plans1] == [p.cached for p in plans0]
    assert sum(p.cached for p in plans1) == iters - 1
    assert log1 == log0


# ----------------------------------------------------------------------
# device kernels under overlap (the resident path)
# ----------------------------------------------------------------------
FP_SPEC = ((0, -1), (0, 1), (-1, 0), (1, 0), (0, 0))


def _device_pair(ex):
    @ex.device_kernel
    def jac(region, bufs):
        (r0, r1), (c0, c1) = region.bounds
        Bv = bufs["B"]
        new = (Bv[r0:r1, c0 - 1:c1 - 1] + Bv[r0:r1, c0 + 1:c1 + 1]
               + Bv[r0 - 1:r1 - 1, c0:c1] + Bv[r0 + 1:r1 + 1, c0:c1]) / 4
        return {"A": ex.kernel_put(bufs["A"], (slice(r0, r1), slice(c0, c1)),
                                   new)}

    @ex.device_kernel
    def cp(region, bufs):
        sl = region.to_slices()
        return {"B": ex.kernel_put(bufs["B"], sl, bufs["A"][sl])}

    return jac, cp


def _jacobi_device(mod, ex, rt, n=32, iters=3, pipeline=False):
    jac, cp = _device_pair(ex)
    rng = np.random.default_rng(7)
    B0 = rng.normal(size=(n, n)).astype(np.float32)
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=mod.Box.make((1, n - 1), (1, n - 1)))
    hA, hB = rt.create("A", (n, n)), rt.create("B", (n, n))
    rt.write(hA, B0, pd)
    rt.write(hB, B0, pd)
    fp = mod.AccessSpec.of(*FP_SPEC)
    steps = []
    for _ in range(iters):
        steps.append(dict(kernel_name="jac", part_id=pw, kernel=jac,
                          arrays=[hA, hB], uses={"B": fp},
                          defs={"A": mod.IDENTITY_2D}))
        steps.append(dict(kernel_name="copy", part_id=pw, kernel=cp,
                          arrays=[hA, hB], uses={"A": mod.IDENTITY_2D},
                          defs={"B": mod.IDENTITY_2D}))
    if pipeline:
        rt.run_pipeline(steps)
    else:
        for st in steps:
            rt.apply_kernel(st["kernel_name"], st["part_id"], st["kernel"],
                            st["arrays"], st["uses"], st["defs"])
    return hB


@pytest.mark.parametrize("pipeline", [False, True])
def test_overlap_device_kernels_stay_resident(pipeline):
    rt_ref = _rt(ref, 4)
    want = rt_ref.read_coherent(_jacobi_device(ref, ref_ex, rt_ref,
                                               pipeline=pipeline))
    rt = _rt(port, 4, "torch", overlap=True)
    hB = _jacobi_device(port, port_ex, rt, pipeline=pipeline)
    ex = rt.executor
    assert (ex.h2d_transfers, ex.d2h_transfers) == (2, 0)
    # one launch per kernel dispatch: a split step dispatches its
    # interior and boundary rounds separately
    sched = rt._scheduler
    assert ex.device_kernel_launches == 6 if pipeline else \
        ex.device_kernel_launches > 6
    got = rt.read_coherent(hB)
    assert ex.d2h_transfers == 1
    np.testing.assert_array_equal(got, want)
    assert rt.comm_log == rt_ref.comm_log
    assert sched.steps_overlapped == 6
    # the jac steps receive halos: apply_kernel splits them, the
    # pipeline path never splits (as in the reference)
    assert sched.halo_splits == (0 if pipeline else 3)
    # overlap is two host dispatches per step; nothing fused
    assert rt.planner.stats.fused_steps == 0


def test_comm_thread_exceptions_surface():
    rt = _rt(port, 4, "sim", overlap=True)
    n = 16
    part = rt.partition_row((n, n))
    ha, hb = rt.create("a", (n, n)), rt.create("b", (n, n))
    rt.write(ha, np.ones((n, n), np.float32), part)

    def boom(plan, arrays_by_name):
        raise RuntimeError("comm thread failed")

    rt.executor.execute_plan = boom
    with pytest.raises(RuntimeError, match="comm thread failed"):
        rt.apply_kernel("cp", part, lambda r, b: None, [ha, hb],
                        uses={"a": port.ROW_ALL}, defs={"b": port.IDENTITY_2D})
    with pytest.raises(RuntimeError, match="comm thread failed"):
        rt.run_pipeline([dict(kernel_name="cp", part_id=part, kernel=None,
                              arrays=[ha, hb], uses={"a": port.ROW_ALL},
                              defs={"b": port.IDENTITY_2D})])
    rt.close()


def test_no_comm_fence_off_the_card():
    ex = port_ex.TorchExecutor(nproc=2, device="cpu")
    assert ex.comm_fence(None, {}) is None
    assert getattr(port_ex.SimExecutor(), "comm_fence", None) is None


def _mixed(mod, ex, rt, n=32, iters=8):
    """Jacobi whose stencil step is a host kernel and whose copy step
    is a device kernel: each stencil step reads, on the host, an array
    the device defined last and the comm thread is copying halos into."""
    _jac, cp = _device_pair(ex)
    rng = np.random.default_rng(11)
    B0 = rng.normal(size=(n, n)).astype(np.float32)
    pd = rt.partition_row((n, n))
    pw = rt.partition_row((n, n), region=mod.Box.make((1, n - 1), (1, n - 1)))
    hA, hB = rt.create("A", (n, n)), rt.create("B", (n, n))
    rt.write(hA, B0, pd)
    rt.write(hB, B0, pd)
    fp = mod.AccessSpec.of(*FP_SPEC)

    def jac(region, bufs):
        (r0, r1), (c0, c1) = region.bounds
        Bv = bufs["B"]
        bufs["A"][r0:r1, c0:c1] = (
            Bv[r0:r1, c0 - 1:c1 - 1] + Bv[r0:r1, c0 + 1:c1 + 1]
            + Bv[r0 - 1:r1 - 1, c0:c1] + Bv[r0 + 1:r1 + 1, c0:c1]) / 4

    for _ in range(iters):
        rt.apply_kernel("jac", pw, jac, [hA, hB], uses={"B": fp},
                        defs={"A": mod.IDENTITY_2D})
        rt.apply_kernel("copy", pw, cp, [hA, hB], uses={"A": mod.IDENTITY_2D},
                        defs={"B": mod.IDENTITY_2D})
    return rt.read_coherent(hB)


def test_residency_flags_hold_under_thread_switching():
    """Host kernels download mirrors on the host thread while the comm
    thread copies into the same array and marks its mirrors stale; the
    interpreter switches threads every microsecond.  A mirror
    downloaded mid-copy and then marked current would change the
    result."""
    import sys

    want = _mixed(ref, ref_ex, _rt(ref, 8), n=256, iters=20)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rt = _rt(port, 8, "torch", overlap=True)
        got = _mixed(port, port_ex, rt, n=256, iters=20)
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(got, want)
    assert rt._scheduler.halo_splits > 0
    rt.close()


def test_mirror_download_waits_for_copies_in_flight():
    """A mirror download on the host thread waits for the comm thread's
    copies into the same array, so a mirror is never taken mid-copy and
    then marked current."""
    import threading

    from repro_torch.core.hdarray import HDArray

    ex = port_ex.TorchExecutor(nproc=2, device="cpu")
    arr = HDArray("x", (4, 4), np.float32, 2)
    ex.allocate(arr)
    ex._device["x"][0].fill_(1.0)
    started, release, done = (threading.Event() for _ in range(3))
    copy = ex._copy

    def held_copy(groups):
        started.set()
        release.wait(10)
        copy(groups)

    ex._copy = held_copy
    msgs = {(0, 1): port.SectionSet.of(port.Box.make((0, 2), (0, 4)))}
    comm = threading.Thread(target=ex.execute_messages, args=(arr, msgs))
    host = threading.Thread(target=lambda: (ex.sync_host(arr), done.set()))
    comm.start()
    assert started.wait(10)
    host.start()
    assert not done.wait(0.2)          # held behind the copies
    release.set()
    comm.join(10)
    host.join(10)
    assert not comm.is_alive() and not host.is_alive() and done.is_set()
    np.testing.assert_array_equal(ex.buffers["x"][1][:2], np.ones((2, 4)))
    np.testing.assert_array_equal(ex.buffers["x"][1][2:], np.zeros((2, 4)))
    assert ex.d2h_transfers == 1
