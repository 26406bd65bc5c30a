"""One-program steps and captured steady-state pipelines in the port,
on the CPU, against the reference.

The reference's ``backend="jax"`` runs a device-kernel step as ONE
jitted program (``PlannerStats.fused_steps``) and a steady pipeline
cycle as ONE ``lax.scan`` (``scan_captures``, zero host dispatches per
step).  The port's torch backend does the same with CUDA graphs on a
card and issues the same copies and sweeps eagerly on the CPU, so on
``device="cpu"`` its ``PlannerStats``, transfer counters and
``comm_log`` must equal the reference jax run of the same program
(8 host devices, as ``tests/test_capture.py``), and its values the
reference's Sim oracle, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro.core.planner as ref_planner
import repro.executors as ref_ex
import repro.kernels.hd as ref_hd
import repro_torch.core as port
import repro_torch.core.planner as port_planner
import repro_torch.executors as port_ex
import repro_torch.kernels.hd as port_hd

_STATS = ("plans_computed", "hits_history", "hits_state_compare",
          "commit_replays", "fused_steps", "scan_captures",
          "python_dispatches_per_step")


def _need_devices(n):
    import jax
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} host devices (XLA_FLAGS not applied?)")


def _jacobi_kernels(ex):
    """The ping-pong pair of tests/test_capture.py, marked with ``ex``'s
    device_kernel and written with its kernel_put."""
    def make(src, dst):
        @ex.device_kernel
        def jac(region, bufs):
            (r0, r1), (c0, c1) = region.bounds
            x = bufs[src]
            sw = (x[r0:r1, c0 - 1:c1 - 1] + x[r0:r1, c0 + 1:c1 + 1]
                  + x[r0 - 1:r1 - 1, c0:c1] + x[r0 + 1:r1 + 1, c0:c1]) * 0.25
            return {dst: ex.kernel_put(bufs[dst],
                                       (slice(r0, r1), slice(c0, c1)), sw)}
        return jac
    return make("A", "B"), make("B", "A")


_KERNELS = {ref: _jacobi_kernels(ref_ex), port: _jacobi_kernels(port_ex)}


def _runtime(mod, nproc, backend):
    if mod is port and backend == "torch":
        return port.HDArrayRuntime(nproc, backend="torch", device="cpu")
    return mod.HDArrayRuntime(nproc, backend=backend)


def _jacobi_pipeline(mod, rt, n=48, steps=20, kernels=None):
    """Ping-pong Jacobi: the canonical period-2 steady-state pipeline."""
    kernels = kernels or _KERNELS[mod]
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    pw = rt.partition_row((n, n), region=mod.Box.make((1, n - 1), (1, n - 1)))
    pd = rt.partition_row((n, n))
    init = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    fp = mod.AccessSpec.of((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))
    ident = mod.AccessSpec.of((0, 0))
    prog = []
    for i in range(steps):
        if i % 2 == 0:
            prog.append(dict(kernel_name="jab", part_id=pw,
                             kernel=kernels[0], arrays=[A, B],
                             uses={"A": fp}, defs={"B": ident}))
        else:
            prog.append(dict(kernel_name="jba", part_id=pw,
                             kernel=kernels[1], arrays=[A, B],
                             uses={"B": fp}, defs={"A": ident}))
    rt.run_pipeline(prog)
    return rt.read_coherent(A), rt.read_coherent(B), list(rt.comm_log)


def _stats(rt):
    st = rt.planner.stats
    return {k: getattr(st, k) for k in _STATS}


def test_planner_stats_fields_match_reference():
    names = [f.name for f in dataclasses.fields(port_planner.PlannerStats)]
    assert names == [f.name
                     for f in dataclasses.fields(ref_planner.PlannerStats)]
    st = port_planner.PlannerStats(fused_steps=3, scan_captures=2, rebalances=1)
    st.reset()
    assert (st.fused_steps, st.scan_captures, st.rebalances) == (0, 0, 0)


def test_fused_steps_counter_and_dispatch_gauge():
    _need_devices(4)
    rt_ref = _runtime(ref, 4, "jax")
    _jacobi_pipeline(ref, rt_ref, steps=4)
    rt = _runtime(port, 4, "torch")
    _jacobi_pipeline(port, rt, steps=4)
    st = rt.planner.stats
    # every step fused copies + kernel into one program, and 4 steps
    # end before a capture window can open
    assert st.fused_steps == 4 and st.scan_captures == 0
    assert st.python_dispatches_per_step == 1.0
    assert _stats(rt) == _stats(rt_ref)
    rt.close()
    rt_ref.close()


@pytest.mark.parametrize("backend", ["sim", "null"])
def test_host_backends_never_capture(backend):
    def run(mod):
        rt = _runtime(mod, 4, backend)
        A, B = rt.create("A", (32, 32)), rt.create("B", (32, 32))
        pw = rt.partition_row((32, 32), region=mod.Box.make((1, 31), (1, 31)))
        fp = mod.AccessSpec.of((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))
        ident = mod.AccessSpec.of((0, 0))
        kern = _KERNELS[mod] if backend == "sim" else (None, None)
        prog = [dict(kernel_name="jab", part_id=pw, kernel=kern[0],
                     arrays=[A, B], uses={"A": fp}, defs={"B": ident})
                if i % 2 == 0 else
                dict(kernel_name="jba", part_id=pw, kernel=kern[1],
                     arrays=[A, B], uses={"B": fp}, defs={"A": ident})
                for i in range(12)]
        plans = rt.run_pipeline(prog)
        assert len(plans) == 12 and all(p is not None for p in plans)
        return _stats(rt), rt.comm_log

    (got, got_log), (want, want_log) = run(port), run(ref)
    assert got == want and got_log == want_log
    assert got["fused_steps"] == got["scan_captures"] == 0
    # unfused step with a kernel: exchange dispatch + kernel dispatch
    assert got["python_dispatches_per_step"] == (2.0 if backend == "sim"
                                                 else 1.0)


@pytest.mark.parametrize("nproc, steps", [(8, 20), (4, 12), (2, 17)])
def test_steady_pipeline_captured_zero_dispatches(nproc, steps):
    _need_devices(nproc)
    rt_sim = _runtime(ref, nproc, "sim")
    a_sim, b_sim, log_sim = _jacobi_pipeline(ref, rt_sim, steps=steps)
    rt_jax = _runtime(ref, nproc, "jax")
    _a, _b, log_jax = _jacobi_pipeline(ref, rt_jax, steps=steps)

    rt = _runtime(port, nproc, "torch")
    ex = rt.executor
    a, b, log = _jacobi_pipeline(port, rt, steps=steps)
    st = rt.planner.stats
    # the steady state was detected and run as >= 1 captured cycle,
    # covering every step after the two-period witness window
    assert st.scan_captures >= 1
    assert st.fused_steps + st.scan_captures < steps
    assert st.python_dispatches_per_step == 0.0
    assert _stats(rt) == _stats(rt_jax)
    # residency held: 2 writes up, 0 down until the 2 reads
    assert (ex.h2d_transfers, ex.d2h_transfers) == (
        rt_jax.executor.h2d_transfers, rt_jax.executor.d2h_transfers) == (2, 2)
    # bit-identical to the unfused oracle, identical comm_log (the
    # captured steps' plans replay through the same §4.2 metadata)
    assert np.array_equal(a, a_sim) and np.array_equal(b, b_sim)
    assert log == log_sim == log_jax
    for r in (rt, rt_sim, rt_jax):
        r.close()


def test_capture_counts_stay_consistent():
    rt = _runtime(port, 8, "torch")
    ex = rt.executor
    _jacobi_pipeline(port, rt, steps=20)
    rt_sim = _runtime(ref, 8, "sim")
    _jacobi_pipeline(ref, rt_sim, steps=20)
    # every step moved its halo bytes, captured or not
    assert ex.bytes_moved == rt_sim.executor.bytes_moved
    assert ex.messages_executed == rt_sim.executor.messages_executed
    assert sum(ex.copy_counts.values()) == ex.messages_executed
    assert ex.copy_counts["halo"] == ex.messages_executed
    # one device kernel per step, captured or fused
    assert ex.device_kernel_launches == 20
    assert ex.last_rank_times is None
    rt.close()
    rt_sim.close()


def test_host_kernel_pipeline_stays_unfused():
    def host_pair(mod):
        def make(src, dst):
            def host_jac(region, bufs):          # unmarked: host mirrors
                (r0, r1), (c0, c1) = region.bounds
                x = bufs[src]
                bufs[dst][r0:r1, c0:c1] = (
                    x[r0:r1, c0 - 1:c1 - 1] + x[r0:r1, c0 + 1:c1 + 1]
                    + x[r0 - 1:r1 - 1, c0:c1] + x[r0 + 1:r1 + 1, c0:c1]) * 0.25
            return host_jac
        return make("A", "B"), make("B", "A")

    a_s, b_s, log_s = _jacobi_pipeline(ref, _runtime(ref, 4, "sim"),
                                       steps=10, kernels=host_pair(ref))
    rt = _runtime(port, 4, "torch")
    a, b, log = _jacobi_pipeline(port, rt, steps=10, kernels=host_pair(port))
    st = rt.planner.stats
    assert st.fused_steps == 0 and st.scan_captures == 0
    assert st.python_dispatches_per_step == 2.0
    assert rt.executor.device_kernel_launches == 0
    assert np.array_equal(a, a_s) and np.array_equal(b, b_s)
    assert log == log_s


def test_unhashable_kw_declines_fusion_and_capture():
    rt = _runtime(port, 4, "torch")

    @port_ex.device_kernel
    def scaled(region, bufs, scale):
        sl = region.to_slices()
        return {"B": port_ex.kernel_put(bufs["B"], sl,
                                        bufs["A"][sl] * scale[0])}

    A, B = rt.create("A", (16, 16)), rt.create("B", (16, 16))
    part = rt.partition_row((16, 16))
    rt.write(A, np.ones((16, 16), np.float32), part)
    step = dict(kernel_name="s", part_id=part, kernel=scaled, arrays=[A, B],
                uses={"A": port.IDENTITY_2D}, defs={"B": port.IDENTITY_2D},
                kw={"scale": [2.0]})
    rt.run_pipeline([step] * 8)
    st = rt.planner.stats
    assert st.fused_steps == 0 and st.scan_captures == 0
    assert np.array_equal(rt.read(B, part), np.full((16, 16), 2.0, np.float32))


def _gemm_program(mod, rt, kernel, n=32, steps=8):
    A, B, C = (rt.create(nm, (n, n)) for nm in ("A", "B", "C"))
    part = rt.partition_row((n, n))
    rng = np.random.default_rng(5)
    rt.write(A, rng.standard_normal((n, n)).astype(np.float32), part)
    rt.write_replicated(B, rng.standard_normal((n, n)).astype(np.float32))
    rt.write(C, np.zeros((n, n), np.float32), part)
    prog = [dict(kernel_name="gemm", part_id=part, kernel=kernel,
                 arrays=[A, B, C], uses={"A": mod.ROW_ALL, "B": mod.COL_ALL},
                 defs={"C": mod.IDENTITY_2D})
            for _ in range(steps)]
    rt.run_pipeline(prog)
    return rt.read_coherent(C), list(rt.comm_log)


def test_hd_gemm_factory_fused_and_captured():
    _need_devices(8)
    rt_jax = _runtime(ref, 8, "jax")
    c_jax, log_jax = _gemm_program(ref, rt_jax,
                                   ref_hd.make_gemm_kernel(impl="pallas"))
    kern = port_hd.make_gemm_kernel()
    c_sim, log_sim = _gemm_program(port, _runtime(port, 8, "sim"), kern)
    rt = _runtime(port, 8, "torch")
    c, log = _gemm_program(port, rt, kern)
    # period-1 steady state: captured after the two-step witness
    assert rt.planner.stats.scan_captures >= 1
    assert rt.planner.stats.python_dispatches_per_step == 0.0
    assert _stats(rt) == _stats(rt_jax)
    assert log == log_sim == log_jax
    # one plain version on both port backends: bit-identical; the two
    # packages' CPU products sum in different orders
    assert np.array_equal(c, c_sim)
    np.testing.assert_allclose(c, c_jax, rtol=2e-4, atol=1e-5)
    assert rt.executor.device_kernel_launches == 8


@pytest.mark.parametrize("steps", [6, 12])
def test_hd_jacobi_factory_bit_identical_to_reference(steps):
    _need_devices(8)
    ref_k = (ref_hd.make_jacobi_kernel("A", "B", impl="pallas"),
             ref_hd.make_jacobi_kernel("B", "A", impl="pallas"))
    port_k = (port_hd.make_jacobi_kernel("A", "B"),
              port_hd.make_jacobi_kernel("B", "A"))
    a_s, b_s, log_s = _jacobi_pipeline(ref, _runtime(ref, 8, "sim"),
                                       steps=steps, kernels=ref_k)
    rt_jax = _runtime(ref, 8, "jax")
    _jacobi_pipeline(ref, rt_jax, steps=steps, kernels=ref_k)
    rt = _runtime(port, 8, "torch")
    a, b, log = _jacobi_pipeline(port, rt, steps=steps, kernels=port_k)
    assert _stats(rt) == _stats(rt_jax)
    assert rt.planner.stats.scan_captures == (steps > 8)
    assert np.array_equal(a, a_s) and np.array_equal(b, b_s)
    assert log == log_s


def test_apply_kernel_loop_fuses_every_step():
    """The serial apply_kernel loop (schedule (a) of chip_smoke.py):
    every step one program, no capture, values as the run_pipeline
    schedule's."""
    kern = (port_hd.make_jacobi_kernel("A", "B"),
            port_hd.make_jacobi_kernel("B", "A"))
    want = _jacobi_pipeline(port, _runtime(port, 4, "torch"), steps=14,
                            kernels=kern)
    rt = _runtime(port, 4, "torch")
    n = 48
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    pw = rt.partition_row((n, n), region=port.Box.make((1, n - 1), (1, n - 1)))
    pd = rt.partition_row((n, n))
    init = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    rt.write(A, init, pd)
    rt.write(B, init, pd)
    fp = port.AccessSpec.of((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))
    for i in range(14):
        src, dst = ("A", "B") if i % 2 == 0 else ("B", "A")
        rt.apply_kernel("jab" if i % 2 == 0 else "jba", pw, kern[i % 2],
                        [A, B], uses={src: fp},
                        defs={dst: port.AccessSpec.of((0, 0))})
    st = rt.planner.stats
    assert st.fused_steps == 14 and st.scan_captures == 0
    assert np.array_equal(rt.read_coherent(A), want[0])
    assert np.array_equal(rt.read_coherent(B), want[1])
    assert rt.comm_log == want[2]
