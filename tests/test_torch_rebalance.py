"""Measured rebalancing in the port (``repro_torch.ft.rebalance`` and
``run_pipeline(rebalance=)``) against the reference's, on the CPU, in
the style of tests/test_hetero.py.

Rank 0 is made slow with the Sim oracle's ``rank_cost`` model (busy
time per work item), set alike in both packages; the port's torch
backend applies the same model to its per-rank host timing on the
CPU.  The host clock is replaced by a counter that advances 2**-20 s
per read, so every measured time is exact and both packages see the
same series: the rebalance must fire at the same step, onto the same
weights, with the same migration bytes, records and ``comm_log``, and
the values must stay bit-identical to the fault-free run.
"""
import tempfile
import time

import numpy as np
import pytest

import repro.core as ref
import repro.executors as ref_ex
import repro_torch.core as port
import repro_torch.executors as port_ex
from repro.ckpt.checkpoint import CheckpointManager as RefCM
from repro.ft import faults as ref_ft
from repro.ft import rebalance as ref_rb
from repro_torch.ckpt import CheckpointManager as PortCM
from repro_torch.ft import faults as port_ft
from repro_torch.ft import rebalance as port_rb

N, NPROC = 16, 4
RANK_COST = {0: 4e-5, 1: 1e-5, 2: 1e-5, 3: 1e-5}
MODS = {"ref": (ref, ref_ex, ref_ft, ref_rb, RefCM),
        "port": (port, port_ex, port_ft, port_rb, PortCM)}


@pytest.fixture
def exact_clock(monkeypatch):
    """A host clock that advances 2**-20 s at every read."""
    now = [0.0]

    def tick():
        now[0] += 2.0 ** -20
        return now[0]

    monkeypatch.setattr(time, "perf_counter", tick)


def _kernels(ex):
    @ex.device_kernel
    def jac(region, bufs):
        (i0, i1), (j0, j1) = region.bounds
        a = bufs["a"]
        new = 0.25 * (a[i0 - 1:i1 - 1, j0:j1] + a[i0 + 1:i1 + 1, j0:j1]
                      + a[i0:i1, j0 - 1:j1 - 1] + a[i0:i1, j0 + 1:j1 + 1])
        return {"b": ex.kernel_put(bufs["b"],
                                   (slice(i0, i1), slice(j0, j1)), new)}

    @ex.device_kernel
    def cp(region, bufs):
        sl = region.to_slices()
        return {"a": ex.kernel_put(bufs["a"], sl, bufs["b"][sl])}

    return jac, cp


_KERNELS = {name: _kernels(m[1]) for name, m in MODS.items()}


def _runtime(name, backend):
    mod = MODS[name][0]
    if backend == "torch":
        return mod.HDArrayRuntime(NPROC, backend="torch", device="cpu")
    return mod.HDArrayRuntime(NPROC, backend=backend)


def _pipeline(name, rt, reps=12):
    mod = MODS[name][0]
    jac, cp = _KERNELS[name]
    fp = mod.AccessSpec.of((0, -1), (0, 1), (-1, 0), (1, 0), (0, 0))
    ident = mod.AccessSpec.of((0, 0))
    a, b = rt.create("a", (N, N)), rt.create("b", (N, N))
    pd = rt.partition_row((N, N))
    pw = rt.partition_row((N, N), region=mod.Box.make((1, N - 1), (1, N - 1)))
    data = np.random.default_rng(0).standard_normal((N, N)).astype(np.float32)
    rt.write(a, data, pd)
    rt.write(b, data, pd)
    steps = []
    for _ in range(reps):
        steps.append(dict(kernel_name="jac", part_id=pw, kernel=jac,
                          arrays=[a, b], uses={"a": fp}, defs={"b": ident}))
        steps.append(dict(kernel_name="cp", part_id=pw, kernel=cp,
                          arrays=[a, b], uses={"b": ident}, defs={"a": ident}))
    return a, pd, steps


def _fault_free(reps=12):
    rt = _runtime("ref", "sim")
    a, _pd, steps = _pipeline("ref", rt, reps)
    rt.run_pipeline(steps)
    return rt.read_coherent(a)


def _records(rt):
    return [{k: v for k, v in r.items() if k != "plan"}
            for r in rt.recovery_log]


def _run(name, backend, threshold=1.5):
    _mod, _ex, _ft, rb, _cm = MODS[name]
    rt = _runtime(name, backend)
    a, pd, steps = _pipeline(name, rt)
    rt.executor.rank_cost = dict(RANK_COST)
    reb = rb.Rebalancer(threshold=threshold, patience=3, min_duration=1e-4,
                        data_parts={"a": pd, "b": pd})
    plans = rt.run_pipeline(steps, rebalance=reb)
    return (rt.read_coherent(a), rt, reb, [p.cached for p in plans],
            steps)


@pytest.mark.parametrize("backend", ["sim", "torch"])
@pytest.mark.parametrize("threshold", [1.5, 1.3])
def test_rebalance_matches_reference(exact_clock, backend, threshold):
    want, rrt, rreb, rcached, rsteps = _run("ref", "sim", threshold)
    got, prt, preb, pcached, psteps = _run("port", backend, threshold)
    assert prt.planner.stats.rebalances == rrt.planner.stats.rebalances >= 1
    recs = _records(prt)
    assert recs == _records(rrt)                  # step, weights, bytes
    assert recs[0]["weights"][0] == min(recs[0]["weights"])
    assert prt.comm_log == rrt.comm_log
    # the torch backend captures the balanced steady cycle once the
    # rebalancer allows it (the reference's Sim declines capture, its
    # jax backend captures): its captured steps are not timed
    times, want_times = (prt.planner.stats.rank_step_times,
                         rrt.planner.stats.rank_step_times)
    captured = prt.planner.stats.scan_captures
    assert captured == (backend == "torch")
    want_at = dict(want_times)
    assert all(want_at[step] == t for step, t in times)
    assert len(times) < len(want_times) if captured else times == want_times
    want_at = dict(rreb.history)
    assert all(want_at[step] == t for step, t in preb.history)
    assert pcached == rcached                     # caches bust and rewarm
    if not captured:
        assert preb.speed_ewma == rreb.speed_ewma
    assert preb.data_parts == rreb.data_parts
    # the caller's step dicts survive; the rewritten copies were used
    assert [s["part_id"] for s in psteps] == [s["part_id"] for s in rsteps]
    assert np.array_equal(got, want)
    assert np.array_equal(got, _fault_free())


@pytest.mark.parametrize("backend", ["sim", "torch"])
def test_rebalance_in_recovery_pipeline_matches_reference(exact_clock,
                                                          backend):
    out = {}
    for name, be in (("ref", "sim"), ("port", backend)):
        _mod, _ex, ft, rb, cm = MODS[name]
        with tempfile.TemporaryDirectory() as d:
            rt = _runtime(name, be)
            a, pd, steps = _pipeline(name, rt)
            rt.executor.rank_cost = dict(RANK_COST)
            pol = ft.RecoveryPolicy(
                checkpoint=cm(d), interval=4,
                injector=ft.FaultInjector([5]),
                data_parts={"a": pd, "b": pd},
                clock=time.perf_counter,          # the exact clock
                monitor=ft.StragglerMonitor(min_duration=1e-4),
                rebalancer=rb.Rebalancer(threshold=1.5, patience=3,
                                         min_duration=1e-4))
            rt.run_pipeline(steps, recovery=pol)
            out[name] = (rt.read_coherent(a), _records(rt), rt.comm_log,
                         {k: getattr(rt.planner.stats, k) for k in
                          ("recoveries", "rebalances", "straggler_events",
                           "checkpoint_restores", "steps_replayed")},
                         pol.rebalancer.data_parts is pol.data_parts,
                         dict(pol.data_parts),
                         [(e.step, e.rank) for e in pol.monitor.events])
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][3]["rebalances"] >= 1 and out["port"][4]
    assert np.array_equal(out["port"][0], out["ref"][0])
    assert np.array_equal(out["port"][0], _fault_free())


def _reweighted(name):
    mod, _ex, _ft, rb, _cm = MODS[name]
    rt = mod.HDArrayRuntime(NPROC, backend="null")
    dom, region = (24, 20), mod.Box.make((1, 23), (2, 19))
    pids = [rt.partition_row(dom, region=region),
            rt.partition_col(dom, region=region, weights=(1, 1, 2, 1)),
            rt.partition_block(dom, grid=(2, 2), region=region),
            rt.partition_block(dom, grid=(4, 1), region=region)]
    out = []
    for pid in pids:
        new = rb.reweighted_partition(rt, pid, (0.4, 0.1, 0.3, 0.2))
        part = rt.parts[new]
        out.append(([r.bounds for r in part.regions], part.ptype.value,
                    tuple(part.weights)))
    out.append([rb._infer_grid(rt.parts[p]) for p in pids[2:]])
    manual = rt.partition_manual(dom, list(rt.parts[pids[0]].regions))
    with pytest.raises(ValueError, match="cannot reweight"):
        rb.reweighted_partition(rt, manual, (0.25,) * 4)
    return out


def test_reweighted_partition_matches_reference():
    assert _reweighted("port") == _reweighted("ref")


def _drive_rebalancer(rb):
    """One Rebalancer through a seeded series: a slow rank, the
    cooldown, the max-rebalance cap, unmeasured steps and a mesh
    change."""
    rng = np.random.default_rng(8)
    reb = rb.Rebalancer(threshold=1.4, patience=2, cooldown=2,
                        max_rebalances=2, min_weight=0.1,
                        min_duration=1e-4)
    out = []
    volumes = (40, 40, 40, 40)
    for step in range(40):
        times = rng.uniform(0.9e-3, 1.1e-3, 4)
        if 5 <= step < 30:
            times[1] *= 2.2
        rank_times = None if step % 9 == 0 else tuple(map(float, times))
        fire = reb.observe(step, rank_times, volumes)
        out.append((fire, reb.allow_capture()))
        if fire:
            out.append(reb.target_weights(4))
            reb.note_rebalanced(step)
        if step == 33:
            reb.note_mesh_changed()
    return out, reb.history, reb.speed_ewma, reb.rebalances


def test_rebalancer_decisions_match_reference():
    assert _drive_rebalancer(port_rb) == _drive_rebalancer(ref_rb)


class _NeverBalanced(port_rb.Rebalancer):
    def allow_capture(self) -> bool:
        return False


def test_allow_capture_gates_cycle_capture(exact_clock):
    """The serial path offers the steady cycle for capture only once the
    rebalancer says the mesh looks balanced: a balanced mesh (rank times
    under ``min_duration``) captures the cycle after ``patience``
    steps, a rebalancer that never allows it captures nothing, and the
    values are the same."""
    results = {}
    for label, reb_cls in (("allowed", port_rb.Rebalancer),
                           ("gated", _NeverBalanced)):
        rt = _runtime("port", "torch")
        a, pd, steps = _pipeline("port", rt)
        reb = reb_cls(data_parts={"a": pd, "b": pd})
        rt.run_pipeline(steps, rebalance=reb)
        results[label] = (rt.read_coherent(a), rt.planner.stats.scan_captures,
                          rt.planner.stats.rebalances, rt.comm_log)
        # timed steps run unfused: per-rank times reached the rebalancer
        assert rt.planner.stats.fused_steps == 0 and reb.history
        assert rt.executor.time_ranks is False    # switched off after
    assert results["allowed"][1] == 1 and results["gated"][1] == 0
    assert results["allowed"][2] == results["gated"][2] == 0
    assert np.array_equal(results["allowed"][0], results["gated"][0])
    assert np.array_equal(results["allowed"][0], _fault_free())
    assert results["allowed"][3] == results["gated"][3]
