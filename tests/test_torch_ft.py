"""The port's fault-tolerance layer (``repro_torch.ft`` with the
recoverable ``run_pipeline``) against the reference's, on the CPU.

* The ``ft.faults`` units: ``FaultInjector`` logs and raised kinds,
  ``StepGuard`` retries, backoff and re-raise, ``StragglerMonitor``
  events on one seeded time series — all equal to the reference's.
* The partition algebra of a mesh change: shrink, inherit, survivor
  and grow partitions of seeded ROW, COL and BLOCK partitions, with
  regions and weights equal to the reference's.
* Seeded Jacobi programs (4 ranks, a 16 x 16 grid, 10 steps of
  [stencil, copy-back]) in the style of tests/test_fault_recovery.py:
  transient faults, rank losses at both sites, a lose-then-rejoin at
  both sites, a weighted loss, two losses, a join onto a mesh born
  smaller, and faults at the commit under the §4.2 overlap schedule.
  The port runs on its Sim oracle and on the torch backend on the CPU;
  the final values must be bit-identical to the reference's Sim run
  and to the fault-free run, and ``comm_log``, ``recovery_log`` (kind,
  rank, restored step, live set, migration bytes) and the
  ``PlannerStats`` fault counters equal to the reference's.
"""
import tempfile

import numpy as np
import pytest

import repro.core as ref
import repro.executors as ref_ex
import repro_torch.core as port
import repro_torch.executors as port_ex
from repro.ckpt.checkpoint import CheckpointManager as RefCM
from repro.ft import faults as ref_ft
from repro_torch.ckpt import CheckpointManager as PortCM
from repro_torch.ft import faults as port_ft

N, NPROC, STEPS = 16, 4, 10
MODS = {"ref": (ref, ref_ex, ref_ft, RefCM),
        "port": (port, port_ex, port_ft, PortCM)}
COUNTERS = ("recoveries", "checkpoint_restores", "elastic_shrinks",
            "elastic_grows", "steps_replayed", "straggler_events")


# ----------------------------------------------------------------------
# ft.faults units
# ----------------------------------------------------------------------
def _drive_injector(ft):
    inj = ft.FaultInjector([3, ft.FaultSpec(5, site="commit", times=2),
                            ft.FaultSpec(7, kind="rank", rank=2),
                            ft.FaultSpec(8, site="commit", kind="join",
                                         rank=1)])
    seen = []
    for step in range(10):
        for site in ("step", "commit", "commit"):
            try:
                inj.maybe_fail(step, site=site)
                seen.append(None)
            except (ft.TransientFault, ft.RankLostFault,
                    ft.RankJoinedEvent) as e:
                seen.append((type(e).__name__, getattr(e, "rank", None),
                             getattr(e, "site", None), str(e)))
    return seen, inj.log, sorted(inj.fired), sorted(inj.fail_at)


def test_fault_injector_matches_reference():
    assert _drive_injector(port_ft) == _drive_injector(ref_ft)


def _drive_guard(ft, fails, max_retries):
    sleeps, restores = [], []

    def restore():
        restores.append(len(restores))
        return 4, "state"

    guard = ft.StepGuard(restore, max_retries=max_retries, backoff=0.5,
                         sleep=sleeps.append)
    left = [fails]

    def step():
        if left[0]:
            left[0] -= 1
            raise ft.TransientFault("injected")
        return "ok"

    out = []
    try:
        for _ in range(fails + 1):
            out.append(guard.run(7, step))
    except ft.TransientFault:
        out.append("re-raised")
    return out, sleeps, restores, guard.retries, guard.recoveries


@pytest.mark.parametrize("fails,max_retries", [(0, 3), (2, 3), (3, 3),
                                               (4, 3), (2, 0)])
def test_step_guard_retries_and_reraise_match_reference(fails, max_retries):
    got = _drive_guard(port_ft, fails, max_retries)
    assert got == _drive_guard(ref_ft, fails, max_retries)


def _drive_monitor(ft):
    rng = np.random.default_rng(4)
    mon = ft.StragglerMonitor(threshold=1.8, alpha=0.2, warmup=3,
                              min_duration=1e-4)
    flags = []
    for step in range(60):
        dur = float(rng.uniform(0.9e-3, 1.1e-3))
        if step in (10, 30, 31):
            dur *= 3
        ranks = rng.uniform(0.9e-3, 1.1e-3, 4)
        if step >= 20:
            ranks[2] *= 2.5                # a persistent straggler
        if step % 7 == 0:
            ranks[1] = 0.0                 # an idle rank
        flags.append(mon.observe(step, dur,
                                 rank_times=tuple(map(float, ranks))
                                 if step % 5 else None))
    events = [(e.step, e.duration, e.ewma, e.rank) for e in mon.events]
    return flags, events, mon.ewma, dict(mon.rank_ewma), mon.rank_history


def test_straggler_monitor_matches_reference():
    assert _drive_monitor(port_ft) == _drive_monitor(ref_ft)


def test_elastic_rescale_plan_matches_reference():
    for args in [(1 << 20, 4, 8, 6, 2), (1 << 16, 2, 4, 8, 4)]:
        assert vars(port_ft.plan_elastic_rescale(*args)) == \
            vars(ref_ft.plan_elastic_rescale(*args))


# ----------------------------------------------------------------------
# the partition algebra of a mesh shrink and grow
# ----------------------------------------------------------------------
def _part(mod, rt, kind, weights):
    dom = (24, 20)
    region = mod.Box.make((1, 23), (2, 19))
    if kind == "row":
        return rt.partition_row(dom, region=region, weights=weights)
    if kind == "col":
        return rt.partition_col(dom, region=region, weights=weights)
    return rt.partition_block(dom, grid=(2, 2), region=region,
                              weights=weights)


def _algebra(name, kind, weights, live, joiner):
    mod, _ex, ft, _cm = MODS[name]
    rt = mod.HDArrayRuntime(NPROC, backend="null")
    pid = _part(mod, rt, kind, weights)
    out = {}
    shrunk = ft.shrink_partition(rt, pid, live)
    out["shrink"] = shrunk
    out["inherit"] = ft.inherit_partition(rt, pid, live)
    out["survivor"] = ft.survivor_partition(rt, (24, 20), live)
    out["grow"] = ft.grow_partition(rt, shrunk, live, joiner)
    out["grow_factory"] = ft.grow_partition(rt, pid, live, joiner,
                                            weight=0.5)
    out["coverage"] = ft.coverage_box(rt.parts[pid].regions).bounds

    def desc(p):
        if p is None or isinstance(p, tuple):
            return p
        part = rt.parts[p]
        return ([r.bounds for r in part.regions],
                None if part.weights is None else tuple(part.weights))

    return {k: desc(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["row", "col", "block"])
@pytest.mark.parametrize("weights", [None, (3, 1, 2, 2)])
@pytest.mark.parametrize("live,joiner", [((0, 1, 3), 2), ((1, 2), 0),
                                         ((0, 3), 1)])
def test_partition_algebra_matches_reference(kind, weights, live, joiner):
    want = _algebra("ref", kind, weights, list(live), joiner)
    assert _algebra("port", kind, weights, list(live), joiner) == want


# ----------------------------------------------------------------------
# seeded Jacobi programs under faults
# ----------------------------------------------------------------------
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


def _runtime(name, backend, overlap=False):
    mod = MODS[name][0]
    if backend == "torch":
        return mod.HDArrayRuntime(NPROC, backend="torch", device="cpu",
                                  overlap=overlap)
    return mod.HDArrayRuntime(NPROC, backend="sim", overlap=overlap)


def _program(name, rt, weights=None):
    mod = MODS[name][0]
    jac, cp = _KERNELS[name]
    fp = mod.AccessSpec.of((0, -1), (0, 1), (-1, 0), (1, 0), (0, 0))
    ident = mod.AccessSpec.of((0, 0))
    a, b = rt.create("a", (N, N)), rt.create("b", (N, N))
    pd = rt.partition_row((N, N), weights=weights)
    pw = rt.partition_row((N, N), region=mod.Box.make((1, N - 1), (1, N - 1)),
                          weights=weights)
    data = np.random.default_rng(0).standard_normal((N, N)).astype(np.float32)
    rt.write(a, data, pd)
    rt.write(b, data, pd)
    steps = []
    for _ in range(STEPS // 2):
        steps.append(dict(kernel_name="jac", part_id=pw, kernel=jac,
                          arrays=[a, b], uses={"a": fp}, defs={"b": ident}))
        steps.append(dict(kernel_name="cp", part_id=pw, kernel=cp,
                          arrays=[a, b], uses={"b": ident}, defs={"a": ident}))
    return a, pd, steps


def _run(name, backend, specs, weights=None, overlap=False,
         initial_live=None, register=()):
    """The program under a RecoveryPolicy with FaultSpecs ``specs``
    (tuples of FaultSpec arguments).  Returns what the comparison
    reads."""
    _mod, _ex, ft, cm = MODS[name]
    with tempfile.TemporaryDirectory() as d:
        rt = _runtime(name, backend, overlap)
        a, pd, steps = _program(name, rt, weights)
        pol = ft.RecoveryPolicy(
            checkpoint=cm(d), interval=3,
            injector=ft.FaultInjector([ft.FaultSpec(*s) for s in specs]),
            data_parts={"a": pd, "b": pd}, initial_live=initial_live)
        for r in register:
            pol.register_rank(r)
        rt.run_pipeline(steps, recovery=pol)
        out = rt.read_coherent(a)
        rt.close()
    log = [{k: r.get(k) for k in ("kind", "rank", "restored_step", "step",
                                  "live", "migration_bytes", "noop")}
           for r in rt.recovery_log]
    plans = [r["plan"] for r in rt.recovery_log]
    stats = {k: getattr(rt.planner.stats, k) for k in COUNTERS}
    return out, rt.comm_log, log, plans, stats


def _fault_free():
    rt = _runtime("ref", "sim")
    a, _pd, steps = _program("ref", rt)
    rt.run_pipeline(steps)
    return rt.read_coherent(a)


SCENARIOS = {
    "transient_first": dict(specs=[(0,)]),
    "transient_repeated": dict(specs=[(4, "step", "transient", 0, 2),
                                      (8,)]),
    "transient_commit": dict(specs=[(5, "commit")]),
    "rank_loss_step": dict(specs=[(5, "step", "rank", 2)]),
    "rank_loss_commit": dict(specs=[(7, "commit", "rank", 1)]),
    "lose_rejoin_step": dict(specs=[(4, "step", "rank", 2),
                                    (7, "step", "join", 2)]),
    "lose_rejoin_commit": dict(specs=[(3, "commit", "rank", 0),
                                      (8, "commit", "join", 0)]),
    "weighted_loss": dict(specs=[(6, "step", "rank", 3)],
                          weights=(1, 2, 3, 2)),
    "two_losses": dict(specs=[(2, "step", "rank", 1),
                              (6, "commit", "rank", 3)]),
    "join_smaller_mesh": dict(specs=[], weights=(1, 1, 1, 0),
                              initial_live=[0, 1, 2], register=(3,)),
    "join_twice": dict(specs=[(4, "step", "join", 3), (6, "step", "join", 3)],
                       weights=(1, 1, 1, 0), initial_live=[0, 1, 2]),
}


@pytest.mark.parametrize("backend", ["sim", "torch"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_recovery_matches_reference(scenario, backend):
    kw = SCENARIOS[scenario]
    want = _run("ref", "sim", **kw)
    got = _run("port", backend, **kw)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], _fault_free())
    assert got[1] == want[1]                        # comm_log
    assert got[2] == want[2]                        # recovery_log
    assert [None if p is None else tuple(vars(p).values()) for p in got[3]] \
        == [None if p is None else tuple(vars(p).values()) for p in want[3]]
    assert got[4] == want[4]                        # fault counters


@pytest.mark.parametrize("backend", ["sim", "torch"])
def test_fault_at_commit_under_overlap(backend):
    """A transient fault and a rank loss at the commit, on the §4.2
    schedule's host thread while the comm thread's copies are in
    flight: the scheduler joins them before the fault leaves the
    step, and the restore replays to the fault-free values."""
    specs = [(3, "commit"), (6, "commit", "rank", 2)]
    want = _run("ref", "sim", specs, overlap=True)
    got = _run("port", backend, specs, overlap=True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], _fault_free())
    assert got[1:3] == want[1:3]
    assert got[4] == want[4]


def test_checkpoint_required_and_last_rank_loss_raises():
    rt = _runtime("port", "torch")
    _a, _pd, steps = _program("port", rt)
    with pytest.raises(ValueError, match="checkpoint"):
        rt.run_pipeline(steps, recovery=port_ft.RecoveryPolicy())
    with tempfile.TemporaryDirectory() as d:
        pol = port_ft.RecoveryPolicy(
            checkpoint=PortCM(d), interval=3, initial_live=[1],
            injector=port_ft.FaultInjector([port_ft.FaultSpec(
                2, kind="rank", rank=1)]))
        with pytest.raises(RuntimeError, match="no survivors"):
            rt.run_pipeline(steps, recovery=pol)


def test_rebalance_under_overlap_without_policy_raises():
    from repro_torch.ft import Rebalancer

    rt = _runtime("port", "torch", overlap=True)
    _a, _pd, steps = _program("port", rt)
    with pytest.raises(ValueError, match="rebalance requires"):
        rt.run_pipeline(steps, rebalance=Rebalancer())
    rt.close()
