"""Metadata-layer parity: ``repro_torch.core`` against ``repro.core``.

The port keeps its own copy of the section algebra, partitions, sGDEF
and planner.  Seeded programs (in the style of test_planner_parity.py)
run through both packages' runtimes on the metadata-only ``null``
backend and must give identical CommPlans (messages, boxes, kinds,
bytes), lowered descriptors, ``comm_log``, and §4.2 cache-hit and
commit-replay counts, over row, col, block and weighted partitions.
"""
import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.partition import _weighted_splits as ref_splits
from repro_torch.core.partition import _weighted_splits as port_splits


def _clause(mod, i):
    return (mod.IDENTITY_2D, mod.ROW_ALL, mod.COL_ALL, mod.stencil(2, 1),
            mod.stencil(2, 1, diagonal=True), mod.ALL_2D)[i]


def _plan_sig(plan):
    return (plan.kernel, plan.part_id, plan.cached, [
        (ap.array, ap.kind.value, ap.bytes_total, ap.reduce_op,
         sorted((p, q, m.bounds_array.tolist())
                for (p, q), m in ap.messages.items()),
         [s.bounds_array.tolist() for s in ap.luse],
         [s.bounds_array.tolist() for s in ap.ldef])
        for ap in plan.arrays])


def _lowered_sig(mod, plan):
    return [(op.kind.value, op.array, op.bytes_total, op.halo_widths, op.dim,
             op.reduce_op, op.describe()) for op in mod.lower_plan(plan)]


def _stats_sig(rt):
    st = rt.planner.stats
    return (st.plans_computed, st.hits_history, st.hits_state_compare,
            st.commit_replays, st.intersect_ops, st.gdef_updates,
            st.candidate_pairs, st.pairs_pruned)


def _partition(rt, rng, n, nproc):
    kind = int(rng.integers(0, 6))
    weights = tuple(float(w) for w in rng.integers(1, 5, size=nproc))
    dom = (n, n)
    if kind == 0:
        return rt.partition_row(dom)
    if kind == 1:
        return rt.partition_col(dom)
    if kind == 2:
        return rt.partition_block(dom)
    if kind == 3:
        return rt.partition_row(dom, weights=weights)
    if kind == 4:
        return rt.partition_col(dom, weights=weights)
    return rt.partition_block(dom, weights=weights)


def _random_program(mod, seed):
    """Plan a seeded random program; every random draw is made in the
    same order whatever ``mod`` is, so both packages see one program."""
    rng = np.random.default_rng(seed)
    nproc = int(rng.integers(2, 7))
    n = int(rng.integers(8, 25))
    rt = mod.HDArrayRuntime(nproc, backend="null")
    parts = [_partition(rt, rng, n, nproc) for _ in range(3)]
    arrs = {s: rt.create(s, (n, n)) for s in "AB"}
    for s, h in arrs.items():
        rt.write(h, np.zeros((n, n), np.float32), parts[0])
    sigs = []
    for step in range(int(rng.integers(4, 10))):
        pid = parts[int(rng.integers(0, len(parts)))]
        action = int(rng.integers(0, 8))
        if action == 6:
            plan = rt.repartition(arrs["A"], None, pid)
        elif action == 7:
            rt.reduce(arrs["B"], ("sum", "max")[step % 2], pid)
            continue
        else:
            target = "AB"[int(rng.integers(0, 2))]
            plan = rt.plan_only(f"k{action}_{target}_{pid}", pid,
                                list(arrs.values()),
                                uses={"A": _clause(mod, action)},
                                defs={target: mod.IDENTITY_2D})
        sigs.append((_plan_sig(plan), _lowered_sig(mod, plan)))
    return sigs, list(rt.comm_log), _stats_sig(rt)


@pytest.mark.parametrize("seed", range(16))
def test_random_program_parity(seed):
    assert _random_program(port, seed) == _random_program(ref, seed)


def _jacobi_pingpong(mod, kind, nproc=4, n=24, iters=10):
    rt = mod.HDArrayRuntime(nproc, backend="null")
    interior = mod.Box.make((1, n - 1), (1, n - 1))
    weights = (2, 1, 1, 3)
    pw = {"row": lambda: rt.partition_row((n, n), region=interior),
          "col": lambda: rt.partition_col((n, n), region=interior),
          "block": lambda: rt.partition_block((n, n), region=interior),
          "weighted": lambda: rt.partition_row((n, n), region=interior,
                                               weights=weights)}[kind]()
    pd = rt.partition_row((n, n))
    A, B = rt.create("A", (n, n)), rt.create("B", (n, n))
    rt.write(A, np.zeros((n, n), np.float32), pd)
    rt.write(B, np.zeros((n, n), np.float32), pd)
    st4 = mod.stencil(2, 1)
    sigs = []
    for _ in range(iters):
        for name, uses, defs in (("jab", {"A": st4}, {"B": mod.IDENTITY_2D}),
                                 ("jba", {"B": st4}, {"A": mod.IDENTITY_2D})):
            sigs.append(_plan_sig(rt.plan_only(name, pw, [A, B], uses, defs)))
    return sigs, list(rt.comm_log), _stats_sig(rt)


@pytest.mark.parametrize("kind", ["row", "col", "block", "weighted"])
def test_cache_and_commit_replay_parity(kind):
    got, want = _jacobi_pingpong(port, kind), _jacobi_pingpong(ref, kind)
    assert got == want
    _plans, _log, stats = got
    assert stats[1] + stats[2] > 0      # §4.2 plan reuse engaged
    assert stats[3] > 0                 # fixpoint commit replay engaged


@pytest.mark.parametrize("weights", [(1, 1, 1, 1), (2, 1, 1, 1), (0, 3, 1, 2),
                                     (0.5, 0.25, 0.125, 0.125)])
@pytest.mark.parametrize("extent", [7, 64, 1001])
def test_weighted_splits_parity(weights, extent):
    assert port_splits(extent, weights) == ref_splits(extent, weights)


@pytest.mark.parametrize("factory", ["row", "col", "block"])
def test_partition_regions_parity(factory):
    for nproc in (1, 2, 3, 4, 6, 8):
        for weights in (None, tuple(range(1, nproc + 1))):
            a = getattr(port.Partition, factory)(0, (30, 21), nproc,
                                                 weights=weights)
            b = getattr(ref.Partition, factory)(0, (30, 21), nproc,
                                                weights=weights)
            assert [r.bounds for r in a.regions] == [r.bounds for r in b.regions]
            for p in range(nproc):
                for q in range(nproc):
                    assert a.adjacent(p, q) == b.adjacent(p, q)


def test_absolute_trapezoid_parity():
    """AbsoluteSpec (use@/def@) path: triangular sections, manual rows."""
    nproc, n = 4, 16

    def run(mod):
        planner = mod.Planner()
        arr = mod.HDArray("S", (n, n), np.float32, nproc)
        part = mod.Partition.row(0, (n, n), nproc)
        arr.record_write(tuple(mod.SectionSet.of(r) for r in part.regions))
        tri = mod.AbsoluteSpec(mod.trapezoid(nproc, n, upper=True))
        low = mod.AbsoluteSpec(mod.trapezoid(nproc, n, upper=False))
        out = []
        for step, (u, d) in enumerate([(tri, tri), (low, tri), (tri, low)]):
            plan = planner.plan(f"t{step}", part, [arr], {"S": u}, {"S": d})
            planner.commit(plan, [arr], part)
            out.append(_plan_sig(plan))
            out.append([s.bounds_array.tolist() for s in arr.valid])
        return out

    assert run(port) == run(ref)


def test_classify_parity_on_random_messages():
    rng = np.random.default_rng(11)
    for _ in range(50):
        nproc = int(rng.integers(2, 6))
        part_p = port.Partition.row(0, (12, 12), nproc)
        part_r = ref.Partition.row(0, (12, 12), nproc)
        mp, mr = {}, {}
        for p in range(nproc):
            for q in range(nproc):
                if p != q and rng.random() < 0.5:
                    lo = int(rng.integers(0, 11))
                    mp[(p, q)] = port.SectionSet.of(port.Box.make((lo, lo + 1), (0, 12)))
                    mr[(p, q)] = ref.SectionSet.of(ref.Box.make((lo, lo + 1), (0, 12)))
        assert (port.classify(mp, nproc, part_p).value
                == ref.classify(mr, nproc, part_r).value)
        assert port.classify(mp, nproc).value == ref.classify(mr, nproc).value
