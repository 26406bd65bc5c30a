"""The port's serving cluster (``RecoveryEngine``, ``ReplicaPool`` and
its routers, scheduler, membership and metrics) against the
reference's, on the CPU.

* Units: ``Membership``, the three routers with ``TokenTrie``,
  ``PriorityScheduler`` and ``ServeMetrics`` driven through one seeded
  sequence in both packages, with equal outputs.
* On the reduced yi-9b in float32, with the reference's weights carried
  across by ``models/convert.py``: ``RecoveryEngine.fail_instance`` /
  ``rejoin_instance`` keep the greedy streams of an uninterrupted run
  (port on its Sim oracle and on the torch backend; the records equal
  the reference engine's), and a temperature-sampled replay repeats
  itself; ``ReplicaPool`` streams are equal across policy, replica
  count and an injected failure, and equal the reference pool's.
  float32 greedy tokens agree exactly (tests/test_torch_serve.py holds
  the logits within 1e-4 and the argmax equal); a bfloat16 engine keeps
  its cache's bits through the checkpoint (int16 on the device, uint16
  in the file).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.serve as ref_serve  # noqa: E402
import repro_torch.serve as port_serve  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

ARCH = "yi-9b"
SERVES = {"ref": ref_serve, "port": port_serve}


# ----------------------------------------------------------------------
# units
# ----------------------------------------------------------------------
def _drive_membership(sv):
    m = sv.Membership({0: [0, 1, 2], 1: [0, 1]},
                      sv.MembershipConfig(suspect_after=1, dead_after=3,
                                          rejoin_after=2))
    rng = np.random.default_rng(3)
    out = []
    for tick in range(1, 30):
        for rid, ranks in ((0, [0, 1, 2]), (1, [0, 1])):
            beats = {r for r in ranks if rng.random() > 0.35}
            out.append([(e.kind, e.replica, e.rank, e.tick)
                        for e in m.tick(rid, beats, tick)])
    return out, sorted(m.state.items())


def test_membership_matches_reference():
    assert _drive_membership(port_serve) == _drive_membership(ref_serve)
    for sv in SERVES.values():
        with pytest.raises(ValueError):
            sv.MembershipConfig(suspect_after=5, dead_after=3)


def _drive_routers(sv):
    rng = np.random.default_rng(5)
    out = []
    for policy in ("round_robin", "load_aware", "prefix_aware"):
        router = sv.get_router(policy)
        prompts = [rng.integers(0, 6, rng.integers(2, 7)) for _ in range(6)]
        for step in range(30):
            views = [sv.ReplicaView(replica_id=r, free_slots=1,
                                    outstanding=int(rng.integers(0, 4)),
                                    step_ewma=0.0,
                                    straggler=bool(rng.random() < 0.2))
                     for r in range(3) if rng.random() < 0.8 or r == 0]
            prompt = prompts[step % len(prompts)]
            rid = router.choose(prompt, views)
            router.note_admitted(rid, prompt)
            if step % 7 == 6:
                router.note_evicted(rid, prompt)
            out.append(rid)
    trie = sv.TokenTrie(cap=3)
    for p in ([1, 2, 3], [1, 2, 4], [5], [1, 2, 3, 9], [7, 7]):
        trie.insert(p)
        out.append((trie.match([1, 2, 3, 9, 9]), trie.match([5, 1]),
                    len(trie)))
    trie.remove([7, 7])
    out.append((trie.match([7, 7]), len(trie)))
    with pytest.raises(ValueError):
        sv.get_router("nope")
    return out


def test_routers_match_reference():
    assert _drive_routers(port_serve) == _drive_routers(ref_serve)


def _drive_scheduler(sv):
    s = sv.PriorityScheduler(max_pending=6)
    out = []
    for rid, prio, dl in [(0, 0, None), (1, 2, 5), (2, 2, 3), (3, 1, None),
                          (4, 0, 2), (5, 2, None)]:
        s.push(sv.QueuedRequest(rid, prio, dl))
    try:
        s.push(sv.QueuedRequest(6))
    except sv.QueueFull:
        out.append("full")
    out.append((s.cancel(3), s.cancel(3), s.cancel(42), len(s)))
    for tick in (1, 4, 4, 6, 6, 6):
        out.append((s.pop(tick), list(s.expired), len(s)))
    return out


def test_scheduler_matches_reference():
    assert _drive_scheduler(port_serve) == _drive_scheduler(ref_serve)


def _drive_metrics(sv):
    m = sv.ServeMetrics()
    rng = np.random.default_rng(6)
    for rid in range(5):
        rec = sv.RequestMetrics(rid=rid, priority=rid % 2, prompt_len=4 + rid,
                                submitted_tick=rid, submitted_s=0.5 * rid)
        m.new_request(rec)
        rec.status = ("done", "done", "cancelled", "done", "expired")[rid]
        rec.ttft_s = float(rng.uniform(0.1, 0.3))
        rec.queue_wait_s = float(rng.uniform(0.0, 0.1))
        rec.token_latencies_s = [float(x) for x in rng.uniform(0, 1, 4)]
        rec.tokens_generated = 5
    m.note_event(kind="dead", replica=0, rank=1, tick=3)
    m.note_event(kind="join", replica=0, rank=1, tick=7)
    m.stopped_s = 9.0
    return (m.export({0: {"prefix_hits": 2}}),
            [sv.percentile(v, q) for v in ([], [3.0], [1.0, 2.0, 3.0, 4.0])
             for q in (0.0, 0.5, 0.99, 1.0)])


def test_metrics_match_reference():
    assert _drive_metrics(port_serve) == _drive_metrics(ref_serve)


# ----------------------------------------------------------------------
# engines and pools on the reduced yi-9b
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """The reference's float32 model and the port's, same weights."""
    cfg = get_config(ARCH).reduced()
    rb = ref_build(ref_get_config(ARCH).reduced(), jax.numpy.float32)
    rp, _ = rb.init(jax.random.PRNGKey(0))
    tb = build(cfg, torch.float32, "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, rp), cfg, device="cpu",
                         compute_dtype=torch.float32)
    return {"ref": (rb, rp), "port": (tb, tp)}


def _prompts(vocab, lengths=(6, 5, 7, 4), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lengths]


def _engine_failover(name, models, backend, fail, scfg_kw=None):
    """Two requests on a 3-instance RecoveryEngine; with ``fail``,
    instance 1 fails mid-decode (replaying a window) and rejoins."""
    sv = SERVES[name]
    bundle, params = models[name]
    scfg = sv.ServeConfig(max_seq=40, slots=3, **(scfg_kw or {}))
    kw = {} if name == "ref" else {"backend": backend}
    eng = sv.RecoveryEngine(bundle, params, scfg, instances=3,
                            checkpoint_interval=3, **kw)
    p = _prompts(bundle.cfg.vocab)
    a = eng.add_request(p[0])
    for _ in range(2):
        eng.step()
    b = eng.add_request(p[1])
    for _ in range(4):
        eng.step()
    if fail:
        eng.fail_instance(1)               # replays 1 decode step
        eng.step()
        eng.rejoin_instance(1)
    else:
        eng.step()
    for _ in range(2):
        eng.step()
    streams = [eng.finish(a), eng.finish(b)]
    recs = [{k: v for k, v in r.items() if k != "plan"}
            for r in eng.recovery_log]
    stats = eng.rt.planner.stats
    return streams, recs, (stats.elastic_shrinks, stats.elastic_grows,
                           stats.checkpoint_restores), eng


@pytest.mark.parametrize("backend", ["sim", "torch"])
def test_recovery_engine_failover_matches_reference(models, backend):
    plain, _r, _s, _e = _engine_failover("port", models, backend, False)
    got, recs, stats, eng = _engine_failover("port", models, backend, True)
    want, rrecs, rstats, _e = _engine_failover("ref", models, "sim", True)
    assert got == plain == want
    assert recs == rrecs
    assert [r["kind"] for r in recs] == ["instance_loss", "instance_join"]
    assert recs[0]["steps_replayed"] == 1 and recs[1]["migration_bytes"] > 0
    assert stats == rstats
    assert eng.live == [0, 1, 2]
    if backend == "torch":
        # KV leaves live as int16 bits beside the engine's own cache
        ex = eng.rt.executor
        assert {str(t.dtype) for t in ex._device.values()} == {
            "torch.int16", "torch.int32"}


def test_sampled_replay_repeats_itself(models):
    """Temperature sampling draws from the engine's generator; the
    failover restores its state with the slot table, so the replayed
    window draws the same tokens."""
    kw = {"temperature": 0.9, "top_k": 8}
    plain, _r, _s, _e = _engine_failover("port", models, "torch", False, kw)
    got, _r, _s, _e = _engine_failover("port", models, "torch", True, kw)
    assert got == plain


def test_bf16_cache_bits_survive_failover(tmp_path):
    cfg = get_config(ARCH).reduced()
    bundle = build(cfg, torch.bfloat16, "cpu")
    params = bundle.init(0)
    scfg = port_serve.ServeConfig(max_seq=32, slots=2)
    p = _prompts(cfg.vocab)[0]
    want = port_serve.Engine(bundle, params, scfg).generate(p, 8)
    eng = port_serve.RecoveryEngine(bundle, params, scfg, instances=2,
                                    checkpoint_interval=2,
                                    ckpt_dir=str(tmp_path))
    sid = eng.add_request(p)
    for _ in range(3):
        eng.step()
    before = {k: v.clone() for k, v in eng.engine.cache["main"].items()}
    eng.fail_instance(0)                   # replays 1 decode step
    for k, v in eng.engine.cache["main"].items():
        assert v.dtype == before[k].dtype
        assert torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16
                           else v, before[k].view(torch.int16)
                           if v.dtype == torch.bfloat16 else before[k])
    for _ in range(4):
        eng.step()
    assert eng.finish(sid) == want
    npz = np.load(tmp_path / f"step_{eng._ckpt_step - 1:08d}" / "shard_0.npz")
    assert npz["hda::kv/main/k"].dtype == np.uint16


def _pool(name, models, policy="round_robin", replicas=2, fail=None,
          backend="torch"):
    sv = SERVES[name]
    bundle, params = models[name]
    kw = {} if name == "ref" else {"backend": backend}
    pool = sv.ReplicaPool(bundle, params,
                          sv.ServeConfig(max_seq=64, slots=2,
                                         prefix_reuse=True),
                          replicas=replicas, instances=2, policy=policy,
                          membership=sv.MembershipConfig(suspect_after=1,
                                                         dead_after=2,
                                                         rejoin_after=2),
                          **kw)
    prompts = _prompts(bundle.cfg.vocab, (6, 5, 7, 4, 6))
    prompts[3][:3] = prompts[0][:3]          # a shared prefix
    rids = [pool.submit(p, max_new=8) for p in prompts]
    tick = 0
    while pool.pending:
        tick += 1
        if fail is not None and tick == fail[0]:
            pool.inject_instance_failure(fail[1], fail[2], down_for=5)
        pool.step()
        assert tick < 100
    return [pool.result(r) for r in rids], pool


@pytest.fixture(scope="module")
def ref_pool_streams(models):
    streams, pool = _pool("ref", models, fail=(3, 0, 1))
    kinds = [r["kind"] for r in pool.replicas[0].recovery_log]
    return streams, kinds, _membership_events(pool)


def _membership_events(pool):
    """The pool's membership events (straggler flags come from wall
    times and are left out)."""
    return [(e["kind"], e.get("replica"), e.get("tick"))
            for e in pool.metrics.events
            if e["kind"] in ("suspect", "alive", "dead", "join")]


@pytest.mark.parametrize("policy,replicas,fail,backend", [
    ("round_robin", 2, None, "torch"),
    ("round_robin", 2, (3, 0, 1), "torch"),
    ("round_robin", 2, (3, 0, 1), "sim"),
    ("load_aware", 2, (4, 1, 0), "torch"),
    ("prefix_aware", 2, None, "torch"),
    ("prefix_aware", 3, (2, 0, 1), "torch"),
    ("round_robin", 1, (2, 0, 0), "torch"),
])
def test_pool_streams_equal_across_policy_replicas_and_failure(
        models, ref_pool_streams, policy, replicas, fail, backend):
    want = ref_pool_streams[0]
    got, pool = _pool("port", models, policy, replicas, fail, backend)
    assert got == want
    if fail is not None:
        eng = pool.replicas[fail[1]]
        kinds = [r["kind"] for r in eng.recovery_log]
        assert kinds == ["instance_loss", "instance_join"]
        assert eng.live == [0, 1]
    m = pool.export_metrics()
    assert m["counts"]["done"] == len(want)
    assert m["ttft_s"]["p50"] is not None


def test_pool_failover_matches_reference_pool(models, ref_pool_streams):
    """The same fault on the same tick: the port's pool takes the same
    membership events and recovery records as the reference's."""
    got, pool = _pool("port", models, fail=(3, 0, 1))
    assert got == ref_pool_streams[0]
    assert [r["kind"] for r in pool.replicas[0].recovery_log] == \
        ref_pool_streams[1]
    assert _membership_events(pool) == ref_pool_streams[2]
    assert ("dead", 0, 4) in ref_pool_streams[2]
    stats = pool.replica_stats()
    assert stats[0]["elastic_shrinks"] == stats[0]["elastic_grows"] == 1
