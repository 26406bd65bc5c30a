"""The port's expert-parallel moe dispatch (``moe_ffn(..., impl="ep")``)
over real gloo process groups, against the reference's ep and the
port's own sort.

The layer is the reduced qwen3-moe-30b-a3b's (d_model 64, 8 experts
top-2 of width 32) with the reference's weights carried across by
``from_jax_params``, with 0 and 1 shared experts, at capacity factor
1.25 (pairs dropped) and 8 (none).  Each process group lives in
subprocesses of its own (``tests/torch_moe_ep_worker.py``, one a rank),
so none outlives a test.

* (a) ep on a one-rank (1, 1) ("data", "model") mesh against the
  reference's ``moe_ffn(impl="auto")`` under its own 1x1 mesh, as
  ``tests/test_moe_ep.py`` runs it: out and the gradients of
  ``sum(o * o) + aux`` within 2e-5 (of the largest value), aux within
  1e-4 relative;
* (b) that ep run bit for bit the port's sort on plain tensors;
* (c) ``impl="auto"`` on plain tensors bit for bit the sort;
* (d) ep over 2 ranks of ("model",) and over a (2, 2) ("data",
  "model") mesh, the latter with the params placed by the baseline
  rules (the expert stacks' "embed" dim over "data": gathered), against
  the port's sort on each data shard's tokens (the reference's local
  capacity): out and gradients within 2e-5, aux the mean of the
  shards' within 1e-5 relative.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_moe_ep_worker.py")
ARCH = "qwen3-moe-30b-a3b"
B, T = 4, 32
CASES = [(0, 1.25), (1, 1.25), (0, 8.0), (1, 8.0)]    # (n_shared, cf)
IDS = [f"shared{s}-cf{cf:g}" for s, cf in CASES]


def _layer(n_shared, cf, seed=0):
    """Layer 0's moe params of a one-layer reduced model, the
    reference's (jax) and the port's (``from_jax_params``, float32),
    both configs, and x (B, T, D) float32."""
    rcfg = ref_get_config(ARCH).reduced()
    rmo = dataclasses.replace(rcfg.moe, n_shared=n_shared,
                              capacity_factor=cf)
    rcfg = dataclasses.replace(rcfg, moe=rmo, n_layers=1)
    cfg = get_config(ARCH).reduced()
    mo = dataclasses.replace(cfg.moe, n_shared=n_shared, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, moe=mo, n_layers=1)
    params, _ = ref_build(rcfg).init(jax.random.PRNGKey(seed))
    rp = jax.tree.map(lambda a: a[0], params["main"]["ffn"])
    tp = from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu",
                         compute_dtype=torch.float32)["main"][0]["ffn"]
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    return rmo, rp, mo, tp, x


def _spawn(mesh, world, cases, tmp):
    """Runs the worker on ``world`` ranks of a gloo group; rank 0's
    results."""
    src, dst = tmp / "in.pt", tmp / "out.pt"
    torch.save([{"mo": dataclasses.asdict(mo), "p": tp,
                 "x": torch.from_numpy(x)} for mo, tp, x in cases], src)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, mesh, str(r), str(world),
                 str(tmp / "store"), str(src), str(dst)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
            log.close()
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()[-3000:]
    return torch.load(dst)


@pytest.fixture(scope="module")
def layers():
    return [_layer(s, cf) for s, cf in CASES]


@pytest.fixture(scope="module")
def one_rank(layers, tmp_path_factory):
    return _spawn("1x1", 1, [(mo, tp, x) for _, _, mo, tp, x in layers],
                  tmp_path_factory.mktemp("ep1x1"))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _ref_ep(rmo, rp, x):
    """The reference's moe_ffn(impl="auto") under a 1x1 mesh (its ep),
    and the gradients of sum(o * o) + aux."""
    def loss(p_, x_):
        o, aux = ref_moe.moe_ffn(p_, x_, rmo, impl="auto")
        return jnp.sum(o * o) + aux
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])
    with compat.set_mesh(mesh):
        out, aux = jax.jit(lambda p_, x_: ref_moe.moe_ffn(
            p_, x_, rmo, impl="auto"))(rp, jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(rp, jnp.asarray(x))
    return out, aux, gp, gx


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ep_on_one_rank_matches_reference_ep(layers, one_rank, i):
    """(a)"""
    rmo, rp, _, _, x = layers[i]
    got = one_rank[i]["ep"]
    out, aux, gp, gx = _ref_ep(rmo, rp, x)
    _close(got["out"], out, 2e-5)
    assert abs(float(got["aux"]) - float(aux)) <= 1e-4 * abs(float(aux))
    _close(got["grads"]["x"], gx, 2e-5)
    want = jax.tree.map(np.asarray, gp)
    for name, g in got["grads"]["p"].items():
        if isinstance(g, dict):
            for sub, h in g.items():
                _close(h, want[name][sub], 2e-5)
        else:
            _close(g, want[name], 2e-5)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ep_on_one_rank_is_the_sort_bit_for_bit(one_rank, i):
    """(b): one column holds every expert: the same routing, capacity
    and sums, the psum and the aux mean over one rank exact."""
    ep, sort = one_rank[i]["ep"], one_rank[i]["sort"]
    assert torch.equal(ep["out"], sort["out"])
    assert torch.equal(ep["aux"], sort["aux"])
    assert torch.equal(ep["grads"]["x"], sort["grads"]["x"])
    for a, b in zip(tree_leaves(ep["grads"]["p"]),
                    tree_leaves(sort["grads"]["p"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_auto_on_plain_tensors_is_the_sort(layers, n_shared):
    """(c)"""
    _, _, mo, tp, x = layers[n_shared]
    xt = torch.from_numpy(x)
    a, aux_a = moe.moe_ffn(tp, xt, mo)
    b, aux_b = moe.moe_ffn(tp, xt, mo, impl="sort")
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    with pytest.raises(ValueError, match="DTensor"):
        moe.moe_ffn(tp, xt, mo, impl="ep")


def test_expert_range_dispatch():
    """``_dispatch_compute_combine`` over a range of the experts: the
    pairs routed elsewhere go to the trash group and take no capacity,
    so the ranges' outputs sum to the whole dispatch's; the default is
    the whole range, bit for bit."""
    g = torch.Generator().manual_seed(3)
    N, D, E, F, k, C = 48, 16, 8, 8, 2, 9
    xf = torch.randn((N, D), generator=g, dtype=torch.float64)
    ws = [torch.randn((E, D, F), generator=g, dtype=torch.float64),
          torch.randn((E, D, F), generator=g, dtype=torch.float64),
          torch.randn((E, F, D), generator=g, dtype=torch.float64)]
    ids = torch.randint(0, E, (N, k), generator=g)
    w = torch.rand((N, k), generator=g, dtype=torch.float64)
    whole = moe._dispatch_compute_combine(xf, w, ids, *ws, capacity=C)
    assert torch.equal(whole, moe._dispatch_compute_combine(
        xf, w, ids, *ws, capacity=C, n_experts=E, e_base=0))
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert int((counts - C).clamp(min=0).sum()) > 0     # drops
    for n in (2, 4):
        El = E // n
        parts = [moe._dispatch_compute_combine(
            xf, w, ids, *(t[j * El:(j + 1) * El] for t in ws), capacity=C,
            n_experts=El, e_base=j * El) for j in range(n)]
        torch.testing.assert_close(sum(parts), whole, rtol=1e-12,
                                   atol=1e-12)


def _sort_per_shard(mo, tp, x, n_data):
    """The port's sort on each of ``n_data`` batch shards' tokens: out
    (all rows), the shards' mean aux and the gradients of
    sum(o * o) + aux; and the pairs dropped."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    outs, auxs, drops = [], [], 0
    for xs in xt.chunk(n_data):
        o, a = moe.moe_ffn(p, xs, mo, impl="sort")
        outs.append(o)
        auxs.append(a)
        N = xs.shape[0] * xs.shape[1]
        _, ids, _ = moe._route(p["router"], xs.detach().reshape(N, -1),
                               mo.top_k)
        C = max(1, int(mo.capacity_factor * N * mo.top_k / mo.num_experts))
        counts = torch.bincount(ids.reshape(-1), minlength=mo.num_experts)
        drops += int((counts - C).clamp(min=0).sum())
    out, aux = torch.cat(outs), torch.stack(auxs).mean()
    (out * out).sum().add(aux).backward()
    return out, aux.detach(), xt.grad, tree_map(lambda t: t.grad, p), drops


@pytest.fixture(scope="module")
def model2(layers, tmp_path_factory):
    return _spawn("model2", 2, [(mo, tp, x) for _, _, mo, tp, x in layers],
                  tmp_path_factory.mktemp("ep_model2"))


@pytest.fixture(scope="module")
def grid(layers, tmp_path_factory):
    return _spawn("2x2", 4, [(mo, tp, x) for _, _, mo, tp, x in layers],
                  tmp_path_factory.mktemp("ep_2x2"))


@pytest.mark.parametrize("mesh", ["model2", "grid"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ep_over_ranks_matches_the_sort_per_data_shard(layers, mesh, i,
                                                       request):
    """(d): 4 experts a column; on (2, 2) 64 tokens a data shard, whose
    capacity is the shard's own."""
    _, _, mo, tp, x = layers[i]
    got = request.getfixturevalue(mesh)[i]["ep"]
    n_data = 2 if mesh == "grid" else 1
    out, aux, gx, gp, drops = _sort_per_shard(mo, tp, x, n_data)
    assert (drops > 0) == (mo.capacity_factor < 2), drops
    _close(got["out"], out, 2e-5)
    assert abs(float(got["aux"]) - float(aux)) <= 1e-5 * abs(float(aux))
    _close(got["grads"]["x"], gx, 2e-5)
    for a, b in zip(tree_leaves(got["grads"]["p"]), tree_leaves(gp)):
        _close(a, b, 2e-5)
