"""The port's xLSTM blocks and its plain sLSTM recurrence against the
reference, on ``get_config("xlstm-125m").reduced()`` (d_model 64, 4
heads: sLSTM heads of 16 units, mLSTM inner width 128 in heads of 32;
``slstm_every`` 2), with the reference's own weights carried across by
``from_jax_params``.

Tolerances:

* the plain sLSTM recurrence and both blocks, in float32: within 1e-5
  relative (plus 1e-5 of the largest value): the same operations, the
  recurrent product and the chunk's einsums summed in another order;
* each kernel variant's partition of the product, emulated here in
  float64 against a float64 einsum: 1e-6 (the same dot products,
  gathered by the kernel's index arithmetic and summed in its order).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.models import xlstm as ref_xl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.slstm_scan import (  # noqa: E402
    slstm_scan, slstm_scan_ref)
from repro_torch.kernels.slstm_scan import kernel as slstm_kernel  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import slstm_step  # noqa: E402
from repro_torch.models import build, xlstm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_get_config(ARCH).reduced()
    params, _ = ref_build(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def cfgs():
    return ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _layer(params, group, i):
    return jax.tree.map(lambda a: a[i], params[group])


def _port(params_np, cfg, dtype=torch.float32):
    return from_jax_params(params_np, cfg, device="cpu", compute_dtype=dtype)


def _slstm_state(B, D, seed):
    """A state the recurrence can reach: n > 0, |c| <= n, any m."""
    rng = np.random.default_rng(seed)
    n = rng.uniform(0.1, 4.0, (B, D)).astype(np.float32)
    c = (n * rng.uniform(-1, 1, (B, D))).astype(np.float32)
    h = rng.uniform(-1, 1, (B, D)).astype(np.float32)
    m = (3 * rng.standard_normal((B, D))).astype(np.float32)
    return {"c": c, "n": n, "h": h, "m": m}


def _mlstm_state(B, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return {"C": (0.3 * rng.standard_normal((B, H, Dh, Dh))).astype(np.float32),
            "n": (0.3 * rng.standard_normal((B, H, Dh))).astype(np.float32),
            "m": rng.standard_normal((B, H)).astype(np.float32)}


# ----------------------------------------------------------------------
# the sLSTM recurrence
# ----------------------------------------------------------------------
def _ref_recurrence(p, x, cfg, state):
    """The reference's hs and final state: slstm_block one step at a time
    with a cache, h read back from the cache after each step."""
    cache = {k: jnp.asarray(v) for k, v in state.items()}
    hs = []
    for t in range(x.shape[1]):
        _, cache = ref_xl.slstm_block(p, jnp.asarray(x[:, t:t + 1]), cfg,
                                      cache=cache)
        hs.append(np.asarray(cache["h"]))
    return np.stack(hs, axis=1), cache


@pytest.mark.parametrize("T", [1, 24])
def test_plain_recurrence_matches_reference(ref_params, cfgs, T):
    """From a nonzero state, the 4 heads' recurrent blocks distinct."""
    params, params_np = ref_params
    rcfg, cfg = cfgs
    p = _layer(params, "slstm", 1)
    D = cfg.d_model
    x = np.random.default_rng(T).standard_normal((2, T, D)).astype(
        np.float32)
    state = _slstm_state(2, D, T + 1)
    want_hs, want_st = _ref_recurrence(p, x, rcfg, state)
    r = torch.from_numpy(params_np["slstm"]["r_in"][1].copy())
    assert not any(torch.allclose(r[0], r[h]) for h in range(1, 4))
    pre_x = jnp.asarray(x) @ p["w_in"] + p["b_in"]
    hs, st = slstm_scan_ref(torch.from_numpy(np.asarray(pre_x)), r,
                            tuple(torch.from_numpy(state[k])
                                  for k in ("c", "n", "h", "m")))
    assert hs.dtype == torch.float32 and hs.shape == (2, T, D)
    _close(hs, want_hs, 1e-5)
    for k, got in zip(("c", "n", "h", "m"), st):
        _close(got, want_st[k], 1e-5)


def _gates(pre, state):
    """The gates and state update of one step from its pre-activations."""
    c, n, _, m = state
    i_, f_, z_, o_ = torch.split(pre, c.shape[1], dim=-1)
    m_new = torch.maximum(f_ + m, i_)
    i_g, f_g = torch.exp(i_ - m_new), torch.exp(f_ + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_)
    n_new = f_g * n + i_g
    return c_new, n_new, torch.sigmoid(o_) * (c_new / n_new.clamp(min=1e-6)), \
        m_new


def test_recurrence_gates_read_all_of_h_not_their_head(ref_params, cfgs):
    """The flat split: a unit's i gate is head 0's output, its f gate
    head 1's, and so on.  A per-head split parts from the reference."""
    params, params_np = ref_params
    rcfg, cfg = cfgs
    p = _layer(params, "slstm", 0)
    D = cfg.d_model
    x = np.random.default_rng(3).standard_normal((2, 1, D)).astype(
        np.float32)
    state = _slstm_state(2, D, 4)
    want, _ = _ref_recurrence(p, x, rcfg, state)
    pre_x = torch.from_numpy(np.asarray(jnp.asarray(x[:, 0]) @ p["w_in"]
                                        + p["b_in"]))
    r = torch.from_numpy(params_np["slstm"]["r_in"][0].copy())
    st = tuple(torch.from_numpy(state[k]) for k in ("c", "n", "h", "m"))
    _close(slstm_step(pre_x, r, st)[2], want[:, 0], 1e-5)
    # each head's own 4Dh outputs split into its units' i, f, z, o
    per_head = torch.einsum("bhd,hde->bhe", st[2].reshape(2, 4, -1), r)
    per_head = per_head.reshape(2, 4, 4, -1).transpose(1, 2).reshape(2, 4 * D)
    wrong = _gates(pre_x + per_head, st)[2]
    assert float((wrong - torch.from_numpy(want[:, 0])).abs().max()) > 1e-2


def test_recurrence_from_zero_and_into_out(ref_params, cfgs):
    """No state is a zero state; ``out`` takes the final state in place
    (here the very tensors of the state it started from)."""
    _, params_np = ref_params
    _, cfg = cfgs
    D = cfg.d_model
    rng = np.random.default_rng(5)
    pre_x = torch.from_numpy(rng.standard_normal((3, 9, 4 * D))
                             .astype(np.float32))
    r = torch.from_numpy(params_np["slstm"]["r_in"][0].copy())
    zeros = tuple(torch.zeros((3, D)) for _ in range(4))
    want_hs, want_st = slstm_scan_ref(pre_x, r, zeros)
    hs, st = slstm_scan_ref(pre_x, r)
    assert torch.equal(hs, want_hs)
    assert all(torch.equal(a, b) for a, b in zip(st, want_st))
    buf = tuple(torch.zeros((3, D)) for _ in range(4))
    hs2, st2 = slstm_scan_ref(pre_x, r, buf, out=buf)
    assert torch.equal(hs2, want_hs)
    assert all(a is b for a, b in zip(st2, buf))
    assert all(torch.equal(a, b) for a, b in zip(buf, want_st))
    assert torch.equal(st2[2], hs[:, -1])


def test_dispatch_on_cpu_runs_the_plain_version(ref_params, cfgs):
    _, params_np = ref_params
    D = cfgs[1].d_model
    pre_x = torch.randn((2, 5, 4 * D), generator=torch.Generator()
                        .manual_seed(0))
    r = torch.from_numpy(params_np["slstm"]["r_in"][0].copy())
    before = slstm_kernel.slstm_scan_cuda.launches
    got, want = slstm_scan(pre_x, r), slstm_scan_ref(pre_x, r)
    assert torch.equal(got[0], want[0])
    assert slstm_kernel.slstm_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        slstm_kernel.slstm_scan_cuda(pre_x, r)


# ----------------------------------------------------------------------
# the kernel's layout, emulated on the CPU
# ----------------------------------------------------------------------
def _cluster_rec(h, r, D):
    """rec as the `cluster` kernel gathers it, one cluster a row.  Block k
    of the cluster owns units [k U, k U + U); its warp w units uw .. uw +
    3 (uw = k U + w 4), lane g 8 + dg the 4 columns j = g D + uw + c of
    gate g (head j // 4Dh, column j % 4Dh) over the d of its chunks ch =
    dg + 8 k with 4 ch < Dh, its registers rr[c 24 + 4 k + i] = r[head, 4
    ch + i, e] (0 past Dh).  h_{t-1} lies in the block's buffer at
    place(v) = (v // Dh) hsd + v % Dh, hsd = Dh rounded up to 4, the
    padding 0; the lane reads column c's chunk at head hsd + 4 ch + i.
    The transposing shuffle leaves lane dg with column dg >> 1 of its
    gate summed over the 8 d-groups; the warp's packed send puts unit c
    at place(uw) + c, which must be the unit's own place.  Every (column,
    d) is read exactly once per row."""
    H, Dh, E = r.shape
    B = h.shape[0]
    U = -(-D // slstm_kernel.CLUSTER)
    C, dgroups = slstm_kernel.COLS, slstm_kernel.DGROUPS
    kd = slstm_kernel.MAX_DH // dgroups
    hsd = -(-Dh // 4) * 4

    def place(v):
        return (v // Dh) * hsd + v % Dh
    rec = torch.zeros((B, 4 * D), dtype=torch.float64)
    seen = torch.zeros((4 * D, Dh), dtype=torch.int64)
    for row in range(B):
        buf = torch.zeros(H * hsd, dtype=torch.float64)
        for v in range(D):
            buf[place(v)] = float(h[row, v])
        for k in range(slstm_kernel.CLUSTER):
            for w in range(-(-U // C)):
                uw = k * U + w * C
                if w * C + C <= U and uw + C <= D \
                        and uw // Dh == (uw + C - 1) // Dh:
                    for c in range(C):
                        assert place(uw) + c == place(uw + c)
                # part[lane][c]: lane g 8 + dg, its C columns
                part = torch.zeros((32, C), dtype=torch.float64)
                for lane in range(32):
                    g, dg = lane // 8, lane % 8
                    for c in range(C):
                        u = uw + c
                        if w * C + c >= U or u >= D:
                            continue
                        j = g * D + u
                        head, e = divmod(j, E)
                        for kk in range(kd // 4):
                            ch = dg + dgroups * kk
                            if 4 * ch >= Dh:
                                continue
                            for i in range(4):
                                d = 4 * ch + i
                                if d >= Dh:
                                    continue
                                seen[j, d] += 1
                                part[lane, c] += float(r[head, d, e]) * buf[
                                    head * hsd + 4 * ch + i]
                # the transposing shuffle: lane g 8 + dg ends with column
                # dg >> 1 of gate g, the sum of its 8 d-groups
                for lane in range(32):
                    g, dg = lane // 8, lane % 8
                    c = dg >> 1
                    u = uw + c
                    if w * C + c >= U or u >= D:
                        continue
                    rec[row, g * D + u] = float(
                        part[g * 8:g * 8 + 8, c].sum())
    assert bool((seen == B).all())
    return rec


def _step_rec(h, r, D):
    """rec as the `step` kernel gathers it.  Block (x, y) takes units x
    8 .. x 8 + 7 of rows y 4 .. y 4 + 3, h of its rows at hsm[v][b].
    Thread tid: quad q = tid % 8 of gate q // 2 and units ub .. ub + 3,
    ub = x 8 + (q % 2) 4, d-group dg = tid // 8 of d = dg, dg + 32, ...;
    four neighbouring columns j0 + c (j0 = g D + ub) in one head when
    ub + 3 < D and j0 % 4 == 0 (one 16-byte load of r), else each column
    by its own head.  The 32 d-groups' sums land in pre_s[q][c 4 + b],
    and the gate thread of unit x 8 + gu, row y 4 + gr reads gate gg at
    pre_s[gg 2 + gu // 4][(gu % 4) 4 + gr]."""
    H, Dh, E = r.shape
    B = h.shape[0]
    nu, nr, nt = (slstm_kernel.STEP_UNITS, slstm_kernel.STEP_ROWS,
                  slstm_kernel.STEP_THREADS)
    rec = torch.full((B, 4 * D), float("nan"), dtype=torch.float64)
    seen = torch.zeros((4 * D, Dh), dtype=torch.int64)
    for y in range(-(-B // nr)):
        hsm = torch.zeros((D, nr), dtype=torch.float64)
        for b in range(nr):
            if y * nr + b < B:
                hsm[:, b] = h[y * nr + b].double()
        for x in range(-(-D // nu)):
            u0 = x * nu
            pre_s = torch.zeros((8, 16), dtype=torch.float64)
            for tid in range(nt):
                q, dg = tid % 8, tid // 8
                ub = u0 + (q % 2) * 4
                j0 = (q // 2) * D + ub
                vec = ub + 3 < D and j0 % 4 == 0
                for c in range(4):
                    if ub + c >= D:
                        continue
                    j = j0 + c
                    hd = (j0 if vec else j) // E
                    e = (j0 % E + c) if vec else j % E
                    assert (hd, e) == divmod(j, E)
                    for d in range(dg, Dh, 32):
                        if y == 0:
                            seen[j, d] += 1
                        for b in range(nr):
                            pre_s[q, c * 4 + b] += float(r[hd, d, e]) \
                                * hsm[hd * Dh + d, b]
            for gtid in range(nu * nr):
                gu, gr = gtid % 8, gtid // 8
                u, row = u0 + gu, y * nr + gr
                if u >= D or row >= B:
                    continue
                for gg in range(4):
                    rec[row, gg * D + u] = pre_s[gg * 2 + gu // 4,
                                                 (gu % 4) * 4 + gr]
    assert bool((seen == 1).all())
    return rec


@pytest.mark.parametrize("variant", slstm_kernel.VARIANTS)
@pytest.mark.parametrize("D, H", [(64, 4), (72, 4), (48, 2), (30, 2)])
def test_kernel_layout_gives_the_recurrent_product(variant, D, H):
    """Each variant's partition of the product over blocks, warps, lanes
    and d, emulated.  D 72 leaves the last blocks' units partly empty
    (`cluster`: U = 5, 80 places; `step`: 9 blocks, the last with 0 of 8
    units) and heads of 18 (not a multiple of 4); D 48 with 2 heads puts
    two gates in one head; D 30 takes each kernel's path for columns
    that are not 4 aligned neighbours in one head; 5 rows leave a row
    group partly empty."""
    g = torch.Generator().manual_seed(D + H)
    r = torch.randn((H, D // H, 4 * D // H), generator=g)
    h = torch.randn((5, D), generator=g)
    want = torch.einsum("bhd,hde->bhe", h.double().reshape(5, H, -1),
                        r.double()).reshape(5, 4 * D)
    rec = _cluster_rec(h, r, D) if variant == "cluster" else \
        _step_rec(h, r, D)
    torch.testing.assert_close(rec, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B, T, D, H, want", [
    (4, 1, 768, 4, "step"),
    (4, slstm_kernel.STEP_MAX_T - 1, 768, 4, "step"),
    (4, slstm_kernel.STEP_MAX_T, 768, 4, "cluster"),
    (4, 2048, 768, 4, "cluster"),
    (1, 40, 64, 4, "cluster"),
    (4, 2048, 1024, 4, "step"),      # 64 units a block: only `step` fits
    (8, 1, 1536, 4, None),           # 384 step blocks, 96 units a block
    (64, 1, 768, 4, "cluster"),      # 1536 step blocks: not resident
    (64, 1, 4096, 4, None)])         # neither
def test_slstm_variant_by_shape(B, T, D, H, want):
    """Decode steps take `step`, prefills from STEP_MAX_T tokens on
    `cluster`; each where it fits."""
    assert slstm_kernel.slstm_variant(B, T, D, H) == want
    assert want is None or want in slstm_kernel.VARIANTS


def test_kernel_constants_match_the_source():
    """The wrapper's constants and smem_bytes are the source's."""
    text = (Path(slstm_kernel.__file__).resolve().parents[2] / "csrc"
            / "slstm_scan.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"no constexpr int {name} in slstm_scan.cu"
        return int(m.group(1))
    k = slstm_kernel
    assert (k.CLUSTER, k.UNITS, k.MAX_DH, k.DGROUPS, k.BUFS,
            k.COLS) == tuple(const(n) for n in (
                "kCluster", "kUnits", "kMaxDh", "kDGroups", "kBufs",
                "kCols"))
    assert (k.STEP_UNITS, k.STEP_ROWS, k.STEP_THREADS, k.STEP_MAX_T,
            k.STEP_MAX_BLOCKS) == tuple(
        const(n) for n in ("kStepUnits", "kStepRows", "kStepThreads",
                           "kStepMaxT", "kStepMaxBlocks"))
    assert k.VARIANTS.index("step") == 0 and k.PROBE == 2
    assert "enum { kStepCode = 0, kClusterCode = 1, kProbeCode = 2" in text
    assert "sizeof(float) * kBufs * (size_t)H * head_stride(D / H);" \
        in text
    assert "return sizeof(float4) * (size_t)D;" in text
    # xlstm-125m: three buffers of 768 h values; 4 rows of 768 in `step`
    assert k.smem_bytes(768, 4, "cluster") == 4 * 3 * 768
    assert k.smem_bytes(768, 4, "step") == 16 * 768
    assert k.smem_bytes(72, 4, "cluster") == 4 * 3 * 4 * 20


# ----------------------------------------------------------------------
# the blocks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T, with_cache", [(24, False), (24, True),
                                           (1, False), (1, True)])
def test_slstm_block_matches_reference(ref_params, cfgs, T, with_cache):
    """The block with its tanh-gelu feed-forward; its cache rows updated
    in place."""
    params, params_np = ref_params
    rcfg, cfg = cfgs
    D = cfg.d_model
    x = np.random.default_rng(T + 7).standard_normal((2, T, D)).astype(
        np.float32)
    state = _slstm_state(2, D, 8) if with_cache else None
    want, want_c = ref_xl.slstm_block(
        _layer(params, "slstm", 1), jnp.asarray(x), rcfg,
        cache=None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()})
    tp = _port(params_np, cfg)
    cache = None if state is None else \
        {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    got, got_c = xlstm.slstm_block(tp["slstm"][1], torch.from_numpy(x), cfg,
                                   cache=cache)
    _close(got, want, 1e-5)
    if state is None:
        assert got_c is None and want_c is None
    else:
        assert got_c is cache
        for k in ("c", "n", "h", "m"):
            _close(got_c[k], want_c[k], 1e-5)


@pytest.mark.parametrize("T, chunk, with_cache", [
    (64, 16, False),     # four chunks of 16: the scan over chunks
    (64, 16, True),
    (40, 16, True),      # not a multiple: one chunk over all of T
    (40, 256, False),
    (16, 16, True),      # one whole chunk: one chunk, not the scan
    (1, 16, True),       # the recurrent decode step
    (1, 16, False)])     # T 1 without a cache: one chunk of one step
def test_mlstm_block_matches_reference(ref_params, cfgs, T, chunk,
                                       with_cache, monkeypatch):
    params, params_np = ref_params
    rcfg, cfg = cfgs
    D, H = cfg.d_model, cfg.n_heads
    Dh = int(D * cfg.xlstm.proj_factor) // H
    calls = []
    chunk_fn = xlstm._mlstm_chunk

    def spy(q, *args):
        calls.append(q.shape[2])
        return chunk_fn(q, *args)

    monkeypatch.setattr(xlstm, "_mlstm_chunk", spy)
    x = np.random.default_rng(T + chunk).standard_normal((2, T, D)).astype(
        np.float32)
    state = _mlstm_state(2, H, Dh, T) if with_cache else None
    want, want_c = ref_xl.mlstm_block(
        _layer(params, "mlstm", 1), jnp.asarray(x), rcfg,
        cache=None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()}, chunk=chunk)
    tp = _port(params_np, cfg)
    cache = None if state is None else \
        {k: torch.from_numpy(v) for k, v in state.items()}
    got, got_c = xlstm.mlstm_block(tp["mlstm"][1], torch.from_numpy(x), cfg,
                                   cache=cache, chunk=chunk)
    _close(got, want, 1e-5)
    if T == 1 and with_cache:
        assert calls == []
    elif T % chunk == 0 and T // chunk > 1:
        assert calls == [chunk] * (T // chunk)
    else:
        assert calls == [T]
    if state is None:
        assert got_c is None and want_c is None
    else:
        for k in ("C", "n", "m"):
            _close(got_c[k], want_c[k], 1e-5)


def test_mlstm_decode_step_rounds_k_and_v_in_bf16(ref_params, cfgs):
    """In bf16 the decode step's outer product k v^T rounds to bf16
    before it meets the float32 state, as in the reference."""
    params, params_np = ref_params
    rcfg, cfg = cfgs
    H = cfg.n_heads
    Dh = int(cfg.d_model * cfg.xlstm.proj_factor) // H
    x = np.random.default_rng(2).standard_normal((2, 1, cfg.d_model))
    state = _mlstm_state(2, H, Dh, 3)
    _, want_c = ref_xl.mlstm_block(
        _layer(params, "mlstm", 0), jnp.asarray(x, jnp.bfloat16), rcfg,
        cache={k: jnp.asarray(v) for k, v in state.items()})
    tp = _port(params_np, cfg, torch.bfloat16)
    _, got_c = xlstm.mlstm_block(
        tp["mlstm"][0], torch.from_numpy(x).bfloat16(), cfg,
        cache={k: torch.from_numpy(v) for k, v in state.items()})
    for k in ("C", "n", "m"):
        assert got_c[k].dtype == torch.float32
        _close(got_c[k], want_c[k], 2e-2)


# ----------------------------------------------------------------------
# parameters and caches
# ----------------------------------------------------------------------
def test_from_jax_params_keeps_r_in_biases_and_norms_float32(ref_params,
                                                             cfgs):
    _, params_np = ref_params
    _, cfg = cfgs
    tp = _port(params_np, cfg, torch.bfloat16)
    assert (len(tp["mlstm"]), len(tp["slstm"]), len(tp["norms"])) == (2, 2, 4)
    s, m = tp["slstm"][1], tp["mlstm"][0]
    assert {n: s[n].dtype for n in s} == {
        "w_in": torch.bfloat16, "r_in": torch.float32,
        "b_in": torch.float32, "w_ff1": torch.bfloat16,
        "w_ff2": torch.bfloat16}
    assert m["b_if"].dtype == torch.float32
    assert all(m[n].dtype == torch.bfloat16 for n in m if n != "b_if")
    assert np.array_equal(s["r_in"].numpy(), params_np["slstm"]["r_in"][1])
    assert all(t.dtype == torch.float32 for n in tp["norms"]
               for t in n.values())
    assert tp["emb"]["final_norm"].dtype == torch.float32


def test_init_is_shaped_as_the_reference(ref_params, cfgs):
    """The port's init draws its own numbers, in the reference's shapes
    (one layer of each stacked leaf) and scales."""
    _, params_np = ref_params
    _, cfg = cfgs
    tp = build(cfg, torch.bfloat16, "cpu").init(0)
    for group in ("mlstm", "slstm", "norms"):
        want = {n: (w.shape[1:], w.shape[0]) for n, w in
                params_np[group].items()}
        assert {n: (tuple(t.shape), len(tp[group]))
                for n, t in tp[group][0].items()} == want
    assert tp["slstm"][0]["r_in"].dtype == torch.float32
    assert tp["mlstm"][0]["w_q"].dtype == torch.bfloat16
    for group, name in (("slstm", "r_in"), ("mlstm", "w_q"),
                        ("mlstm", "skip")):
        want = float(params_np[group][name].std())
        got = float(tp[group][0][name].float().std())
        assert abs(got - want) < 0.1 * want


def test_init_caches_match_the_reference(cfgs):
    rcfg, cfg = cfgs
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        ref_xl.init_xlstm_caches(rcfg, 2, 2, 3))
    got = xlstm.init_xlstm_caches(cfg, 2, 2, 3, device="cpu")
    assert {g: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in d.items()} for g, d in got.items()} == want
    assert all(float(v.abs().sum()) == 0 for d in got.values()
               for v in d.values())
