"""The port's training slice against the reference's: data pipeline,
losses, model gradients, the train step and the training driver, plus
two repairs of earlier slices (unsigned device kernels, a NamedTuple
through a checkpoint: tests/test_torch_optim.py).

Inputs come from numpy with a seed and go through both packages; the
reference's weights come across with ``from_jax_params(...,
compute_dtype=torch.float32)``.  Tolerances, each for its reason:

  * the data pipeline is numpy in both: bit-identical;
  * losses and their gradients in float32: the two frameworks sum in
    other orders (logsumexp, matrix products, the layer stack), rtol
    1e-5 and atol 1e-6 for a loss alone, and for a model's leaves a
    Frobenius-relative 1e-4 with each element within 1e-4 of the leaf's
    largest gradient;
  * three train steps in float32: losses as above.  AdamW divides each
    element's update by that element's own gradient scale, so where a
    gradient nearly cancels (the embedding row of a token seen once; a
    bfloat16 accumulator's sum of two rounded microbatch gradients) a
    float32 summation difference can grow to a sizeable part of one
    update, lr = 1e-3.  So the parameters are held through their change
    over the three steps: each leaf's change within 2e-3
    Frobenius-relative of the reference's, and every element within a
    quarter of lr of it (measured: at most 0.11 lr, in one element of
    some 1e5).
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.executors import device_kernel as ref_device_kernel  # noqa: E402
from repro.executors import kernel_put as ref_kernel_put  # noqa: E402
from repro.models.common import cross_entropy_loss as ref_ce  # noqa: E402
from repro.models.common import fused_cross_entropy as ref_fused  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.executors import device_kernel, kernel_put  # noqa: E402
from repro_torch.launch.train import setup, train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import (cross_entropy_loss,  # noqa: E402
                                       fused_cross_entropy)
from repro_torch.models.convert import opt_state_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as port_step  # noqa: E402
from torch_train_grads import (LOSS_TOL, _batch, _models,  # noqa: E402
                               _port_leaves, _ref_leaf)

STEP_FRO_TOL = 2e-3
STEP_MAX_TOL = 0.25          # of the learning rate


# ----------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------
@pytest.mark.parametrize("vocab, seq, batch, seed", [
    (97, 12, 8, 3), (256, 32, 4, 0), (64000, 17, 2, 5)])
def test_pipeline_bit_identical_to_reference(vocab, seq, batch, seed):
    mine = TokenPipeline(DataConfig(vocab, seq, batch, seed))
    theirs = RefPipeline(RefDataConfig(vocab, seq, batch, seed))
    for step in (0, 1, 7, 1000):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    for h in range(2):
        np.testing.assert_array_equal(
            mine.host_batch_slice(7, h, 2)["tokens"],
            theirs.host_batch_slice(7, h, 2)["tokens"])


def test_pipeline_file_source_bit_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    cfg = dict(vocab=60000, seq_len=20, global_batch=4, seed=2,
               source=f"file:{path}")
    a = TokenPipeline(DataConfig(**cfg)).batch_at(3)
    b = RefPipeline(RefDataConfig(**cfg)).batch_at(3)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------
def test_cross_entropy_and_grad_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 12, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    for m in (None, mask):
        def f(x):
            return ref_ce(x, jnp.asarray(labels),
                          None if m is None else jnp.asarray(m))
        want, gwant = jax.value_and_grad(f)(jnp.asarray(logits))
        x = torch.tensor(logits, requires_grad=True)
        got = cross_entropy_loss(x, torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant),
                                   **LOSS_TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_cross_entropy_and_grads_match_reference(cap, masked):
    """37 positions in chunks of 8: the last chunk is padded."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    norm = (0.1 * rng.standard_normal(16)).astype(np.float32)
    emb = rng.standard_normal((16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) > 0.3).astype(np.float32) if masked else None

    def f(x, norm, emb):
        return ref_fused(x, norm, emb, jnp.asarray(labels),
                         None if mask is None else jnp.asarray(mask),
                         cap, chunk=8)
    want, gwant = jax.value_and_grad(f, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, norm, emb)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, norm, emb)]
    got = fused_cross_entropy(*leaves, torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask),
                              cap, chunk=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    for leaf, g in zip(leaves, gwant):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# model loss and gradients (every family's against the reference's:
# tests/test_torch_train_grads.py and tests/test_torch_train_grads_rg.py)
# ----------------------------------------------------------------------
def test_fused_gate_is_the_references():
    """The fused CE path only for vocabularies of 65536 and more."""
    cfg = get_config("yi-9b").reduced()
    small = build(cfg, torch.float32, "cpu")
    big = build(dataclasses.replace(cfg, vocab=65536), torch.float32, "cpu")
    tcfg = port_step.TrainConfig()
    assert port_step.make_loss_fn(small, tcfg).__name__ == "loss_fn"
    assert port_step.make_loss_fn(big, tcfg).__name__ == "fused_loss_fn"
    off = port_step.TrainConfig(fused_ce=False)
    assert port_step.make_loss_fn(big, off).__name__ == "loss_fn"


def test_forward_runs_each_layer_under_checkpoint():
    """With grad enabled each layer is a checkpoint (its activations
    are recomputed in the backward); without it, none is."""
    cfg = get_config("yi-9b").reduced()
    pb = build(cfg, torch.float32, "cpu")
    params = pb.init(0, dtype=torch.float32)
    assert params["main"][0]["attn"]["wq"].dtype == torch.float32
    assert pb.init(0)["main"][0]["attn"]["wq"].dtype == torch.float32
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    _, bt = _batch(cfg, 8, 1)
    import repro_torch.models.lm as lm
    lm.checkpoint, saved = spy, lm.checkpoint
    try:
        with torch.no_grad():
            pb.forward(params, bt)
        assert calls == []
        pb.forward(params, bt)
        assert calls == ["_remat_block"] * cfg.n_layers
    finally:
        lm.checkpoint = saved


def test_bf16_model_keeps_float32_masters():
    """init(dtype=float32) under a bf16 model: float32 leaves, bf16
    logits' math, float32 gradients on every leaf."""
    cfg = get_config("yi-9b").reduced()
    pb = build(cfg, torch.bfloat16, "cpu")
    params = pb.init(0, dtype=torch.float32)
    _, bt = _batch(cfg, 8, 2)
    grad_fn = port_step.value_and_grad(
        port_step.make_loss_fn(pb, port_step.TrainConfig()))
    loss, _, grads = grad_fn(params, bt)
    assert torch.isfinite(loss)
    for g in _port_leaves(grads, cfg).values():
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert float(g.abs().max()) > 0


# ----------------------------------------------------------------------
# train steps
# ----------------------------------------------------------------------
@pytest.mark.parametrize("microbatches, accum, compress", [
    (1, "fp32", "none"), (2, "fp32", "none"), (2, "bf16", "none"),
    (1, "fp32", "bf16")])
def test_three_train_steps_match_reference(microbatches, accum, compress):
    cfg = dataclasses.replace(get_config("yi-9b").reduced(), n_layers=2)
    rb, pr, pr_np, pb, pp = _models(cfg, seed=1)
    start = {k: t.clone() for k, t in _port_leaves(pp, cfg).items()}
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tkw = dict(microbatches=microbatches, accum_dtype=accum,
               grad_compress=compress)
    step_r = jax.jit(ref_step.make_train_step(
        rb, ref_adamw.AdamWConfig(**ocfg), ref_step.TrainConfig(**tkw)))
    step_p = port_step.make_train_step(pb, adamw.AdamWConfig(**ocfg),
                                       port_step.TrainConfig(**tkw))
    sr = ref_adamw.init_opt_state(ref_adamw.AdamWConfig(**ocfg), pr)
    sp = adamw.init_opt_state(adamw.AdamWConfig(**ocfg), pp)
    pipe = TokenPipeline(DataConfig(cfg.vocab, 16, 4, 0))
    for i in range(3):
        b = pipe.batch_at(i)
        pr, sr, mr = step_r(pr, sr, {k: jnp.asarray(v) for k, v in b.items()})
        pp, sp, mp = step_p(pp, sp, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        np.testing.assert_allclose(float(mp["loss"]), float(mr["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(mp["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=1e-4)
    assert int(sp.step) == 3
    pr_np = jax.tree.map(np.asarray, pr)
    for key, t in _port_leaves(pp, cfg).items():
        moved = t.numpy() - start[key].numpy()
        want = _ref_leaf(pr_np, key) - start[key].numpy()
        fro = np.linalg.norm(moved - want) / np.linalg.norm(want)
        assert fro <= STEP_FRO_TOL, (key, fro)
        assert np.abs(moved - want).max() <= STEP_MAX_TOL * ocfg["lr"], key


def test_int8_compression_step_runs():
    cfg = get_config("yi-9b").reduced()
    pb = build(cfg, torch.float32, "cpu")
    params = pb.init(0, dtype=torch.float32)
    ocfg = adamw.AdamWConfig(lr=1e-3, moment_dtype="int8")
    step = port_step.make_train_step(pb, ocfg, port_step.TrainConfig(
        grad_compress="int8"))
    state = adamw.init_opt_state(ocfg, params)
    _, bt = _batch(cfg, 16, 4)
    before = params["emb"]["out_emb"].clone()
    params, state, m = step(params, state, bt)
    assert torch.isfinite(m["loss"]) and int(state.step) == 1
    assert not torch.equal(before, params["emb"]["out_emb"])


def test_eval_step_matches_loss():
    cfg = get_config("yi-9b").reduced()
    rb, pr, _, pb, pp = _models(cfg)
    bj, bt = _batch(cfg, 16, 2)
    want = ref_step.make_eval_step(rb)(pr, bj)["loss"]
    got = port_step.make_eval_step(pb)(pp, bt)["loss"]
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def _layout_leaves(tree, path=(), i=None):
    """{(path, layer): leaf} of a port tree: a list is a group's layers,
    a dict a group or layer, anything else a leaf."""
    if isinstance(tree, list):
        return {k: t for j, layer in enumerate(tree)
                for k, t in _layout_leaves(layer, path, j).items()}
    if isinstance(tree, dict) and not set(tree) == {"q", "s"}:
        return {k: t for n, sub in tree.items()
                for k, t in _layout_leaves(sub, path + (n,), i).items()}
    return {(path, i): tree}


def _at(tree, path):
    for n in path:
        tree = tree[n]
    return tree


OPT_CASES = [pytest.param("yi-9b", m, id=m) for m in ("fp32", "bf16", "int8")]
OPT_CASES += [pytest.param("deepseek-v3-671b", m, id=f"deepseek-v3-{m}")
              for m in ("fp32", "bf16", "int8")]


@pytest.mark.parametrize("arch, moment_dtype", OPT_CASES)
def test_opt_state_from_jax(arch, moment_dtype):
    """The reference's optimizer state after one step comes across, every
    group (deepseek-v3's dense layers, moe layers with their shared
    expert, MTP block and projection): fp32 and bf16 moments bit for
    bit, int8 within one quantization step (a layer's norm scales, 64
    values, share one stacked block in the reference and are
    re-quantized alone)."""
    # deepseek-v3: one dense layer, one moe layer, the MTP block
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    rb, pr, pr_np, pb, pp = _models(cfg)
    ocfg = ref_adamw.AdamWConfig(lr=1e-3, moment_dtype=moment_dtype)
    sr = ref_adamw.init_opt_state(ocfg, pr)
    bj, _ = _batch(cfg, 16, 2)
    _, sr, _ = jax.jit(ref_step.make_train_step(rb, ocfg))(pr, sr, bj)
    sr_np = jax.tree.map(np.asarray, sr)
    sp = opt_state_from_jax(sr_np, pr_np, cfg, device="cpu")
    assert int(sp.step) == 1
    load = lambda m, like: adamw._load(m, moment_dtype, like, 256)  # noqa
    params = _layout_leaves(pp)
    for tr, tp in ((sr_np.mu, sp.mu), (sr_np.nu, sp.nu)):
        moments = _layout_leaves(tp)
        assert moments.keys() == params.keys()
        for (path, i), p in params.items():
            got = load(moments[path, i], p).numpy()
            stacked = _at(tr, path)
            like = np.asarray(_at(pr_np, path))
            if moment_dtype == "int8":
                flat = (np.asarray(stacked["q"], np.float32)
                        * np.asarray(stacked["s"])).reshape(-1)
                want = flat[:like.size].reshape(like.shape)
            else:
                want = np.asarray(stacked, np.float32)
            if i is not None:
                want = want[i]
            if moment_dtype == "int8":
                step = np.abs(want).max() / 127 + 1e-12
                assert np.abs(got - want).max() <= 1.01 * step, (path, i)
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=str((path, i)))
    if arch != "yi-9b":
        assert {path[0] for path, _ in params} == {
            "dense", "emb", "main", "mtp", "mtp_proj"}
        assert (("main", "ffn", "shared", "w_up"), 0) in params


# ----------------------------------------------------------------------
# the training driver (test_system.py:22-48 of the reference)
# ----------------------------------------------------------------------
def test_train_loss_decreases_and_recovers_from_fault():
    with tempfile.TemporaryDirectory() as d:
        run = setup("deepseek-7b", reduced=True, seq_len=32, global_batch=4,
                    lr=5e-3, ckpt_dir=d, total_steps=40, device="cpu")
        out = train(run, 40, ckpt_every=10, inject_faults=[20],
                    verbose=False)
    assert out["recoveries"] == [20], "injected fault must trigger restore"
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert np.isfinite(out["losses"]).all()
    assert last < first, (first, last)


def test_resume_reproduces_interrupted_run():
    """Determinism: train 20 straight == train 10, stop, resume to 20."""
    kw = dict(reduced=True, seq_len=16, global_batch=4, lr=1e-3,
              total_steps=20, device="cpu")
    out_a = train(setup("yi-9b", **kw), 20, verbose=False)
    with tempfile.TemporaryDirectory() as d:
        train(setup("yi-9b", ckpt_dir=d, **kw), 10, ckpt_every=5,
              verbose=False)
        out_c = train(setup("yi-9b", ckpt_dir=d, **kw), 20, ckpt_every=5,
                      verbose=False)
    np.testing.assert_allclose(out_a["losses"][-1], out_c["losses"][-1],
                               rtol=1e-4)


def test_setup_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: setup would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        setup("yi-9b")


def test_unported_families_raise_naming_the_roadmap():
    """No family is left unported: every registered architecture sets up
    for training on the CPU, deepseek-v3 with its MTP loss."""
    from repro_torch.configs import ALL_ARCHS

    for arch in ALL_ARCHS:
        run = setup(arch, seq_len=8, global_batch=2, device="cpu")
        assert run.cfg.name == arch
    run = setup("deepseek-v3-671b", seq_len=8, global_batch=2, device="cpu")
    b = run.pipeline.batch_at(0)
    _, _, m = run.step_fn(run.params, run.opt_state,
                          {n: torch.from_numpy(a) for n, a in b.items()})
    assert {"ce", "mtp", "aux"} <= set(m) and torch.isfinite(m["loss"])


@pytest.mark.parametrize("arch, layers, groups", [
    # one super-block of cross_every 2: its two layers, one cross layer
    ("llama-3.2-vision-11b", 2, {"main": 2, "cross": 1, "cross_norm": 1}),
    ("qwen3-moe-30b-a3b", 1, {"main": 1}),
    # the cut is the decoder's depth; the encoder keeps its own
    ("whisper-base", 1, {}),
])
def test_setup_cuts_depth_and_trains_with_extra_inputs(arch, layers,
                                                       groups):
    """``setup``'s ``cut`` replaces the config's depth, as the card's
    training cuts it, and ``train`` runs the cut model with the family's
    extra inputs over microbatches: finite losses."""
    run = setup(arch, cut={"n_layers": layers}, seq_len=16, global_batch=4,
                microbatches=2, device="cpu")
    assert run.cfg.n_layers == layers
    for group, n in groups.items():
        assert len(run.params[group]) == n, group
    if arch == "whisper-base":
        assert len(run.params["dec"]["attn"]) == layers
        assert len(run.params["enc"]["attn"]) == \
            run.cfg.encdec.n_enc_layers
    out = train(run, 2, verbose=False)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b",
                                  "yi-9b"])
def test_extra_inputs_match_the_reference(arch):
    """Audio frames and image embeddings: the reference's shapes, bf16
    and values from the same rng; none for a decoder."""
    from repro.configs import get_config as ref_get_config
    from repro.launch.train import _extra_inputs as ref_extra_inputs
    from repro_torch.launch.train import _extra_inputs

    want = ref_extra_inputs(ref_get_config(arch).reduced(), 2, 8,
                            np.random.default_rng(123))
    got = _extra_inputs(get_config(arch).reduced(), 2, 8,
                        np.random.default_rng(123), "cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.bfloat16
        assert got[name].device == torch.device("cpu")
        assert np.array_equal(got[name].float().numpy(),
                              np.asarray(w.astype(jnp.float32)))


# ----------------------------------------------------------------------
# step 0 repair: device kernels on unsigned arrays wider than a byte
# ----------------------------------------------------------------------
def _unsigned_values(dtype):
    if dtype == np.uint16:
        return (np.arange(64) * 1000).astype(np.uint16).reshape(8, 8)
    # every value below 2**32 with its low 8 bits clear: exact in
    # float32, which torch's int64 * float promotes to (numpy: float64)
    vals = (np.arange(64, dtype=np.uint64) * 67_000_000) % 2 ** 32
    return (vals & ~np.uint64(0xFF)).astype(np.uint32).reshape(8, 8)


def _unsigned_op(op, dtype, put):
    half = np.iinfo(dtype).max // 2

    def kernel(region, bufs):
        sl = region.to_slices()
        a, b = bufs["A"][sl], bufs["B"][sl]
        if op == "floordiv":
            return {"A": put(bufs["A"], sl, a // 2)}
        if op == "greater":
            return {"B": put(bufs["B"], sl, (a > half) * 7)}
        if op == "maximum":
            mx = np.maximum if isinstance(a, np.ndarray) else torch.maximum
            return {"B": put(bufs["B"], sl, mx(a, b))}
        return {"A": put(bufs["A"], sl, a * 0.5)}    # a float result
    return kernel


def _unsigned_run(rt, core, decorate, put, dtype, op):
    vals = _unsigned_values(dtype)
    part = rt.partition_row((8, 8))
    hA = rt.create("A", (8, 8), dtype=dtype)
    hB = rt.create("B", (8, 8), dtype=dtype)
    rt.write(hA, vals, part)
    rt.write(hB, vals[::-1].copy(), part)
    kern = decorate(_unsigned_op(op, dtype, put))
    rt.apply_kernel(op, part, kern, [hA, hB],
                    uses={"A": core.IDENTITY_2D, "B": core.IDENTITY_2D},
                    defs={"A": core.IDENTITY_2D, "B": core.IDENTITY_2D})
    return rt.read(hA, part), rt.read(hB, part)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("op", ["floordiv", "greater", "maximum",
                                "float_put"])
def test_device_kernels_see_unsigned_values(dtype, op):
    """On the torch backend uint16/32 are stored as signed bits; a
    device kernel must still see (and write) unsigned values, as the
    reference's Sim and the port's Sim do."""
    want = _unsigned_run(ref_core.HDArrayRuntime(4, backend="sim"),
                         ref_core, ref_device_kernel, ref_kernel_put,
                         dtype, op)
    sim = _unsigned_run(port_core.HDArrayRuntime(4, backend="sim"),
                        port_core, device_kernel, kernel_put, dtype, op)
    dev = _unsigned_run(port_core.HDArrayRuntime(4, backend="torch",
                                                 device="cpu"),
                        port_core, device_kernel, kernel_put, dtype, op)
    for got in (sim, dev):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == dtype
            np.testing.assert_array_equal(g, w)


def test_unsigned_floor_division_repro():
    """The repro of the fault: arange(64) * 1000 as uint16 on 4 row
    ranks, A[sl] // 2 (33000 came back as 49268)."""
    rt = port_core.HDArrayRuntime(4, backend="torch", device="cpu")
    a, _ = _unsigned_run(rt, port_core, device_kernel, kernel_put,
                         np.uint16, "floordiv")
    np.testing.assert_array_equal(a, _unsigned_values(np.uint16) // 2)


def test_device_kernels_on_uint64_raise():
    rt = port_core.HDArrayRuntime(4, backend="torch", device="cpu")
    part = rt.partition_row((8, 8))
    h = rt.create("A", (8, 8), dtype=np.uint64)
    rt.write(h, np.arange(64, dtype=np.uint64).reshape(8, 8), part)

    @device_kernel
    def k(region, bufs):
        sl = region.to_slices()
        return {"A": kernel_put(bufs["A"], sl, bufs["A"][sl] // 2)}

    with pytest.raises(NotImplementedError, match="uint64"):
        rt.apply_kernel("k", part, k, [h], uses={"A": port_core.IDENTITY_2D},
                        defs={"A": port_core.IDENTITY_2D})
