"""The port's H100 cost model (``repro_torch.roofline``) on closed-form
programs and against the reference's HLO walk.

  * ``op_costs`` counts exactly: the products of a scanned tanh layer
    and its gradient (the counterpart of ``tests/test_system.py:140-158``,
    where the reference's walker must see every trip), the bytes rules
    (operands and results, views free, a broadcast operand once,
    gathers and scatters by what they move), and collectives by the
    kind the step calls, on a fake process group;
  * ``model_flops`` equals the reference's for every architecture and
    shape;
  * at reduced yi-9b and whisper-base, with T under ``FLASH_MIN_T`` =
    1024 so that both packages attend densely, the FLOPs of the train
    step and of the prefill equal the reference's ``hlo_costs`` walk of
    its compiled step on one CPU device: both count 2·M·N·K per product,
    the checkpointed layers' recompute included, and agree exactly
    (within 2% is the bound; nothing of the difference remains);
  * ``card_kernels``' stand-ins report each kernel's formula per launch
    where the card launches it.
"""
import dataclasses
import pathlib

import pytest
import torch

from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.launch.dryrun import fake_process_group, step_costs
from repro_torch.roofline import analysis as RL
from repro_torch.roofline import kernel_work as KW
from repro_torch.roofline.attribute import costs_by_tag, top
from repro_torch.roofline.op_costs import OpCosts

ARCHS = sorted(all_configs())
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_scan_products_counted_exactly():
    """A scan of 5 tanh(c @ w_i) layers and its gradient: 5 forward
    products, 5 for dw and 4 for dc (the input needs none)."""
    w = torch.randn(5, 64, 64, requires_grad=True)
    x = torch.randn(8, 64)
    with OpCosts() as c:
        y = x
        for i in range(5):
            y = torch.tanh(y @ w[i])
        y.sum().backward()
    one = 2 * 8 * 64 * 64
    assert c.cost.flops == 14 * one
    assert c.cost.flops_by_type == {"f32": 14 * one}


def test_bytes_rules():
    n = 1000
    a, b = torch.randn(n), torch.randn(n)
    with OpCosts() as c:
        a + b
    assert c.cost.hbm_bytes == 3 * 4 * n
    m = torch.randn(64, 32)
    with OpCosts() as c:
        m.t()                                   # a view moves nothing
        m.reshape(32, 64)
    assert c.cost.hbm_bytes == 0 and c.cost.flops == 0
    row = torch.randn(1, 32)
    with OpCosts() as c:
        m + row.expand(64, 32)                  # the broadcast row once
    assert c.cost.hbm_bytes == 4 * (64 * 32 + 32 + 64 * 32)
    idx = torch.tensor([3, 5, 7])
    with OpCosts() as c:
        m[idx]                                  # a gather: what it reads
    assert c.cost.hbm_bytes == 2 * 4 * 3 * 32
    with OpCosts() as c:
        m.index_put_((idx,), torch.ones(3, 32))  # a scatter: what it writes
    assert c.cost.hbm_bytes == 2 * 4 * 3 * 32 + 4 * 3 * 32  # + the ones
    with OpCosts() as c:
        torch.zeros_like(m)
        m.copy_(torch.empty_like(m))
    assert c.cost.hbm_bytes == 4 * 64 * 32 + 2 * 4 * 64 * 32


def test_peak_bytes_tracks_live_storage():
    x = torch.randn(256, 256)
    with OpCosts() as c:
        c.track(x)
        y = x * 2                                # x and y live
        del y
        z = x + 1                                # y freed first
    assert c.cost.peak_bytes == 2 * 4 * 256 * 256
    del z


def test_collectives_by_kind_on_a_fake_group():
    """DTensor's local ops and collectives on rank 0 of 4: an all-gather
    of a row-sharded matrix pays its local shard; a functional
    all-to-all counts as one even where the fake group falls back."""
    from torch.distributed._functional_collectives import all_to_all_single
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        with FakeTensorMode():
            local = torch.empty(16, 32)
            x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
            w = DTensor.from_local(torch.empty(32, 8), mesh, [Replicate()],
                                   run_check=False)
            with OpCosts() as c:
                y = x @ w                        # local (16, 32) @ (32, 8)
                x.redistribute(mesh, [Replicate()])  # all-gather
                all_to_all_single(local, None, None, "0")
        assert isinstance(y, DTensor) and y.to_local().shape == (16, 8)
    assert c.cost.flops == 2 * 16 * 32 * 8           # rank 0's product
    assert c.cost.coll == {"all-gather": 4 * 16 * 32,
                           "all-to-all": 4 * 16 * 32}
    assert c.cost.coll_ops == {"all-gather": 1, "all-to-all": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import SHAPES as REF_SHAPES, get_config as ref_config
    from repro.roofline import analysis as REF
    for shape in SHAPES:
        assert RL.model_flops(get_config(arch), SHAPES[shape]) == \
            REF.model_flops(ref_config(arch), REF_SHAPES[shape])


def _ref_flops(arch, kind, B, T):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import build as ref_build
    from repro.optim import adamw
    from repro.roofline import hlo_costs
    from repro.train.step import TrainConfig as RefTC, make_train_step

    cfg = ref_config(arch).reduced()
    bundle = ref_build(cfg)
    cell = {}

    def only_params(key):
        p, s = bundle.init(key)
        cell["s"] = s
        return p
    params = jax.eval_shape(only_params, jax.random.PRNGKey(0))
    shape = {"train": "train_4k", "prefill": "prefill_32k"}[kind]
    batch = cfg.input_specs(shape, B, T)
    if kind == "train":
        ocfg = adamw.AdamWConfig()
        opt = jax.eval_shape(lambda p: adamw.init_opt_state(ocfg, p), params)
        step = make_train_step(bundle, ocfg, RefTC())
        compiled = jax.jit(step).lower(params, opt, batch).compile()
    else:
        params = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            x.shape, jnp.bfloat16 if x.dtype == jnp.float32 else x.dtype),
            params)
        cache = jax.eval_shape(lambda: bundle.init_cache(B, T))
        compiled = jax.jit(bundle.prefill).lower(params, batch,
                                                 cache).compile()
    return hlo_costs.module_costs(compiled.as_text()).flops


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["yi-9b", "whisper-base"])
def test_step_flops_match_the_reference_hlo_walk(arch, kind):
    pytest.importorskip("jax")
    B, T = 4, 64
    ref = _ref_flops(arch, kind, B, T)
    shape = {"train": "train_4k", "prefill": "prefill_32k"}[kind]
    counter, _ = step_costs(get_config(arch).reduced(), shape,
                            global_batch=B, seq_len=T)
    got = counter.cost.flops
    assert ref > 0 and abs(got - ref) / ref <= 0.02, (got, ref)


def test_visible_pairs_closed_form():
    for B, T, S, w in [(2, 7, 7, None), (2, 7, 7, 3), (1, 5, 9, 2),
                       (1, 9, 5, None), (1, 9, 5, 3), (3, 100, 100, 1000),
                       (1, 64, 64, 64), (2, 4096, 4096, 2048)]:
        q = torch.arange(T)[None].expand(B, T)
        assert KW.visible(q, S, w) == KW.visible_from_zero(B, T, S, w)


@pytest.mark.parametrize("arch", ["yi-9b", "recurrentgemma-2b", "xlstm-125m",
                                  "deepseek-v3-671b"])
def test_card_kernels_report_each_launch(arch):
    """A reduced train step at T = 1024 on fake tensors with the card's
    kernels: per microbatch flash forward 2 a layer (the recompute
    included) and backward 1, the scan and the sLSTM likewise; each
    launch reports its formula."""
    cfg = get_config(arch).reduced()
    if cfg.mla is not None:      # MLA at the card's 192 / 128 head dims
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, d_nope=128, d_rope=64, d_v=128), n_heads=2)
    B, T = 1, 1024
    counter, _ = step_costs(cfg, "train_4k", global_batch=B, seq_len=T,
                            card=True)
    k = counter.cost.kernels
    L = cfg.n_layers
    if cfg.family == "hybrid":
        n_att = L // (cfg.rg.pattern + 1)
        assert k["rglru_scan"]["launches"] == 2 * (L - n_att)
        assert k["rglru_scan_bwd"]["launches"] == L - n_att
        assert k["rglru_scan"]["flops"] == 0
        assert k["rglru_scan_bwd"]["bytes"] == (L - n_att) * KW.rglru_bwd(
            B, T, cfg.rg.lru_width, 2)[1]
    elif cfg.family == "ssm":
        n_s = L // cfg.xlstm.slstm_every
        assert k["slstm_scan"]["launches"] == 2 * n_s
        assert k["slstm_scan_bwd"]["launches"] == n_s
        assert k["slstm_scan"]["flops"] == 2 * n_s * KW.slstm_fwd(
            B, T, cfg.d_model, cfg.n_heads, 2, saving=True)[0]
        assert "flash_attn_hd" not in k
    else:
        n_att = L + int(cfg.mtp)
        fwd = 2 * L + int(cfg.mtp)          # the MTP block is not remat
        assert k["flash_attn_hd"]["launches"] == fwd
        assert k["flash_attn_bwd_hd"]["launches"] == n_att
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        Dh = Dv = cfg.head_dim
        if cfg.mla is not None:
            Hkv, Dh, Dv = Hq, 192, 128
        pairs, rows = KW.visible_from_zero(B, T, T, None)
        f, _, t = KW.flash_fwd(B, T, T, Hq, Hkv, Dh, Dv, 2, pairs, rows)
        assert k["flash_attn_hd"]["flops"] == fwd * f and t == "bf16"
        fb = KW.flash_bwd(B, T, T, Hq, Hkv, Dh, Dv, 2, pairs)[0]
        assert k["flash_attn_bwd_hd"]["flops"] == n_att * fb
    assert counter.cost.flops >= sum(v["flops"] for v in k.values())


def test_report_terms_use_the_h100_constants():
    rep = RL.RooflineReport(
        arch="a", shape="s", mesh="m", n_chips=2, hlo_flops=1.056e12,
        hlo_bytes=6.7e9, coll_bytes=1e8, coll_by_kind={"all-gather": 1e8},
        model_flops_total=1e12,
        flops_by_type={"bf16": 0.989e12, "f32": 0.067e12}).finish()
    assert rep.t_compute == pytest.approx(2e-3)
    assert rep.t_memory == pytest.approx(2e-3)
    assert rep.t_collective == pytest.approx(2e-3)
    assert rep.useful_ratio == pytest.approx(1e12 / 2.112e12)
    # no TPU v5e constant anywhere in the port
    for path in SRC.rglob("*.py"):
        text = path.read_text()
        for tpu in ("197e12", "819e9", "v5e"):
            assert tpu not in text, (path, tpu)


def test_costs_by_tag_sum_to_the_total():
    w = torch.randn(32, 32)

    def step(x):
        return torch.relu(x @ w).sum()
    flops, byts, coll = costs_by_tag(step, torch.randn(4, 32), depth=1)
    assert sum(flops.values()) == 2 * 4 * 32 * 32
    assert any(k.startswith("mm |") for k in flops)
    assert "total" in top(byts) and not coll
