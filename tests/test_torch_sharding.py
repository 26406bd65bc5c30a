"""The port's sharding rules (``repro_torch.train.sharding``) and the
models' logical-axis spec trees against the reference's.

The reference's specs and parameter shapes come from ``jax.eval_shape``
of each family's ``bundle.init`` at full configuration; the port's from
``bundle.specs()`` and an ``init`` under ``FakeTensorMode``.  The
port's layers are a list where the reference stacks them under a
leading "layers" axis, which no rule maps: a port leaf's spec and shape
are the reference's without that axis, matched leaf by leaf through the
weight converter's layout (``models/convert.py:_layout``).  The
reference's functions take an ``AbstractMesh`` of the production
shapes, which needs no devices; the port's a ``MeshShape``.  Every
comparison is exact.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build as ref_build  # noqa: E402
from repro.train import sharding as REF  # noqa: E402
from repro_torch.configs import SHAPES, all_configs, get_config  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.convert import _Leaf, _get, _layout  # noqa: E402
from repro_torch.train import sharding as SH  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = sorted(all_configs())
RULES = ("baseline_rules", "serve_rules", "zero3_rules")
MESHES = (False, True)


def _ref_mesh(multi_pod):
    ms = production_shape(multi_pod=multi_pod)
    return AbstractMesh(ms.dims, ms.axes)


@pytest.fixture(scope="module")
def trees():
    """arch -> (ref shapes, ref specs, port params (fake), port specs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {}
    for arch in ARCHS:
        bundle = ref_build(ref_config(arch))
        cell = {}

        def only_params(key, bundle=bundle, cell=cell):
            p, s = bundle.init(key)
            cell["specs"] = s
            return p
        shapes = jax.eval_shape(only_params, jax.random.PRNGKey(0))
        pb = build(get_config(arch), torch.bfloat16, "cpu")
        with FakeTensorMode():
            params = pb.init(0, dtype=torch.float32)
        out[arch] = (shapes, cell["specs"], params, pb.specs())
    return out


def _zero_strided(tree):
    """The reference's shape tree as storage-free numpy arrays, which the
    converter's layout walks (it reads each stack's length)."""
    return jax.tree.map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), s.shape, (0,) * len(s.shape)), tree)


def _pairs(trees, arch):
    """(port spec, port shape, ref spec, ref shape, stacked) per leaf."""
    shapes, specs, params, pspecs = trees[arch]
    out = []

    def one(leaf, p, ps):
        out.append((ps, tuple(p.shape), _get(specs, leaf.path),
                    tuple(_get(shapes, leaf.path).shape), leaf.i is not None))
    # keyed walk: the reference's dicts come back with sorted keys
    tree_map(one, _layout(_zero_strided(shapes)), params, pspecs,
             is_leaf=lambda x: isinstance(x, _Leaf))
    assert len(out) == len(tree_leaves(params)) == \
        len(tree_leaves(pspecs, is_leaf=SH.is_spec))
    return out


def test_rule_tables_equal_the_reference():
    for name in RULES:
        for mp in MESHES:
            a, b = getattr(SH, name)(mp), getattr(REF, name)(mp)
            assert (a.table, a.batch_axes, a.name) == \
                (b.table, b.batch_axes, b.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_equals_the_reference(trees, arch):
    """Every leaf at full configuration: the reference's spec and shape
    without the leading "layers" axis of a stacked leaf."""
    for ps, pshape, rspec, rshape, stacked in _pairs(trees, arch):
        if stacked:
            assert rspec[0] == "layers"
            rspec, rshape = rspec[1:], rshape[1:]
        assert ps == tuple(rspec) and pshape == rshape, (arch, ps, rspec)


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_reference(trees, arch):
    """spec_to_pspec and its placements on (16, 16) and (2, 16, 16)
    under the three rule tables; the "layers" axis never sharded."""
    for mp in MESHES:
        ms, rmesh = production_shape(multi_pod=mp), _ref_mesh(mp)
        for name in RULES:
            rules, rrules = getattr(SH, name)(mp), getattr(REF, name)(mp)
            for ps, pshape, rspec, rshape, stacked in _pairs(trees, arch):
                ref = tuple(REF.spec_to_pspec(rspec, rshape, rmesh, rrules))
                if stacked:
                    assert ref[0] is None
                    ref = ref[1:]
                got = SH.spec_to_pspec(ps, pshape, ms, rules)
                assert got == ref, (arch, mp, name, ps, got, ref)
                assert SH.spec_to_placements(ps, pshape, ms, rules) == \
                    SH.pspec_to_placements(ref, ms)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_equal_the_reference(arch):
    """batch_shardings on every shape's inputs and cache_shardings on
    every inference shape's cache (the batch_size disambiguation
    included), both meshes, the three rule tables."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    rb, pb = ref_build(rcfg), build(cfg, torch.bfloat16, "cpu")
    for mp in MESHES:
        ms, rmesh = production_shape(multi_pod=mp), _ref_mesh(mp)
        for name in RULES:
            rules, rrules = getattr(SH, name)(mp), getattr(REF, name)(mp)
            for shape in SHAPES:
                got = SH.batch_pspecs(cfg.input_specs(shape), ms, rules)
                ref = REF.batch_shardings(rcfg.input_specs(shape), rmesh,
                                          rrules)
                assert set(got) == set(ref)
                for k in got:
                    assert got[k] == tuple(ref[k].spec), (shape, k)
                sh = SHAPES[shape]
                if sh.kind == "train":
                    continue
                B, T = sh.global_batch, min(sh.seq_len, 4096)
                cache = pb.init_cache(B, T, device="meta")
                rcache = jax.eval_shape(lambda: rb.init_cache(B, T))
                got = SH.cache_pspecs(cache, ms, rules, batch_size=B)
                ref = REF.cache_shardings(rcache, rmesh, rrules,
                                          batch_size=B)
                ref = jax.tree.map(lambda s: tuple(s.spec), ref,
                                   is_leaf=lambda x: hasattr(x, "spec"))
                assert got == ref, (shape, name, mp)   # dicts, by key


@pytest.mark.parametrize("arch", ARCHS)
def test_predict_collectives_equal_the_reference(trees, arch):
    """Byte-equal planner volumes for every shape on both meshes, the
    port's planner (repro_torch.core) against the reference's."""
    shapes, specs, params, pspecs = trees[arch]
    rcfg, cfg = ref_config(arch), get_config(arch)
    for mp in MESHES:
        ms, rmesh = production_shape(multi_pod=mp), _ref_mesh(mp)
        rules, rrules = SH.baseline_rules(mp), REF.baseline_rules(mp)
        for shape in SHAPES:
            got = SH.predict_collectives(cfg, pspecs, params, ms, rules,
                                         SHAPES[shape])
            ref = REF.predict_collectives(rcfg, specs, shapes, rmesh, rrules,
                                          REF_SHAPES[shape])
            assert got == ref, (shape, mp, got, ref)
            assert got["fsdp_allgather"] > 0


def test_cache_batch_dim_disambiguation():
    """A super-block stacked cache (n_sb, SB, B, ...): batch_size picks
    dim 2, where the dim-1 guess would shard the super-block axis."""
    ms = production_shape()
    leaf = torch.empty((8, 16, 128, 64, 8, 128), device="meta")
    got = SH.cache_pspecs({"k": leaf}, ms, SH.serve_rules(),
                          batch_size=128)["k"]
    assert got == (None, None, "data", None, None, "model")
    assert SH.cache_pspecs({"k": leaf}, ms, SH.serve_rules())["k"][1] == \
        "data"


def test_input_specs_match_the_reference():
    """Keys, shapes and dtypes of every cell's inputs, no storage."""
    names = {torch.int32: "int32", torch.float32: "float32",
             torch.bfloat16: "bfloat16"}
    for arch in ARCHS:
        for shape in SHAPES:
            got = get_config(arch).input_specs(shape)
            ref = ref_config(arch).input_specs(shape)
            assert set(got) == set(ref)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(ref[k].shape)
                assert names[t.dtype] == str(ref[k].dtype)
    cfg = get_config("whisper-base")
    got = cfg.input_specs("train_4k", global_batch=3, seq_len=7)
    assert tuple(got["tokens"].shape) == (3, 7)
    assert tuple(got["frames"].shape) == (3, 1500, 512)
