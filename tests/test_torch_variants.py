"""The host side of the port's kernel variants, on the CPU.

Each CUDA source holds more than one kernel; a plain Python function
picks the variant from the operand types and head dims, and the
wrapper launches that kernel or raises.  These tests hold the choice,
the ctypes argument lists against the C entry points in
``src/repro_torch/csrc``, and that the plain versions on the CPU launch
nothing (the kernels themselves run only on a card:
tests/test_torch_cuda.py).
"""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import dense_attention
from repro_torch.kernels.gemm_hd import kernel as gemm_kernel
from repro_torch.kernels.gemm_hd.ops import gemm
from repro_torch.kernels.gemm_hd.ref import gemm_ref
from repro_torch.kernels.rglru_scan import kernel as rglru_kernel
from repro_torch.kernels.slstm_scan import kernel as slstm_kernel

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype, Dh, Dv, want", [
    (F32, 128, 128, "ffma"), (F32, 64, 64, "ffma"), (F32, 192, 128, "ffma"),
    (BF16, 128, 128, "wgmma"), (F16, 128, 128, "wgmma"),
    (BF16, 64, 64, "wgmma"), (F16, 64, 64, "wgmma"),
    (BF16, 256, 256, "wgmma"), (F16, 256, 256, "wgmma"),
    (BF16, 192, 128, "wgmma"), (F16, 192, 128, "wgmma"),
    (BF16, 128, 64, "mma_sync"), (BF16, 256, 128, "mma_sync"),
    (F16, 72, 40, "mma_sync"), (BF16, 96, 96, "mma_sync"),
    (F16, 96, 96, "mma_sync"), (BF16, 8, 8, "mma_sync"),
    (F32, 256, 256, "ffma")])
def test_flash_variant_by_dtype_and_head_dims(dtype, Dh, Dv, want):
    assert flash_kernel.flash_variant(dtype, Dh, Dv) == want


def test_serving_prefill_takes_the_wgmma_variant():
    """yi-9b's bf16 prefill (head dim 128) is what the new kernel is
    for; a float32 model keeps the FFMA kernel."""
    cfg = get_config("yi-9b")
    assert flash_kernel.flash_variant(BF16, cfg.head_dim,
                                      cfg.head_dim) == "wgmma"
    assert flash_kernel.flash_variant(F32, cfg.head_dim,
                                      cfg.head_dim) == "ffma"


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-2b"])
def test_dh256_families_take_the_wgmma_variant(arch):
    """gemma2's and recurrentgemma's bf16 prefills (head dim 256) run
    the wgmma kernel, not the first mma_sync design."""
    cfg = get_config(arch)
    assert cfg.head_dim == 256
    assert flash_kernel.flash_variant(BF16, cfg.head_dim,
                                      cfg.head_dim) == "wgmma"


def test_wgmma_entry_takes_the_head_dims_flash_variant_sends_it():
    """The C entry's wgmma check names the same head dims as
    WGMMA_HEAD_DIMS: a dim the wrapper sends to wgmma that the entry
    refused would fail every launch on the card."""
    text = (CSRC / "flash_attn_hd.cu").read_text()
    m = re.search(r"const bool wgmma_dims = Dh == Dv && \(([^;]*)\);", text)
    assert m, "no wgmma_dims check in flash_attn_hd.cu"
    dims = tuple(int(d) for d in re.findall(r"Dh == (\d+)", m.group(1)))
    assert dims == flash_kernel.WGMMA_HEAD_DIMS


def test_wgmma_entry_takes_mla_dims_and_rope_split():
    """The C entry sends the same (Dh, Dv) as WGMMA_MLA_DIMS to the
    192 / 128 instantiation, and takes the RoPE operands at the split
    WGMMA_ROPE_SPLIT names (q and k 128 wide, Dr 64), where the wrapper
    passes them: a pair the entry refused would fail every MLA prefill
    on the card."""
    text = (CSRC / "flash_attn_hd.cu").read_text()
    m = re.search(r"const bool wgmma_mla = Dv == (\d+) && \(split \? "
                  r"Dh == (\d+) && Dr == (\d+)\s*: Dh == (\d+)\);", text)
    assert m, "no wgmma_mla check in flash_attn_hd.cu"
    dv, dn, dr, dh = (int(x) for x in m.groups())
    assert (dh, dv) == flash_kernel.WGMMA_MLA_DIMS
    assert (dn, dr) == flash_kernel.WGMMA_ROPE_SPLIT and dn + dr == dh
    assert f"launch_wgmma<__nv_bfloat16, {dh}, {dv}>" in text
    assert flash_kernel.flash_variant(BF16, dh, dv) == "wgmma"


def test_backward_entry_takes_the_head_dims_bwd_variant_accepts():
    """The backward's C entry sends the same D = Dh = Dv as
    BWD_HEAD_DIMS to wgmma in 16-bit types, with a launch of each, and
    every other type and head dims the forward takes to the ffma pair:
    a head dim the wrapper accepted that the entry refused would fail
    every training step on the card."""
    text = (CSRC / "flash_attn_bwd_hd.cu").read_text()
    m = re.search(r"const bool wgmma_dims = D == Dv && \(([^;]*)\);", text)
    assert m, "no wgmma_dims check in flash_attn_bwd_hd.cu"
    dims = tuple(int(d) for d in re.findall(r"D == (\d+)", m.group(1)))
    assert dims == flash_kernel.BWD_HEAD_DIMS
    assert "const bool wgmma = dtype != 0 && (wgmma_dims || mla);" in text
    # the forward's limits, and the ffma pair for each type past them
    for cond in ("D > 256", "D % 8 != 0", "Dv > 256", "Dv % 8 != 0"):
        assert cond in text
    for t in ("float", "__nv_bfloat16", "__half"):
        assert f"launch_ffma_any<{t}>(p, s)" in text
    for d in dims:
        assert f"launch_16<__nv_bfloat16, {d}>" in text
        assert f"launch_16<__half, {d}>" in text
        assert flash_kernel.bwd_variant(BF16, d, d) == "wgmma"
        assert flash_kernel.bwd_variant(F32, d, d) == "ffma"


def test_backward_entry_takes_mla_dims_in_16_bit_types():
    """The backward's C entry takes Dh 192 / Dv 128 to wgmma in both
    16-bit types, as bwd_variant does; float32 there takes the ffma
    pair."""
    text = (CSRC / "flash_attn_bwd_hd.cu").read_text()
    dh, dv = flash_kernel.BWD_MLA_DIMS
    assert f"const bool mla = D == {dh} && Dv == {dv};" in text
    for t in ("__nv_bfloat16", "__half"):
        assert f"launch_16<{t}, {dh}, {dv}>" in text
    assert flash_kernel.bwd_variant(BF16, dh, dv) == "wgmma"
    assert flash_kernel.bwd_variant(F32, dh, dv) == "ffma"


_DIMS = range(-1, 266)


@pytest.mark.parametrize("dtype", [F32, BF16, F16, torch.float64,
                                   torch.int32])
def test_backward_variant_exists_wherever_the_forward_runs(dtype):
    """For every head-dim pair from -1 to 265: where the forward's
    checks (``check_types``, which ``_check`` runs on every launch) take
    the pair, both ``flash_variant`` and ``bwd_variant`` name a variant;
    where they refuse it, ``bwd_variant`` raises the same error."""
    for Dh in _DIMS:
        for Dv in _DIMS:
            try:
                flash_kernel.check_types(dtype, Dh, Dv)
            except (TypeError, ValueError) as e:
                with pytest.raises(type(e), match=str(e)):
                    flash_kernel.bwd_variant(dtype, Dh, Dv)
                continue
            assert flash_kernel.flash_variant(dtype, Dh, Dv) in \
                flash_kernel.VARIANTS
            assert flash_kernel.bwd_variant(dtype, Dh, Dv) in \
                flash_kernel.BWD_VARIANTS


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-7b", "gemma2-9b",
                                  "qwen3-moe-30b-a3b", "recurrentgemma-2b",
                                  "llama-3.2-vision-11b", "whisper-base",
                                  "deepseek-v3-671b"])
def test_reduced_launcher_trains_through_the_ffma_pair(arch):
    """The reduced configs the launchers default to (bf16 models, head
    dim 16; MLA joined to 24 / 16) take the ffma backward on the card,
    which once raised there; the full configs keep wgmma."""
    cfg = get_config(arch)
    small = cfg.reduced()
    if cfg.mla is not None:
        dims, full = ((m.d_nope + m.d_rope, m.d_v)
                      for m in (small.mla, cfg.mla))
    else:
        dims, full = (small.head_dim,) * 2, (cfg.head_dim,) * 2
    assert flash_kernel.bwd_variant(BF16, *dims) == "ffma"
    assert flash_kernel.bwd_variant(BF16, *full) == "wgmma"


@pytest.mark.parametrize("in_dtype, out_dtype, want", [
    (F32, F32, "pipelined"), (BF16, BF16, "tiled"), (BF16, F32, "tiled"),
    (F32, BF16, "tiled")])
def test_gemm_variant_by_types(in_dtype, out_dtype, want):
    assert gemm_kernel.gemm_variant(in_dtype, out_dtype) == want


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const int*": ctypes.c_void_p,
            "const long long*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_params(source: str, name: str):
    """The parameter types of ``extern "C" int name(...)`` in a source."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"no entry point {name} in {source}"
    types = []
    for param in m.group(1).split(","):
        words = param.split()
        types.append(_C_TYPES[" ".join(words[:-1]).replace(" *", "*")])
    return types


@pytest.mark.parametrize("source, name, module, attr", [
    ("flash_attn_hd.cu", "flash_attn_hd", flash_kernel, "ARGTYPES"),
    ("flash_attn_bwd_hd.cu", "flash_attn_bwd_hd", flash_kernel,
     "BWD_ARGTYPES"),
    ("gemm_hd.cu", "gemm_hd", gemm_kernel, "ARGTYPES"),
    ("rglru_scan.cu", "rglru_scan_hd", rglru_kernel, "ARGTYPES"),
    ("rglru_scan.cu", "rglru_scan_bwd_hd", rglru_kernel, "BWD_ARGTYPES"),
    ("slstm_scan.cu", "slstm_scan_hd", slstm_kernel, "ARGTYPES"),
    ("slstm_scan.cu", "slstm_scan_kernel_hd", slstm_kernel,
     "KERNEL_ARGTYPES"),
    ("slstm_scan.cu", "slstm_scan_bwd_hd", slstm_kernel, "BWD_ARGTYPES"),
    # the backward kernels' probes, for measurements
    ("flash_attn_bwd_hd.cu", "flash_attn_bwd_probe_hd", flash_kernel,
     "BWD_PROBE_ARGTYPES"),
    ("slstm_scan.cu", "slstm_scan_bwd_probe_hd", slstm_kernel,
     "BWD_PROBE_ARGTYPES")])
def test_argtypes_match_the_c_entry_point(source, name, module, attr):
    """A wrapper that passes another argument list than the C function
    declares would pass garbage on the card; this holds them equal."""
    assert getattr(module, attr) == _c_params(source, name)


def test_plain_versions_on_cpu_launch_no_variant():
    """On CPU tensors the ops run their plain versions; no counter of
    any variant moves."""
    flash = flash_kernel.flash_attention_cuda
    mm = gemm_kernel.gemm_cuda
    before = (dict(flash.by_variant), dict(mm.by_variant), flash.launches,
              mm.launches)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 40, 4, 64), generator=g)
    kv = torch.randn((1, 56, 2, 2, 64), generator=g)
    qpos = torch.arange(16, 56, dtype=torch.int32)[None]
    got = flash_attention(q, kv[:, :, 0], kv[:, :, 1], qpos=qpos)
    assert torch.equal(got, dense_attention(q, kv[:, :, 0], kv[:, :, 1],
                                            qpos=qpos))
    a = torch.randn((20, 30), generator=g)
    assert torch.equal(gemm(a, a.t().contiguous()),
                       gemm_ref(a, a.t().contiguous()))
    assert (dict(flash.by_variant), dict(mm.by_variant), flash.launches,
            mm.launches) == before


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    """A source may include any header of csrc/, so the library's name
    changes with a header's bytes as with the source's: a changed
    header never loads a stale library."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert build.library_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


def test_both_flash_sources_include_the_hopper_header():
    """The forward and backward share one copy of the Hopper helpers."""
    for source in ("flash_attn_hd.cu", "flash_attn_bwd_hd.cu"):
        assert '#include "hopper.cuh"' in (CSRC / source).read_text()
    assert "cuTensorMapEncodeTiled" in (CSRC / "hopper.cuh").read_text()


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_build_keeps_the_log_beside_the_library(tmp_path, monkeypatch):
    """A library built earlier returns the ptxas report of its build,
    so a check of spills runs on every load, not only after nvcc; a
    library whose log is gone is built again."""
    import sys

    from repro_torch.kernels import build

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('library')\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        f"sys.stdout.write({_PTXAS_LOG!r})\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel\n")

    assert build.build(("k",)) == {"k": _PTXAS_LOG}
    lib = build.library_path("k")
    assert lib.read_text() == "library"
    assert lib.with_suffix(".log").read_text() == _PTXAS_LOG
    assert build.build(("k",)) == {"k": _PTXAS_LOG}
    assert calls.read_text() == "x"              # the second load built none
    lib.with_suffix(".log").unlink()
    assert build.build(("k",)) == {"k": _PTXAS_LOG}
    assert calls.read_text() == "xx"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


@pytest.mark.parametrize("line, fault", [
    ("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
     False),
    ("    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
     False),
    ("    40 bytes stack frame, 40 bytes spill stores, 40 bytes spill loads",
     True),
    ("    0 bytes stack frame, 0 bytes spill stores, 104 bytes spill loads",
     True),
    ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
     "instructions are serialized due to insufficient register resources "
     "for the wgmma pipeline in the function '_Z1kv'", True),
])
def test_ptxas_faults_finds_spills_and_serialised_wgmmas(line, fault):
    from repro_torch.kernels import build

    log = _PTXAS_LOG.replace(
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        line)
    assert build.ptxas_faults(log) == ([line.strip()] if fault else [])
