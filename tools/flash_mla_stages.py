#!/usr/bin/env python3
"""The flash forward's wgmma kernel at Dh 192 / Dv 128 (MLA's naive
form) with 2 and 3 K/V stages and in the other grid order, and how long
its consumers wait.

    python3 tools/flash_mla_stages.py

Needs one CUDA card and nvcc.  Builds ``src/repro_torch/csrc/
flash_attn_hd.cu`` five times under ``build/flash_mla_stages/``, all at
once with the port's nvcc flags: with 2 K/V stages (the source's
``kStages``) and 3, each as it stands and as a wait probe, in which each consumer warpgroup's
first thread times its waits with clock64 (for Q and tile 0's K, for
tile i's K, for tile i - 1's V) and the whole kv loop, summed into a
device counter; and with 2 stages in the Dh = Dv instantiations' grid
order (the query tile the slow index, every head's tile i in flight
together), in which each head's K/V is read once for each of its query
tiles.  Prints the ptxas registers, spills and C75xx warnings
of the 192 / 128 kernels.  Then, at deepseek-v3's prefill shape
(``chip_smoke.mla_inputs``: the RoPE parts as operands of their own,
the shared RoPE key a strided view of the cache), holds each build to
the plain blockwise version within chip_smoke.py's FLASH_MAIN_TOL and
to its own launch on the concatenated operands bit for bit, times each
with CUDA events in two rounds, and prints each probe's waits as shares
of the kv loop's cycles.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_mla_stages"

# name: (stages, wait probe, a (b, head)'s query tiles neighbours)
BUILDS = {
    "2 stages": (2, False, True),
    "3 stages": (3, False, True),
    "2 stages, wait probe": (2, True, True),
    "3 stages, wait probe": (3, True, True),
    "2 stages, tile-major grid": (2, False, False),
}
# the probe's counters: cycles waiting for Q and tile 0's K, for tile
# i's K, for tile i - 1's V, in the whole kv loop; and the loops counted
COUNTERS = ("first", "k", "v", "loop", "loops")

_PROBE_DECL = """
__device__ unsigned long long g_wait[5];
"""
_PROBE_READ = """
extern "C" int flash_mla_wait(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, wg::g_wait, sizeof(wg::g_wait));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(wg::g_wait, zero, sizeof(zero));
  }
  return (int)e;
}
"""


def replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        sys.exit(f"flash_mla_stages: {old!r} is not in the source exactly "
                 f"once")
    return text.replace(old, new)


def variant_source(text: str, stages: int, head_major: bool) -> str:
    """The source with ``stages`` K/V stages (every instantiation; only
    192 / 128 is launched here, Dh 256's shared memory would not hold
    3) and, without ``head_major``, the 192 / 128 instantiation in the
    Dh = Dv grid order."""
    text = replace_once(text, "constexpr int kStages = 2;",
                        f"constexpr int kStages = {stages};")
    if not head_major:
        text = replace_once(text, "constexpr bool kHeadMajor = DK != DV;",
                            "constexpr bool kHeadMajor = false;")
    return text


def probe_source(text: str) -> str:
    """The source with the consumers' waits and kv loop timed at 192 /
    128 (kHeadMajor), by each consumer warpgroup's first thread."""
    def sub(old, new):
        nonlocal text
        text = replace_once(text, old, new)

    probe = "kHeadMajor<DK, DV> && tid % 128 == 0"
    sub("namespace wg {\n", "namespace wg {\n" + _PROBE_DECL)
    sub("""      mbar_wait(bars, 0);
      mbar_wait(bar_k(bars, 0), 0);
""", f"""      const long long w_loop = clock64();
      mbar_wait(bars, 0);
      mbar_wait(bar_k(bars, 0), 0);
      if ({probe})
        atomicAdd(&g_wait[0], (unsigned long long)(clock64() - w_loop));
""")
    sub("""        mbar_wait(bar_k(bars, s), (i / kStages) & 1);
        mbar_wait(bar_v(bars, sp), ((i - 1) / kStages) & 1);
""", f"""        const long long w0 = clock64();
        mbar_wait(bar_k(bars, s), (i / kStages) & 1);
        const long long w1 = clock64();
        mbar_wait(bar_v(bars, sp), ((i - 1) / kStages) & 1);
        if ({probe}) {{
          atomicAdd(&g_wait[1], (unsigned long long)(w1 - w0));
          atomicAdd(&g_wait[2], (unsigned long long)(clock64() - w1));
        }}
""")
    sub("""      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
    }
""", f"""      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      if ({probe}) {{
        atomicAdd(&g_wait[3], (unsigned long long)(clock64() - w_loop));
        atomicAdd(&g_wait[4], 1ull);
      }}
    }}
""")
    return text + _PROBE_READ


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_mla_stages: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention
    from repro_torch.kernels.flash_attention.ref import join_rope

    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "flash_attn_hd.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for i, (name, (stages, probe, head_major)) in enumerate(BUILDS.items()):
        cu = OUT / f"build{i}.cu"
        text = probe_source(source) if probe else source
        cu.write_text(variant_source(text, stages, head_major))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(OUT / f"build{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed:\n{log[-3000:]}")
            continue
        built[name] = ctypes.CDLL(str(OUT / f"build{i}.so"))
        c75 = len(re.findall(r"\(C75\d\d\)", log))
        for kernel, report in chip_smoke.ptxas_report(log, nvcc):
            if re.search(r"fa_wgmma_kernel<.*\b192\b.*\b128\b", kernel):
                print(f"{name}: {kernel}: {report}; C75xx warnings in the "
                      f"file: {c75}", flush=True)

    q, k, v, q_rope, k_rope, scale = chip_smoke.mla_inputs(torch)
    B, T = q.shape[:2]
    qpos = torch.arange(T, dtype=torch.int32, device="cuda").repeat(B, 1)
    kw = dict(qpos=qpos, window=None, scale=scale)
    rope = dict(q_rope=q_rope, k_rope=k_rope)
    q_cat, k_cat = join_rope(q, k, q_rope, k_rope)
    want = blockwise_attention(q, k, v, **kw, **rope).float()
    tol = chip_smoke.FLASH_MAIN_TOL
    load = build.load
    try:
        for rnd in (1, 2):
            for name, lib in built.items():
                build.load = lambda _name, lib=lib: lib
                got = fk.flash_attention_cuda(q, k, v, **kw, **rope)
                same = torch.equal(got, fk.flash_attention_cuda(
                    q_cat, k_cat, v, **kw))
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                bad = int((err > tol + tol * want.abs()).sum())
                line = (f"round {rnd} {name}: max_abs_err vs plain "
                        f"{float(err.max()):.3e}, outside {tol:g}: {bad}; "
                        f"same bits as concatenated: {same}")
                if BUILDS[name][1]:
                    got_wait = (ctypes.c_ulonglong * 5)()
                    lib.flash_mla_wait.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int]
                    lib.flash_mla_wait(ctypes.addressof(got_wait), 1)
                    fk.flash_attention_cuda(q, k, v, **kw, **rope)
                    torch.cuda.synchronize()
                    lib.flash_mla_wait(ctypes.addressof(got_wait), 1)
                    c = dict(zip(COUNTERS, got_wait))
                    loop = max(c["loop"], 1)
                    line += (f"; one launch, {c['loops']} consumer loops: "
                             f"waits for Q and tile 0's K "
                             f"{100 * c['first'] / loop:.2f}%, tile i's K "
                             f"{100 * c['k'] / loop:.2f}%, tile i - 1's V "
                             f"{100 * c['v'] / loop:.2f}% of "
                             f"{c['loop'] / max(c['loops'], 1):.0f} cycles "
                             f"a loop")
                else:
                    ms = chip_smoke.cuda_ms(torch, lambda: (
                        fk.flash_attention_cuda(q, k, v, **kw, **rope)), 20)
                    line = f"round {rnd} {name}: {ms:.4f} ms, " + \
                        line.split(": ", 1)[1]
                print(line, flush=True)
    finally:
        build.load = load


if __name__ == "__main__":
    main()
