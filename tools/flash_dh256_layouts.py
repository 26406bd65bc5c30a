#!/usr/bin/env python3
"""Layouts of the flash forward's wgmma kernel at Dh 256, side by side.

    python3 tools/flash_dh256_layouts.py

Needs one CUDA card and nvcc.  From ``src/repro_torch/csrc/
flash_attn_hd.cu`` as it stands it writes one variant source per layout
under ``build/flash_dh256_layouts/``, changing only the layout's
constants: who issues the copies (a producer warpgroup whose registers
setmaxnreg hands to the consumers, 24 / 240, or the consumers' thread 0
in a block of the two consumer warpgroups, as the committed source does
at Dh 256), keys per K/V tile (64, 48 or 32; the m64nNk16 product with
both operands in shared memory for N = 48 and 32 is added to the
variant) and K/V stages.  It builds every variant with the port's nvcc
flags, all at once, prints the ptxas registers, spills and C75xx
warnings of the Dh-256 kernels, then runs each on gemma2-9b's prefill
shape (bf16 q (4, 2048, 16, 256), k, v (4, 4096, 8, 256) strided cache
views, window 4096, softcap 50), holds it to the plain blockwise
version within chip_smoke.py's FLASH_MAIN_TOL and times it with CUDA
events, every layout once in two rounds.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_dh256_layouts"

# name: (producer warpgroup, keys per tile, stages)
LAYOUTS = {
    "warpgroup-64x2": (True, 64, 2),
    "warpgroup-48x2": (True, 48, 2),
    "warpgroup-32x2": (True, 32, 2),
    "thread0-64x2": (False, 64, 2),
    "thread0-48x2": (False, 48, 2),
    "thread0-48x3": (False, 48, 3),
    "thread0-32x3": (False, 32, 3),
    "thread0-32x4": (False, 32, 4),
}

# m64nNk16, both operands in shared memory, for N = 48 and 32 (the
# source has N = 64 alone)
_SS = """
namespace {{
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[{R}], uint64_t da,
                                         uint64_t db, int scale_d) {{
  if constexpr (std::is_same<T, __half>::value)
    asm volatile({asm_f16} : {outs} : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile({asm_bf16} : {outs} : "l"(da), "l"(db), "r"(scale_d));
}}
}}  // namespace
"""


def _ss_helper(n: int) -> str:
    regs = n // 2

    def text(ty):
        ops = ", ".join(f"%{i}" for i in range(regs))
        return (f'"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n'
                f'wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ty}.{ty} '
                f'{{{ops}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"')
    outs = ", ".join(f"WG_D8({i})" for i in range(0, regs, 8))
    return _SS.format(R=regs, asm_f16=text("f16"), asm_bf16=text("bf16"),
                      outs=outs)


def variant_source(text: str, warpgroup: bool, keys: int, stages: int) -> str:
    def sub(old, new):
        nonlocal text
        if text.count(old) != 1:
            sys.exit(f"flash_dh256_layouts: {old!r} is not in the source "
                     f"exactly once")
        text = text.replace(old, new)
    if warpgroup:
        sub("constexpr bool kProducerWarpgroup = DV != 256;",
            "constexpr bool kProducerWarpgroup = true;")
    sub("constexpr int kKeys = 64;", f"constexpr int kKeys = {keys};")
    sub("constexpr int kStages = 2;", f"constexpr int kStages = {stages};")
    if keys != 64:
        sub('#include "hopper.cuh"\n',
            '#include "hopper.cuh"\n' + _ss_helper(keys))
    return text


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_dh256_layouts: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.jnp_impl import \
        blockwise_attention

    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "flash_attn_hd.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, layout in LAYOUTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(source, *layout))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed:\n{log[-3000:]}")
            continue
        built[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        c75 = len(re.findall(r"\(C75\d\d\)", log))
        for kernel, report in chip_smoke.ptxas_report(log, nvcc):
            if re.search(r"fa_wgmma_kernel<__nv_bfloat16.*\b256\b", kernel):
                print(f"{name}: {kernel}: {report}; C75xx warnings in the "
                      f"file: {c75}")

    g = torch.Generator(device="cuda").manual_seed(2)
    B, T, S, Hq, Hkv, D = 4, 2048, 4096, 16, 8, 256
    q = torch.randn((B, T, Hq, D), generator=g, device="cuda").bfloat16()
    kv = torch.randn((B, S, 2, Hkv, D), generator=g,
                     device="cuda").bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    qpos = torch.arange(T, dtype=torch.int32, device="cuda").repeat(B, 1)
    kw = dict(qpos=qpos, window=4096, softcap=50.0)
    want = blockwise_attention(q, k, v, **kw).float()
    tol = chip_smoke.FLASH_MAIN_TOL
    load = build.load
    try:
        for rnd in (1, 2):
            for name, lib in built.items():
                build.load = lambda _name, lib=lib: lib
                got = fk.flash_attention_cuda(q, k, v, **kw).float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                bad = int((err > tol + tol * want.abs()).sum())
                ms = chip_smoke.cuda_ms(
                    torch, lambda: fk.flash_attention_cuda(q, k, v, **kw), 20)
                print(f"round {rnd} {name}: {ms:.4f} ms, max_abs_err vs "
                      f"plain {float(err.max()):.3e}, outside {tol:g}: {bad}",
                      flush=True)
    finally:
        build.load = load


if __name__ == "__main__":
    main()
