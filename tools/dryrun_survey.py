"""Survey the port's dry-run: every registered architecture's reduced
config (``cfg.reduced()``) at 32 x 64 tokens in ``train_4k``,
``prefill_32k`` and ``decode_32k`` on the (16, 16) mesh of a fake
256-rank process group, then the ``--exact`` cells at their
registered configs (default: qwen3-moe-30b-a3b's and deepseek-v3-671b's
``decode_32k``, the expert-parallel moe dispatch).  Each cell runs in a
process of its own (a process holds one fake group at a time); prints
one line a cell with its status, seconds and collectives (or the op it
failed at), and a table at the end.  No card; writes no record.

  PYTHONPATH=src python tools/dryrun_survey.py [--jobs 4] [--arch A ...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
EXACT = ("qwen3-moe-30b-a3b:decode_32k", "deepseek-v3-671b:decode_32k")

CELL = r'''
import json, sys, time
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import lower_cell
arch, shape, exact = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
kw = {} if exact else dict(cfg=get_config(arch).reduced(), global_batch=32,
                           seq_len=64)
t0 = time.time()
try:
    rec = lower_cell(arch, shape, False, verbose=False, **kw)
    out = {"status": rec["status"], "colls": rec.get("collective_ops")}
except Exception as e:
    out = {"status": "error", "error": repr(e)[:300]}
out["seconds"] = round(time.time() - t0, 1)
print("CELL " + json.dumps(out))
'''


def run(arch: str, shape: str, exact: bool) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    out = subprocess.run(
        [sys.executable, "-c", CELL, arch, shape, "1" if exact else "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    for line in out.stdout.splitlines():
        if line.startswith("CELL "):
            return json.loads(line[5:])
    return {"status": "error", "seconds": None,
            "error": f"exit {out.returncode}: {out.stderr[-300:]}"}


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import all_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--exact", nargs="*", default=list(EXACT),
                    help="arch:shape cells at the registered config")
    args = ap.parse_args(argv)
    archs = args.arch or sorted(all_configs())
    cells = [(a, s, False) for a in archs for s in SHAPES] + [
        (*c.split(":"), True) for c in args.exact]
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda c: run(*c), cells))
    for (a, s, exact), r in zip(cells, results):
        print(f"{a:24s} {s:12s} {'exact' if exact else 'reduced':8s} "
              f"{r['status']:5s} {r['seconds']} s "
              f"{r.get('colls') or r.get('error', '')}", flush=True)
    print("\n| architecture | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    by = {(a, s): r for (a, s, e), r in zip(cells, results) if not e}
    for a in archs:
        print(f"| {a} | " + " | ".join(
            f"{by[a, s]['status']} {by[a, s]['seconds']} s"
            for s in SHAPES) + " |")
    return 0 if all(r["status"] == "ok" for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
