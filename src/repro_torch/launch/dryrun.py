"""Multi-pod dry-run: trace every (architecture x input shape x mesh)
cell against the production mesh and derive the H100 roofline terms,
the port of the reference's ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 512 placeholder XLA
host devices and walks the compiled HLO.  The port has no compiler to
ask: it runs the step itself, on fake tensors (``FakeTensorMode``: no
storage, shapes and dtypes only) placed as DTensors over a DeviceMesh
of a fake process group (``torch.testing``'s ``fake`` backend: every
collective returns at once), as rank 0 of 256 or 512.  The fake tensors
live on a fake CPU device: the port's entry points raise for "cuda"
without a card, and the CPU path runs the kernels' plain versions,
whose ops the count sees.  For each cell this:

  1. builds the arch at its EXACT assigned config: a fake ``init`` and
     ``cfg.input_specs`` stand-ins, nothing allocated,
  2. maps every param's logical axes to mesh axes with the rules table
     (``train/sharding.py``) and places params, optimizer moments,
     batch and caches as DTensors,
  3. runs train_step / prefill / decode under
     :class:`~repro_torch.roofline.op_costs.OpCosts`, which counts one
     rank's local ops and collectives,
  4. writes the roofline report JSON
     (``<results_dir>/<arch>__<shape>__<mesh>.json``).

An op DTensor has no sharding strategy for fails the cell: its record
is ``status: "error"`` with the op's name, as the reference records a
failed compile; nothing is replicated behind the caller's back.

Records go to ``results/dryrun_torch/`` (never the reference's
``results/dryrun/``), or to ``$REPRO_TORCH_RESULTS_DIR``.

Usage:
  python -m repro_torch.launch.dryrun --arch whisper-base --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --sweep --mesh both        # all cells
  python -m repro_torch.launch.dryrun --list                     # show cells
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as RL
from repro_torch.roofline.op_costs import OpCosts, card_kernels
from repro_torch.train import sharding as SH
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map

_DEFAULT_RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                                    "..", "results", "dryrun_torch")


def results_dir() -> str:
    """Where result records live: ``REPRO_TORCH_RESULTS_DIR`` (read at
    call time) or ``results/dryrun_torch``."""
    return os.environ.get("REPRO_TORCH_RESULTS_DIR") or _DEFAULT_RESULTS_DIR


# Per-arch scale knobs (microbatches bound saved-activation memory;
# moment dtype bounds optimizer-state memory): the reference's baseline
# settings.
TRAIN_OVERRIDES: Dict[str, Dict[str, Any]] = {
    "deepseek-v3-671b": dict(microbatches=16, param_dtype="bf16",
                             accum_dtype="bf16", moment_dtype="bf16"),
    "mistral-large-123b": dict(microbatches=16, moment_dtype="bf16"),
    "qwen3-moe-30b-a3b": dict(microbatches=16),
    "deepseek-7b": dict(microbatches=8),
    "yi-9b": dict(microbatches=8),
    "gemma2-9b": dict(microbatches=16),
    "llama-3.2-vision-11b": dict(microbatches=8),
    "recurrentgemma-2b": dict(microbatches=16),
    "xlstm-125m": dict(microbatches=8),
    "whisper-base": dict(microbatches=8),
}

RULES = {"baseline": SH.baseline_rules, "zero3": SH.zero3_rules,
         "serve": SH.serve_rules}


def _split_overrides(ov: Dict[str, Any]) -> Tuple[TrainConfig, str]:
    ov = dict(ov)
    moment = ov.pop("moment_dtype", "fp32")
    return TrainConfig(**ov), moment


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process
    rank 0, destroyed on exit (a process holds one group at a time)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The DTensor of ``t``'s global shape and dtype with ``placements``
    over ``mesh``, its local shard a new fake tensor of the local
    shape."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():      # the offsets are real tensors
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh,
                                                         placements)
        stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device=t.device), mesh,
        placements, run_check=False, shape=t.shape, stride=stride)


def views_as_reshapes() -> None:
    """DTensor refuses a view that splits a sharded dim unevenly (a
    (B, T, 512) projection sharded 16 ways over 'model' viewed as 8
    heads of 64): a view cannot move data.  The model code asks for a
    ``reshape``, which PyTorch turns into a view when the strides allow;
    so the dry-run gives ``view`` and ``_unsafe_view`` DTensor's reshape
    strategy, which gathers the dim first, as XLA's partitioner does in
    the reference.  The gather is a collective the count sees."""
    from torch.distributed.tensor import DTensor
    aten = torch.ops.aten
    funcs = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    for op in (aten.view.default, aten._unsafe_view.default):
        funcs[op] = funcs[aten.reshape.default]


def _local_bytes(tree) -> int:
    return sum(getattr(t, "_local_tensor", t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def step_costs(cfg, shape_name: str, *, mesh=None, rules=None,
               tcfg: TrainConfig = TrainConfig(), moment_dtype: str = "fp32",
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None, card: bool = False
               ) -> Tuple[OpCosts, Dict[str, Any]]:
    """One step of ``cfg`` on the shape cell ``shape_name`` (its batch
    and sequence replaceable), counted on fake tensors: the train step
    (microbatched by ``tcfg``, AdamW with ``moment_dtype`` moments) for
    a train cell, prefill or decode (every weight bf16, a cache of the
    cell's length) otherwise.  With ``mesh`` every leaf is a DTensor
    placed by ``rules`` and the count is rank 0's; without, one device
    holds it all.  ``card``: the kernels' stand-ins take the card's path
    (``op_costs.card_kernels``).  Returns the finished count and
    {"param_bytes", "input_bytes"} of one rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    sh = SHAPES[shape_name]
    B = global_batch if global_batch is not None else sh.global_batch
    T = seq_len if seq_len is not None else sh.seq_len
    bundle = build(cfg, torch.bfloat16, "cpu")
    counter = OpCosts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(FakeTensorMode())
        if card:
            stack.enter_context(card_kernels())
        train = sh.kind == "train"
        params = bundle.init(0, dtype=torch.float32)
        if not train or tcfg.param_dtype == "bf16":
            # every float32 leaf in bf16, as the reference's _cast_shapes
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        batch = cfg.input_specs(shape_name, B, T, device="cpu")
        cache = None if train else bundle.init_cache(B, T, device="cpu")
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
            params = tree_map(lambda p, pl: _placed(p, mesh, pl), params,
                              SH.param_shardings(bundle.specs(), params,
                                                 mesh, rules))
            batch = tree_map(lambda b, pl: _placed(b, mesh, pl), batch,
                             SH.batch_shardings(batch, mesh, rules))
            if cache is not None:
                cache = tree_map(lambda c, pl: _placed(c, mesh, pl), cache,
                                 SH.cache_shardings(cache, mesh, rules,
                                                    batch_size=B))
        info = {"param_bytes": _local_bytes(params)}
        if train:
            ocfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
            if mesh is None:
                opt = adamw.init_opt_state(ocfg, params)
            else:
                mdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[
                    moment_dtype]
                moments = [tree_map(lambda p: _placed(
                    torch.empty(p.shape, dtype=mdt), mesh, p.placements),
                    params) for _ in range(2)]
                opt = adamw.OptState(torch.zeros((), dtype=torch.int32),
                                     *moments)
            step = make_train_step(bundle, ocfg, tcfg)
            inputs = (params, opt, batch)
        else:
            inputs = (params, batch, cache)
        info["input_bytes"] = _local_bytes(inputs)
        stack.enter_context(counter)
        counter.track(inputs)
        try:
            if train:
                step(*inputs)
            else:
                fn = bundle.prefill if sh.kind == "prefill" else \
                    bundle.decode
                with torch.no_grad():
                    fn(*inputs)
        except Exception as e:
            if counter.last_dtensor_op is None:
                raise
            # the record names the op the step failed at
            raise RuntimeError(f"{counter.last_dtensor_op}: {e!r}") from e
    return counter, info


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               rules_name: str = "baseline",
               train_overrides: Optional[Dict[str, Any]] = None,
               verbose: bool = True, cfg=None,
               global_batch: Optional[int] = None,
               seq_len: Optional[int] = None) -> Dict[str, Any]:
    """Trace one cell; returns the result record.  ``cfg`` replaces the
    arch's registered config (a reduced one, in tests), and
    ``global_batch``/``seq_len`` the shape cell's."""
    t_start = time.time()
    cfg = cfg if cfg is not None else get_config(arch)
    shape_cell = SHAPES[shape_name]
    if global_batch is not None or seq_len is not None:
        shape_cell = dataclasses.replace(
            shape_cell, global_batch=global_batch or shape_cell.global_batch,
            seq_len=seq_len or shape_cell.seq_len)
    ok, why = cfg.supports_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "rules": rules_name, "status": "skip", "why": why,
    }
    if not ok:
        return rec
    mshape = production_shape(multi_pod=multi_pod)
    # inference cells use TP-only rules (FSDP on a contracting dim turns
    # serving matmuls into activation all-reduces), unless the TP-only
    # param bytes a device pass 8 GiB: those keep FSDP
    if rules_name == "baseline" and shape_cell.kind != "train":
        tp_bytes_per_dev = cfg.param_count() * 2 / mshape.shape.get(
            "model", 1)
        if tp_bytes_per_dev < 8 * 2**30:
            rules_name = "serve"
    rules = RULES[rules_name](multi_pod)
    rec["rules"] = rules_name
    ov = dict(TRAIN_OVERRIDES.get(arch, {}))
    if train_overrides:
        ov.update(train_overrides)
    tcfg, moment_dtype = _split_overrides(ov)
    # per-microbatch batch rows must still divide the batch shards
    n_batch = math.prod(mshape.shape.get(a, 1) for a in rules.batch_axes)
    mb = tcfg.microbatches
    while mb > 1 and (shape_cell.global_batch // mb) % n_batch:
        mb //= 2
    if mb != tcfg.microbatches:
        tcfg = dataclasses.replace(tcfg, microbatches=mb)
    rec["train_cfg"] = dataclasses.asdict(tcfg)
    rec["moment_dtype"] = moment_dtype

    views_as_reshapes()
    with fake_process_group(mshape.size):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        counter, info = step_costs(
            cfg, shape_name, mesh=mesh, rules=rules, tcfg=tcfg,
            moment_dtype=moment_dtype, global_batch=shape_cell.global_batch,
            seq_len=shape_cell.seq_len)
        rec["trace_s"] = round(time.time() - t0, 2)
    cost = counter.cost
    rec["memory"] = {"param_bytes": info["param_bytes"],
                     "argument_size_in_bytes": info["input_bytes"],
                     "total_hbm_bytes": int(cost.peak_bytes)}
    rec["cost"] = {"flops": cost.flops, "bytes accessed": cost.hbm_bytes,
                   "ops": cost.n_ops}
    if verbose:
        print(rec["memory"], rec["cost"])
    rep = RL.analyze(cost, arch=arch, shape=shape_name, mesh_name=mesh_name,
                     n_chips=mshape.size,
                     model_flops_total=RL.model_flops(cfg, shape_cell))
    rec["roofline"] = rep.to_dict()
    rec["collective_ops"] = dict(cost.coll_ops)
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t_start, 2)
    return rec


def _result_path(arch, shape, mesh_name, rules):
    sfx = "" if rules == "baseline" else f"__{rules}"
    return os.path.join(results_dir(),
                        f"{arch}__{shape}__{mesh_name}{sfx}.json")


def run_cell(arch, shape, multi_pod, rules="baseline", force=False,
             train_overrides=None) -> Dict[str, Any]:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    path = _result_path(arch, shape, mesh_name, rules)
    prior = None
    if os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
        except ValueError:
            prior = None
        if not isinstance(prior, dict):
            prior = None  # a corrupt file: treat as absent
        # an error record is an environment failure, not a result: never
        # a cache hit, or one bad run poisons every later sweep
        if not force and prior is not None and prior.get("status") != "error":
            return prior
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        rec = lower_cell(arch, shape, multi_pod, rules,
                         train_overrides=train_overrides)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "rules": rules, "status": "error", "error": repr(e),
               "trace": traceback.format_exc()[-4000:]}
    if (rec["status"] == "error" and prior is not None
            and prior.get("status") != "error"):
        # keep the last good record on disk rather than clobbering it
        return rec
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
        f.write("\n")
    return rec


def all_cells():
    out = []
    for arch, cfg in sorted(all_configs().items()):
        for shape in SHAPES:
            out.append((arch, shape, cfg.supports_shape(shape)[0]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="baseline", choices=sorted(RULES))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, ok in all_cells():
            print(f"{arch:24s} {shape:12s} {'run' if ok else 'SKIP'}")
        return

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.sweep:
        cells = [(a, s) for a, s, ok in all_cells() if ok
                 if (args.arch is None or a == args.arch)
                 if (args.shape is None or s == args.shape)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --sweep)")
        cells = [(args.arch, args.shape)]

    t0 = time.time()
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            rec = run_cell(arch, shape, mp, args.rules, force=args.force)
            r = rec.get("roofline", {})
            print(f"[{time.time()-t0:7.1f}s] {arch:24s} {shape:12s} "
                  f"{mesh_name:10s} {rec['status']:5s} "
                  f"trace={rec.get('trace_s', '-')}s "
                  f"bottleneck={r.get('bottleneck', '-')} "
                  f"roofline={r.get('roofline_fraction', 0):.3f}"
                  + (f" ERR={rec.get('error', '')[:120]}"
                     if rec["status"] == "error" else ""),
                  flush=True)


if __name__ == "__main__":
    main()
