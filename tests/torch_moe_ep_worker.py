"""One rank of ``tests/test_torch_moe_ep.py``'s runs of the port's
expert-parallel moe dispatch over a real gloo process group.

    python tests/torch_moe_ep_worker.py MESH RANK WORLD STORE IN OUT

MESH is ``1x1`` (("data", "model") on one rank), ``model2`` (("model",)
on two) or ``2x2`` (("data", "model") on four).  IN is a ``torch.save``
list of cases, each {"mo": the MoE config's fields, "p": one layer's
params, "x": (B, T, D)}; for each, this rank runs ``moe_ffn`` on the
mesh (x sharded over "data" where the mesh has it, replicated over
"model"; on ``2x2`` the params are DTensors placed by the baseline
rules, elsewhere plain tensors, which the dispatch takes as replicated)
and takes the gradients of ``sum(o * o) + aux`` with respect to x and
every param.  On ``1x1`` it also runs the port's sort on plain tensors.
Rank 0 writes the list of results to OUT.
"""
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.train import sharding as SH  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "model2": ((2,), ("model",)),
          "2x2": ((2, 2), ("data", "model"))}


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _run(p, x, mo, impl):
    """out, aux and the gradients of sum(o * o) + aux: {"x": x's, "p":
    the params' in their tree}, all whole tensors."""
    for t in [x] + tree_leaves(p):
        t.requires_grad_(True)
    out, aux = MOE.moe_ffn(p, x, mo, impl=impl)
    out, aux = _whole(out), _whole(aux)
    (out * out).sum().add(aux).backward()
    return {"out": out.detach(), "aux": aux.detach(),
            "grads": {"x": _whole(x.grad),
                      "p": tree_map(lambda t: _whole(t.grad), p)}}


def main(mesh_name, rank, world, store, src, dst):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        dims, names = MESHES[mesh_name]
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        x_pl = [Shard(0) if n == "data" else Replicate() for n in names]
        results = []
        for case in torch.load(src):
            mo = MoECfg(**case["mo"])
            p, x = case["p"], case["x"]
            assert MOE._ep_mesh(distribute_tensor(x, mesh, x_pl), mo) \
                is not None
            if mesh_name == "2x2":
                rules = SH.baseline_rules()
                pl = SH.param_shardings(MOE.moe_specs(mo), p, mesh, rules)
                dp = tree_map(lambda t, q: distribute_tensor(
                    t.detach(), mesh, q), p, pl)
            else:
                dp = tree_map(lambda t: t.detach().clone(), p)
            res = {"ep": _run(dp, distribute_tensor(x, mesh, x_pl), mo,
                              "auto")}
            if mesh_name == "1x1":
                sp = tree_map(lambda t: t.detach().clone(), p)
                res["sort"] = _run(sp, x.clone(), mo, "sort")
            results.append(res)
        if rank == 0:
            torch.save(results, dst)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])
