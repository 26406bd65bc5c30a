"""The recorder of ``tests/test_torch_dryrun_ops.py``: ``OpCosts`` that
keeps the name of every op that reaches DTensor, each add that asks
DTensor to turn a shard into a partial, and each ``index_put`` whose
values are sharded along an indexed dim.  Imported by that test and by
the subprocess in which it traces the cells."""
import math

from torch.distributed.tensor import DTensor

from repro_torch.roofline.op_costs import OpCosts


def shards(t) -> int:
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements) if p.is_shard())


def index_put_on_indexed_dim(dst, indices, values) -> bool:
    """Whether ``values`` of ``index_put(dst, indices, values)`` are
    sharded along a dim that the indices index: the indices' broadcast
    dims lead ``values`` (``values.ndim - dst.ndim + len(indices)`` of
    them, for leading indices as an embedding's backward passes them),
    where torch 2.11's strategy builds a shard of a negative dim."""
    lead = values.ndim - dst.ndim + len(indices)
    return any(p.is_shard() and p.dim < lead for p in values.placements)


def add_turns_shard_partial(a, b) -> bool:
    """Whether ``a + b`` of two DTensors makes DTensor turn a ``Shard``
    operand into a ``Partial``: the operand its pointwise rule follows
    (most shards, then most dims, then the first) is partial on a mesh
    dim where the other is sharded."""
    ds = (a, b)
    f = max((0, 1), key=lambda i: (shards(ds[i]), ds[i].ndim, -i))
    return any(x.is_partial() and y.is_shard() for x, y in
               zip(ds[f].placements, ds[1 - f].placements))


class Recorder(OpCosts):
    """OpCosts that keeps the name of every op on a DTensor in ``ops``
    and each op ``index_put_on_indexed_dim`` or
    ``add_turns_shard_partial`` flags in ``bad``."""
    ops, bad = set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            Recorder.ops.add(str(func))
            ds = [a for a in args if isinstance(a, DTensor)]
            if str(func) == "aten.index_put.default" and \
                    index_put_on_indexed_dim(*args[:3]):
                Recorder.bad.append(str(("index_put", args[2].placements,
                                         tuple(args[2].shape))))
            if str(func) == "aten.add.Tensor" and len(ds) == 2 and \
                    add_turns_shard_partial(*ds):
                Recorder.bad.append(str([(d.placements, tuple(d.shape))
                                         for d in ds]))
        return super().__torch_dispatch__(func, types, args, kwargs)
