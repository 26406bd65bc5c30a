"""Per-rank costs of what a step dispatches: the port's counterpart of
the reference's ``roofline/hlo_costs.py``.

The reference walks the compiled HLO.  The port has no HLO: a step is
the sequence of ATen ops it dispatches, so :class:`OpCosts`, a
``TorchDispatchMode``, counts them as they run, on real, fake or
DTensor operands alike.  Under DTensor it steps aside for the DTensor
op (returning ``NotImplemented``) and counts the ops DTensor runs on
each rank's local shards, with local shapes, so every cost is one
rank's; the ops DTensor's sharding propagation runs on global shapes
to infer metadata are not counted.  It accumulates:

  * flops       — 2·M·N·K per product (``torch.utils.flop_counter``'s
                  formulas: mm, bmm, addmm, baddbmm, convolutions,
                  attention), by operand type, executed-count weighted;
  * hbm_bytes   — the operand and result bytes of every op that is not
                  a view.  Eager PyTorch fuses nothing, so every op
                  reads its operands from and writes its result to
                  memory: this replaces the reference's fusion-boundary
                  rule.  As there, gathers and index reads move only
                  what they read (twice the result), scatters and index
                  writes twice the values written; an operand counts
                  its distinct elements (a broadcast operand once), a
                  factory or an ``*_like`` op its result alone;
  * coll        — each collective's per-rank operand payload by kind
                  (the reference's ``analysis.py:15-19`` convention),
                  where the step calls it: an all-to-all stays one even
                  where a process group runs it another way;
  * peak_bytes  — the peak of the rank's live tensor storage bytes
                  during the count, those alive at its start (or handed
                  to :meth:`OpCosts.track`) included.

Hand-written kernels launch through ``ctypes``, which no dispatch mode
sees: each wrapper reports its launch's work
(:mod:`~repro_torch.roofline.kernel_work`) through
:func:`report_kernel` when a count is under way.  On the host,
:func:`card_kernels` puts stand-ins in the kernels' place in the model
modules: each computes no value, reports the kernel's formula and
dispatches the same ops outside the kernel as the wrapper, so a count
of fake tensors on the host counts the step the card runs.

``OpCosts(tag=True)`` also breaks every cost down by tag: the op and the
innermost ``repro_torch`` functions on the Python stack, the
counterpart of XLA's ``op_name`` (``roofline/attribute.py``).
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
# ops that move no memory: allocation, metadata, synchronisation
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
         "resize_", "_local_scalar_dense", "wait_tensor", "record_stream",
         "is_same_size", "_has_compatible_shallow_copy_type", "size",
         "stride", "storage_offset", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "_to_copy_meta", "copy_meta", "dim",
         "is_contiguous", "device", "layout", "_version", "equal"}
_GATHERS = {"index", "_unsafe_index", "index_select", "gather", "embedding",
            "take", "masked_select", "take_along_dim"}
# in-place index writes: (name, the argument holding the values)
_SCATTERS = {"index_put_": 2, "_index_put_impl_": 2, "index_add_": 3,
             "index_copy_": 3, "scatter_": 3, "scatter_add_": 3,
             "scatter_reduce_": 3, "index_fill_": None, "masked_fill_": None,
             "masked_scatter_": 2}
# write-only ops: their result alone (copy_ reads its source too)
_WRITES = {"fill_", "zero_", "normal_", "uniform_", "random_",
           "bernoulli_", "exponential_", "copy_"}
# the tensor cores' 16-bit rate, or FFMA's
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "bf16",
                torch.float32: "f32"}


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)
    coll_ops: Dict[str, int] = field(default_factory=dict)
    flops_by_type: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    n_ops: int = 0
    peak_bytes: float = 0.0

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def _unique_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements: a broadcast (stride 0)
    dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_view(func) -> bool:
    """The op returns an alias of an operand without writing it."""
    v = getattr(func, "is_view", None)
    if v is not None:
        return v
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and \
        not rets[0].alias_info.is_write


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


# the counts under way, innermost last; a kernel wrapper reports to it
_stack: List["OpCosts"] = []
_in_propagation = 0


def counting() -> bool:
    """True while a count is under way (and not paused)."""
    return bool(_stack) and not _stack[-1]._paused


def report_kernel(name: str, work: Callable[[], tuple]) -> None:
    """One launch of the kernel ``name`` whose work ``work()`` returns
    as ``(flops, bytes, flop_type)`` (:mod:`.kernel_work`); ``work`` runs
    only while a count is under way, its own ops uncounted."""
    if not counting():
        return
    mode = _stack[-1]
    with paused():
        flops, nbytes, ftype = work()
    mode._kernel(name, flops, nbytes, ftype)


@contextlib.contextmanager
def paused():
    """Ops dispatched inside are not counted."""
    if not _stack:
        yield
        return
    mode = _stack[-1]
    was, mode._paused = mode._paused, True
    try:
        yield
    finally:
        mode._paused = was


@contextlib.contextmanager
def _skip_propagation():
    """DTensor's sharding propagation runs ops on global shapes to infer
    the result's metadata; none of them runs on a rank."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:                       # no DTensor in this build
        yield
        return
    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if hasattr(ShardingPropagator, n)][:1] or ["propagate"]
    saved = {n: ShardingPropagator.__dict__[n] for n in names}

    def wrap(fn):
        def inner(*args, **kwargs):
            global _in_propagation
            _in_propagation += 1
            try:
                return fn(*args, **kwargs)
            finally:
                _in_propagation -= 1
        return inner

    for n, fn in saved.items():
        setattr(ShardingPropagator, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _caller_tag(depth: int) -> str:
    """The innermost ``depth`` repro_torch functions on the stack,
    outermost first, this package's own frames skipped."""
    names = []
    f = sys._getframe(2)
    while f is not None and len(names) < depth:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and \
                not mod.startswith("repro_torch.roofline."):
            names.append(f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names)) or "<top>"


class OpCosts(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCosts() as c:`` into
    ``c.cost`` (a :class:`Cost`); with ``tag``, also ``c.by_tag`` =
    {"flops", "bytes", "coll"} -> {tag: value} (tags of ``tag_depth``
    functions)."""

    def __init__(self, tag: bool = False, tag_depth: int = 1):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.cost = Cost()
        self.tag = tag
        self.tag_depth = tag_depth
        self.by_tag: Dict[str, Dict[str, float]] = {
            "flops": {}, "bytes": {}, "coll": {}}
        self._paused = False
        self._dtensor = _dtensor_type()
        self.last_dtensor_op = None     # names the op a failed step reached
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._propagation = _skip_propagation()

    # -- memory ---------------------------------------------------------
    def track(self, tree) -> None:
        """Counts the storages of ``tree``'s tensors (DTensors: their
        local shards) as live from now on."""
        from repro_torch.tree import tree_leaves
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(getattr(t, "_local_tensor", t))

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = id(st)
        if key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self._live_bytes += nbytes
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -- counting -------------------------------------------------------
    def __enter__(self):
        self._propagation.__enter__()
        _stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _stack.remove(self)
            self._propagation.__exit__(None, None, None)

    def _add(self, tag: Optional[str], flops=0.0, nbytes=0.0, ftype=None,
             coll_kind=None, coll_bytes=0.0) -> None:
        c = self.cost
        if flops:
            c.flops += flops
            c.flops_by_type[ftype] = c.flops_by_type.get(ftype, 0.0) + flops
        c.hbm_bytes += nbytes
        if coll_kind:
            c.coll[coll_kind] = c.coll.get(coll_kind, 0.0) + coll_bytes
            c.coll_ops[coll_kind] = c.coll_ops.get(coll_kind, 0) + 1
        if tag is not None:
            for key, v in (("flops", flops), ("bytes", nbytes),
                           ("coll", coll_bytes)):
                if v:
                    d = self.by_tag[key]
                    d[tag] = d.get(tag, 0.0) + v

    def _kernel(self, name, flops, nbytes, ftype) -> None:
        d = self.cost.kernels.setdefault(
            name, {"launches": 0.0, "flops": 0.0, "bytes": 0.0})
        d["launches"] += 1
        d["flops"] += flops
        d["bytes"] += nbytes
        self._add(f"kernel {name}" if self.tag else None, flops, nbytes,
                  ftype)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            # let DTensor run its local ops, then count those
            self.last_dtensor_op = func
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused or _in_propagation:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if name in _FREE or ns == "prim" or _is_view(func):
            return
        self.cost.n_ops += 1
        tag = None
        if self.tag:
            tag = f"{name} | {_caller_tag(self.tag_depth)}"
        if ns in ("_c10d_functional", "c10d") and name in COLLECTIVES:
            payload = sum(_unique_bytes(t) for t in _tensors(args))
            res = sum(_unique_bytes(t) for t in _tensors(out))
            self._add(tag, nbytes=payload + res, coll_kind=COLLECTIVES[name],
                      coll_bytes=payload)
            return
        flops = 0.0
        ftype = None
        fn = self._flop.get(func._overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
            first = next(_tensors(args), None)
            ftype = _DTYPE_NAMES.get(getattr(first, "dtype", None), "other")
        res = list(_tensors(out))
        if name in _GATHERS:
            nbytes = 2 * sum(_unique_bytes(t) for t in res)
        elif name in _SCATTERS:
            at = _SCATTERS[name]
            vals = (args[at] if at is not None and len(args) > at else None)
            nbytes = 2 * (_unique_bytes(vals) if isinstance(
                vals, torch.Tensor) else 0)
            if at is None:                  # a fill under a mask or index
                nbytes = sum(_unique_bytes(t) for t in res)
        elif name in _WRITES or name.endswith("_like") or name.startswith(
                "new_") or not any(True for _ in _tensors(args)):
            nbytes = sum(_unique_bytes(t) for t in res)
            if name == "copy_":
                nbytes += _unique_bytes(args[1])
        else:
            nbytes = sum(_unique_bytes(t) for t in _tensors(args)) + \
                sum(_unique_bytes(t) for t in res)
            for v in kwargs.values():
                nbytes += sum(_unique_bytes(t) for t in _tensors(v))
        self._add(tag, flops, float(nbytes), ftype)
        if not name.endswith("_"):
            for t in res:
                self._track(t)


# ----------------------------------------------------------------------
# the card's kernels on the host
# ----------------------------------------------------------------------
@contextlib.contextmanager
def card_kernels():
    """Inside, the models' kernel entry points (flash attention, the
    RG-LRU scan, the sLSTM recurrence) are stand-ins that take the
    path the card takes: each reports its kernel's work
    (:func:`report_kernel`) where the card's wrapper would launch, and
    returns outputs of the right shapes without computing a value (for
    fake tensors), running the same ops outside the kernel as the
    wrapper (the RoPE operands joined under grad, the sLSTM backward's
    dr and dh0 products)."""
    from repro_torch.models import layers as LY
    from repro_torch.models import mla as MLA
    from repro_torch.models import rglru as RG
    from repro_torch.models import xlstm as XL

    saved = (LY.flash_attention, MLA.flash_attention, RG.rglru_scan,
             XL.slstm_scan)
    LY.flash_attention = MLA.flash_attention = _flash_stand_in
    RG.rglru_scan = _rglru_stand_in
    XL.slstm_scan = _slstm_stand_in
    try:
        yield
    finally:
        (LY.flash_attention, MLA.flash_attention, RG.rglru_scan,
         XL.slstm_scan) = saved


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _flash_shape(q, k, v, window, shared_k=0, with_lse=False):
    """flash_fwd's arguments for queries at 0..T-1; ``shared_k`` RoPE
    columns beside q's and k's own."""
    from . import kernel_work as KW
    B, T, Hq, Dh = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    pairs, rows = KW.visible_from_zero(B, T, S, window)
    return (B, T, S, Hq, Hkv, Dh + shared_k, Dv, q.element_size(), pairs,
            rows, shared_k, with_lse)


class _FlashStandIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        from . import kernel_work as KW
        a = _flash_shape(q, k, v, window, with_lse=True)
        report_kernel("flash_attn_hd", lambda: KW.flash_fwd(*a))
        ctx.a = a
        ctx.save_for_backward(q, k, v)
        return q.new_empty((*q.shape[:3], v.shape[3]))

    @staticmethod
    def backward(ctx, dout):
        from . import kernel_work as KW
        q, k, v = ctx.saved_tensors
        B, T, S, Hq, Hkv, Dh, Dv, isz, pairs = ctx.a[:9]
        report_kernel("flash_attn_bwd_hd", lambda: KW.flash_bwd(
            B, T, S, Hq, Hkv, Dh, Dv, isz, pairs))
        return q.new_empty(q.shape), k.new_empty(k.shape), \
            v.new_empty(v.shape), None


def _flash_stand_in(q, k, v, *, qpos, window=None, softcap=0.0, scale=None,
                    impl="auto", out=None, q_rope=None, k_rope=None,
                    **unused):
    """``flash_attention`` as the card runs it (``impl='auto'`` on a
    CUDA tensor), for queries at positions 0..T-1."""
    from repro_torch.kernels.flash_attention.ref import join_rope

    from . import kernel_work as KW
    if _needs_grad(q, k, v, q_rope, k_rope):
        if q_rope is not None:
            q, k = join_rope(q, k, q_rope, k_rope)
        return _FlashStandIn.apply(q, k, v, window)
    from repro_torch.kernels.flash_attention.kernel import (
        WGMMA_ROPE_SPLIT, flash_variant)
    shared = 0
    if q_rope is not None:
        Dr = q_rope.shape[-1]
        # the wgmma kernel at 192 / 128 reads the RoPE operands in place;
        # the wrapper joins any other split first
        if flash_variant(q.dtype, q.shape[-1] + Dr, v.shape[-1]) == \
                "wgmma" and (q.shape[-1], Dr) == WGMMA_ROPE_SPLIT:
            shared = Dr
        else:
            q, k = join_rope(q, k, q_rope, k_rope)
    a = _flash_shape(q, k, v, window, shared)
    report_kernel("flash_attn_hd", lambda: KW.flash_fwd(*a))
    o = q.new_empty((*q.shape[:3], v.shape[3]))
    return o if out is None else out.copy_(o)


class _RglruStandIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_in, gate_a, gate_i, lam, h0):
        from . import kernel_work as KW
        B, T, W = x_in.shape
        report_kernel("rglru_scan", lambda: KW.rglru_fwd(
            B, T, W, x_in.element_size(), h0 is not None))
        ctx.save_for_backward(x_in, gate_a, gate_i, lam, h0)
        return x_in.new_empty((B, T, W), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        from . import kernel_work as KW
        x_in, gate_a, gate_i, lam, h0 = ctx.saved_tensors
        B, T, W = x_in.shape
        report_kernel("rglru_scan_bwd", lambda: KW.rglru_bwd(
            B, T, W, x_in.element_size(), h0 is not None))
        return (x_in.new_empty(x_in.shape), gate_a.new_empty(gate_a.shape),
                gate_i.new_empty(gate_i.shape), lam.new_empty(lam.shape),
                None if h0 is None else h0.new_empty(h0.shape))


def _rglru_stand_in(x_in, gate_a, gate_i, lam, h0=None):
    """``rglru_scan`` as the card runs it."""
    from . import kernel_work as KW
    if _needs_grad(x_in, gate_a, gate_i, lam, h0):
        return _RglruStandIn.apply(x_in, gate_a, gate_i, lam, h0)
    B, T, W = x_in.shape
    report_kernel("rglru_scan", lambda: KW.rglru_fwd(
        B, T, W, x_in.element_size(), h0 is not None))
    return x_in.new_empty((B, T, W), dtype=torch.float32)


class _SlstmStandIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre_x, r, c0, n0, h0, m0):
        from . import kernel_work as KW
        B, T, D4 = pre_x.shape
        D, H = D4 // 4, r.shape[0]
        report_kernel("slstm_scan", lambda: KW.slstm_fwd(
            B, T, D, H, pre_x.element_size(), saving=True))
        hs = pre_x.new_empty((B, T, D), dtype=torch.float32)
        ctx.save_for_backward(r, hs, h0)
        ctx.pre_dtype = pre_x.dtype
        return (hs, *(pre_x.new_empty((B, D), dtype=torch.float32)
                      for _ in range(4)))

    @staticmethod
    def backward(ctx, dhs, *dfinal):
        from . import kernel_work as KW
        r, hs, h0 = ctx.saved_tensors
        B, T, D = hs.shape
        H, Dh, E = r.shape
        report_kernel("slstm_scan_bwd", lambda: KW.slstm_bwd(B, T, D, H))
        dpre = hs.new_empty((B, T, 4 * D))
        # the wrapper's dr and dh0 products (SlstmScanFunction.backward)
        first = torch.zeros_like(hs[:, :1]) if h0 is None else \
            h0[:, None].float()
        h_prev = torch.cat([first, hs[:, :-1]], 1).reshape(B * T, H, Dh)
        dr = torch.einsum("nhd,nhe->hde", h_prev, dpre.reshape(B * T, H, E))
        grads = (None,) * 4
        if h0 is not None:
            dh0 = torch.einsum("bhe,hde->bhd", dpre[:, 0].reshape(B, H, E),
                               r).reshape(B, D)
            grads = (hs.new_empty((B, D)), hs.new_empty((B, D)), dh0,
                     hs.new_empty((B, D)))
        return (dpre.to(ctx.pre_dtype), dr, *grads)


def _slstm_stand_in(pre_x, r, state=None, out=None):
    """``slstm_scan`` as the card runs it."""
    from . import kernel_work as KW
    if _needs_grad(pre_x, r, *(state or ())):
        hs, *fin = _SlstmStandIn.apply(pre_x, r, *(state or (None,) * 4))
        return hs, tuple(fin)
    B, T, D4 = pre_x.shape
    D = D4 // 4
    report_kernel("slstm_scan", lambda: KW.slstm_fwd(
        B, T, D, r.shape[0], pre_x.element_size()))
    hs = pre_x.new_empty((B, T, D), dtype=torch.float32)
    fin = tuple(pre_x.new_empty((B, D), dtype=torch.float32)
                for _ in range(4)) if out is None else out
    return hs, fin


__all__ = ["COLLECTIVES", "Cost", "OpCosts", "card_kernels", "counting",
           "paused", "report_kernel"]
