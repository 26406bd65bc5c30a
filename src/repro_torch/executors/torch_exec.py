"""TorchExecutor — the HDArray executor on one CUDA card (or the CPU).

The counterpart of the reference package's resident ``JaxExecutor``.

**Residency.**  Each HDArray lives as ONE ``(nproc, *shape)`` tensor on
``device``: the ``nproc`` logical ranks share one card, as the
reference fakes ``nproc`` host devices on one CPU, and every rank
holds a full-size buffer (paper ``HDArrayCreate``).  The numpy host
mirrors of the Sim layout are a lazy, dirty-tracked cache that
materializes only on ``sync_host`` — for an unmarked host kernel or
the reduce's local fold.  ``write`` uploads the user array once and
scatters each rank's sections on the device; ``read`` assembles the
requested sections on the device and downloads one array.
``h2d_transfers`` / ``d2h_transfers`` count these full-buffer
crossings, so a test can assert that a steady pipeline moves none.

**Copy schedule.**  Every CommKind (ALL_GATHER, HALO, ALL_TO_ALL,
P2P) lowers to device-to-device section copies inside the array's
tensor: message ``(src, dst, box)`` is ``t[dst][box] = t[src][box]``.
The copies run in the Sim oracle's order.  The planner never makes a
device send a box it also receives in the same plan (at most one
device holds the pending coherent copy of an element,
``HDArray._supersede``), so this order gives the same bytes as the
reference's collect-every-payload-then-apply order.
``copy_counts`` counts the copied boxes per kind, in place of the
reference's per-collective counts.

**Kernels.**  A :func:`~repro_torch.executors.kernels.device_kernel`
runs once per rank on that rank's view of the resident tensors
(``device_kernel_launches`` counts one per step, as the reference
does); a rank only ever touches its own view, so ranks stay isolated
as in the OpenCL model.  Unmarked host kernels mutate the numpy
mirrors after a ``sync_host``, and the arrays they define re-upload on
their next device use.

**One-program steps.**  ``execute_step`` runs a step whose kernel is
device-marked (and whose ``kw`` hashes) as ONE program: the copies and
the kernel sweeps.  When the plan admits the exact halo split
(:func:`~repro_torch.executors.overlap.halo_split`) the interior sweep
is issued first and the copies on a forked side stream that joins back
before the boundary sweeps, so the card runs them side by side.  On a
card the program is a CUDA graph, captured once per step signature
(kernel, kw, regions, the arrays' names, shapes, dtypes and resident
``data_ptr()``s, the message groups and the split) and replayed.  The
first run of each step signature is eager: it is the warm-up PyTorch
asks for before a capture, so that whatever a device kernel initialises
at first use (library handles, workspaces, module loads) happens
outside the graph.  ``capture_cycle`` does the same for a
steady pipeline period (one graph, replayed ``reps`` times in one host
call).  On the CPU the same steps run eagerly in the same order.  A
failed capture, instantiate or replay raises: nothing falls back.

**Per-rank times.**  While ``time_ranks`` is set (the runtime sets it
while a ``Rebalancer`` or a ``StragglerMonitor`` reads the times), a
device-kernel step runs unfused: the copies, then each rank's sweep
between two CUDA events on the current stream, each after a short
spin of the card that lets the host enqueue the rank's launches first
(the host clock on the CPU, where the Sim oracle's ``rank_cost``
slowdown model applies too),
and ``last_rank_times`` holds the seconds per rank once the step's
events are read.  Otherwise ``last_rank_times`` stays None: a fused
program cannot be timed per rank.

**Elasticity.**  ``drop_rank`` and ``add_rank`` poison and zero the
rank's slice in place, and a checkpoint restore writes in place, so
no resident tensor moves and a captured graph's addresses stay valid;
a mesh change drops the graphs naming the array, since the new
partitions make new step signatures.

**Overlap.**  Under :class:`~repro_torch.executors.overlap.
OverlapScheduler` the comm thread's copies run inside a fence from
:meth:`TorchExecutor.comm_fence`: on the card, on a comm stream of
their own, ordered against the host thread's stream by CUDA events.

**Reductions** fold on the host mirrors after one ``sync_host`` and
combine with the Sim left fold, so a reduce is bit-identical to the
oracle's.  A fold on the device would change the summation order.
"""
from __future__ import annotations

import threading
import time
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, NamedTuple,
                    Optional, Sequence, Set, Tuple)

import numpy as np
import torch

from repro_torch.kernels import counts

from .base import register_executor
from .kernels import resolve_kernel
from .overlap import halo_split
from .sim import SimExecutor

if TYPE_CHECKING:
    from repro_torch.core.hdarray import HDArray
    from repro_torch.core.planner import CommKind, CommPlan
    from repro_torch.core.sections import Box, SectionSet

# CommKind values that carry section messages
_COPY_KINDS = ("all_gather", "halo", "all_to_all", "p2p")

# (array, [((src, dst), sections), ...], copy kind): one array's messages
Group = Tuple["HDArray", List[Tuple[Tuple[int, int], "SectionSet"]], str]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype a numpy dtype is stored as: its own, except that
    an unsigned integer wider than a byte is kept as the signed one of
    its size, bit for bit (torch's uint16/32/64 take few operations;
    bfloat16 data arrives as np.uint16 bits)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "u" and dtype.itemsize > 1:
        dtype = np.dtype(f"i{dtype.itemsize}")
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _as_stored(data: np.ndarray) -> np.ndarray:
    """``data`` viewed as the numpy type of its torch storage."""
    if data.dtype.kind == "u" and data.dtype.itemsize > 1:
        return data.view(f"i{data.dtype.itemsize}")
    return data


# the signed type that holds every value of an unsigned one, and the
# mask that reads the stored signed bits as that value
_WIDE = {2: (torch.int32, 0xFFFF), 4: (torch.int64, 0xFFFFFFFF)}


def kernel_view(stored: torch.Tensor, dtype) -> torch.Tensor:
    """What a device kernel sees of a rank's buffer of numpy ``dtype``:
    the stored tensor itself, except for uint16 and uint32, which are
    stored as signed bits and handed over as their values widened to
    int32 and int64 (a new tensor; the executor narrows what the kernel
    defines back into the storage, bit for bit).  So ``//``, shifts,
    comparisons, min/max and casts see the unsigned values, as on the
    Sim oracle's numpy buffers.  uint64 has no wider type: raises
    NotImplementedError."""
    dtype = np.dtype(dtype)
    if dtype.kind != "u" or dtype.itemsize == 1:
        return stored
    if dtype.itemsize not in _WIDE:
        raise NotImplementedError(
            f"device kernels on {dtype} arrays: torch has no signed type "
            f"wider than int64 to hold their values (run a host kernel)")
    wide, mask = _WIDE[dtype.itemsize]
    return stored.to(wide).bitwise_and_(mask)


class _Step(NamedTuple):
    """One step of a one-program run, ready to issue."""
    groups: List[Group]
    kernel: Optional[Callable]
    kw: Dict
    regions: List["Box"]
    arrays: Sequence["HDArray"]
    split: Optional[Tuple]           # halo_split's (interior, boundary)
    key: Tuple                       # the step's signature
    traffic: Set[str]                # names of the arrays with messages


class _Graph(NamedTuple):
    """A captured program and what one replay of it does."""
    graph: Any                       # torch.cuda.CUDAGraph
    tally: counts.Tally              # kernel launches per replay
    touched: frozenset               # arrays it writes
    names: frozenset                 # arrays it names


class _CommFence:
    """Orders one plan's copies, issued by the overlap scheduler's comm
    thread on the comm stream, against the host thread's stream.

    Made on the host thread when the plan is handed over: the copies
    wait for everything the host thread had issued by then (the last
    kernel may define what they move).  After :meth:`join`, on the host
    thread, its stream waits for the copies.  The copies allocate
    nothing on either stream (views and ``copy_`` only), so no tensor
    needs ``record_stream``."""

    def __init__(self, comm: "torch.cuda.Stream",
                 host: "torch.cuda.Stream") -> None:
        self._comm, self._host = comm, host
        self._issued = torch.cuda.Event()
        self._issued.record(host)
        self._moved = torch.cuda.Event()
        self._ctx = None

    def __enter__(self) -> None:
        self._comm.wait_event(self._issued)
        self._ctx = torch.cuda.stream(self._comm)
        self._ctx.__enter__()

    def __exit__(self, *exc) -> None:
        self._ctx.__exit__(*exc)
        self._moved.record(self._comm)

    def join(self) -> None:
        self._host.wait_event(self._moved)


@register_executor("torch")
class TorchExecutor(SimExecutor):
    """Executes plans over device-resident ``(nproc, *shape)`` tensors."""

    #: time each rank's kernel sweep (see the module docstring)
    time_ranks = False
    #: cycles the card spins before each rank's first event in a timed
    #: step (about 0.5 ms on an H100), so that the host enqueues that
    #: rank's launches while the card is busy: without it a rank whose
    #: predecessor finished first would count the host's launch latency
    HEAD_START_CYCLES = 1 << 20

    def __init__(self, nproc: Optional[int] = None,
                 device: str = "cuda") -> None:
        super().__init__(nproc=nproc)
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchExecutor runs on 'cuda' or 'cpu', "
                             f"not {device!r}")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchExecutor(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run on the host")
        if dev.type == "cuda" and dev.index is None:
            # "cuda" names the current card; tensors on it say "cuda:N"
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.device_class = dev.type
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.device_kernel_launches = 0
        self.copy_counts: Dict[str, int] = dict.fromkeys(_COPY_KINDS, 0)
        self._device: Dict[str, torch.Tensor] = {}
        self._device_ok: Dict[str, bool] = {}
        self._host_ok: Dict[str, bool] = {}
        # the overlap scheduler's comm thread and the host thread both
        # move data and flip the residency flags
        self._lock = threading.RLock()
        self._streams: Dict[str, "torch.cuda.Stream"] = {}
        self._graphs: Dict[Tuple, _Graph] = {}
        self._warm: Set[Tuple] = set()   # step signatures run eagerly once
        self._splits: Dict[Tuple, Any] = {}

    # -- lifecycle ------------------------------------------------------
    def allocate(self, arr: "HDArray") -> None:
        self._drop_graphs(arr.name)
        self._device[arr.name] = torch.zeros(
            (arr.nproc,) + arr.shape, dtype=torch_dtype(arr.dtype),
            device=self.device)
        self.buffers[arr.name] = None     # mirrors materialize on sync_host
        self._device_ok[arr.name] = True
        self._host_ok[arr.name] = False

    def free(self, arr: "HDArray") -> None:
        super().free(arr)
        self._drop_graphs(arr.name)
        self._device.pop(arr.name, None)
        self._device_ok.pop(arr.name, None)
        self._host_ok.pop(arr.name, None)

    def drop_rank(self, arr: "HDArray", rank: int) -> None:
        """Device ``rank`` died: poison its buffer (NaN for float
        arrays, as the Sim oracle does) on the device."""
        dev = self._device.get(arr.name)
        if dev is None:
            return
        self.sync_device(arr)
        dev[rank].fill_(float("nan") if dev.is_floating_point() else 0)
        self._host_ok[arr.name] = False
        self._drop_graphs(arr.name)

    def add_rank(self, arr: "HDArray", rank: int) -> None:
        """Device ``rank`` (re)joined: its buffer restarts zeroed; only
        planned traffic may fill it."""
        dev = self._device.get(arr.name)
        if dev is None:
            return
        self.sync_device(arr)
        dev[rank].zero_()
        self._host_ok[arr.name] = False
        self._drop_graphs(arr.name)

    # -- residency hooks (Executor protocol) ----------------------------
    def sync_host(self, arr: "HDArray") -> None:
        """Materialize the host mirrors from the resident tensor (one
        d2h when the device copy is newer; no-op otherwise)."""
        name = arr.name
        with self._lock:
            if self._host_ok[name]:
                return
            comm = self._streams.get("comm")
            if comm is not None:       # copies the comm thread issued
                torch.cuda.current_stream(self.device).wait_stream(comm)
            stacked = self._device[name].to("cpu", copy=True).numpy()
            stacked = stacked.view(arr.dtype)
            self.buffers[name] = list(stacked)   # per-rank writable views
            self._host_ok[name] = True
            self.d2h_transfers += 1

    def sync_device(self, arr: "HDArray") -> None:
        """Upload the host mirrors into the resident tensor (one h2d
        when the mirrors are newer; no-op otherwise)."""
        name = arr.name
        with self._lock:
            if self._device_ok[name]:
                return
            dev = self._device[name]
            for p, buf in enumerate(self.buffers[name]):
                dev[p].copy_(torch.from_numpy(_as_stored(buf)))
            self._device_ok[name] = True
            self.h2d_transfers += 1

    # -- controller I/O -------------------------------------------------
    def write(self, arr: "HDArray", data,
              per_device: Sequence["SectionSet"]) -> None:
        """Scatter ``data`` into each rank's sections, in place.  A
        numpy array is uploaded once (one h2d); a tensor already on
        this executor's device, of the storage dtype (``torch_dtype``),
        is copied on the device and counts no transfer."""
        dev = self._device[arr.name]
        if isinstance(data, torch.Tensor):
            if data.device != self.device or data.dtype != dev.dtype:
                raise ValueError(
                    f"write into {arr.name!r} takes a {dev.dtype} tensor "
                    f"on {self.device}, not {data.dtype} on {data.device}")
            src = data
        else:
            src = None
            data = np.ascontiguousarray(data, dtype=arr.dtype)
        if tuple(data.shape) != arr.shape:
            raise ValueError(f"write of shape {tuple(data.shape)} into "
                             f"{arr.name!r} of shape {arr.shape}")
        self.sync_device(arr)
        if src is None:
            src = torch.from_numpy(_as_stored(data)).to(self.device)
            self.h2d_transfers += 1
        for p, secs in enumerate(per_device):
            for sl in secs.iter_slices():
                dev[p][sl] = src[sl]
        self._host_ok[arr.name] = False

    def read(self, arr: "HDArray",
             per_device: Sequence["SectionSet"]) -> np.ndarray:
        if self._host_ok[arr.name]:
            return super().read(arr, per_device)
        out = self.read_tensor(arr, per_device)
        self.d2h_transfers += 1
        return out.cpu().numpy().view(arr.dtype)

    def read_tensor(self, arr: "HDArray",
                    per_device: Sequence["SectionSet"]) -> torch.Tensor:
        """``read`` without the download: the sections assembled into a
        new tensor of the storage dtype on this executor's device."""
        self.sync_device(arr)
        dev = self._device[arr.name]
        out = torch.zeros(arr.shape, dtype=dev.dtype, device=self.device)
        for p, secs in enumerate(per_device):
            for sl in secs.iter_slices():
                out[sl] = dev[p][sl]
        return out

    # -- protocol: message execution ------------------------------------
    def execute_messages(self, arr: "HDArray",
                         messages: Dict[Tuple[int, int], "SectionSet"],
                         kind: Optional["CommKind"] = None) -> None:
        if not messages:
            return
        group = [(arr, list(messages.items()), self._copy_kind(kind))]
        with self._lock:
            self.sync_device(arr)
            self._copy(group)
            self._account(group)
            self._host_ok[arr.name] = False

    def comm_fence(self, plan: "CommPlan",
                   arrays_by_name: Dict[str, "HDArray"]
                   ) -> Optional[_CommFence]:
        """The overlap scheduler's hook, called on the host thread just
        before it hands ``plan`` to its comm thread.  On a card: upload
        what the plan moves (on the host thread's stream, so the comm
        thread's copies and the host thread's kernels see one order)
        and return the fence the copies run in.  None on the CPU."""
        if self.device.type != "cuda":
            return None
        for ap in plan.arrays:
            if ap.messages:
                self.sync_device(arrays_by_name[ap.array])
        return _CommFence(self._stream("comm"),
                          torch.cuda.current_stream(self.device))

    # -- kernels --------------------------------------------------------
    def run_kernel(self, kernel, part_regions, arrays,
                   defs: Optional[Sequence[str]] = None, **kw) -> None:
        """Device kernels run on per-rank views of the resident
        tensors; anything else runs on the host mirrors (Sim
        semantics), after which only the arrays in ``defs`` (all
        touched arrays without it) must re-upload."""
        kernel = resolve_kernel(kernel, self.device_class)
        if getattr(kernel, "__hdarray_device__", False):
            self._run_device_kernel(kernel, part_regions, arrays, kw)
            return
        for a in arrays:
            self.sync_host(a)
        super().run_kernel(kernel, part_regions, arrays, **kw)
        stale = set(defs) if defs is not None else {a.name for a in arrays}
        for a in arrays:
            if a.name in stale:
                self._device_ok[a.name] = False

    def _run_device_kernel(self, kernel, part_regions, arrays, kw) -> None:
        for a in arrays:
            self.sync_device(a)
        boxes = [(r,) for r in part_regions]
        if self.time_ranks:
            defined = self._timed_sweep(kernel, boxes, arrays, kw)
        else:
            self.last_rank_times = None
            defined = self._sweep(kernel, boxes, arrays, kw)
        for name in defined:
            self._host_ok[name] = False
        self.device_kernel_launches += 1

    def _timed_sweep(self, kernel, boxes_per_rank, arrays, kw) -> Set[str]:
        """:meth:`_sweep` one rank at a time, each rank's launches
        between two CUDA events (the host clock on the CPU, plus the
        ``rank_cost`` model's busy time as in the Sim oracle); sets
        ``last_rank_times`` in seconds, 0.0 for a rank with no work."""
        cuda = self.device.type == "cuda"
        n = len(boxes_per_rank)
        marks: List[Any] = [None] * n
        defined: Set[str] = set()
        for p, boxes in enumerate(boxes_per_rank):
            volume = sum(b.volume() for b in boxes if not b.is_empty())
            if not volume:
                continue
            one = [()] * n
            one[p] = boxes
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(self.HEAD_START_CYCLES)
                start.record()
                defined |= self._sweep(kernel, one, arrays, kw)
                end.record()
                marks[p] = (start, end)
                continue
            t0 = time.perf_counter()
            defined |= self._sweep(kernel, one, arrays, kw)
            cost = self.rank_cost.get(p)
            if cost:
                # busy-wait, as the Sim oracle does
                target = t0 + cost * volume
                while time.perf_counter() < target:
                    pass
            marks[p] = time.perf_counter() - t0
        times = [0.0] * n
        for p, m in enumerate(marks):
            if m is None:
                continue
            if cuda:
                m[1].synchronize()
                times[p] = m[0].elapsed_time(m[1]) / 1e3
            else:
                times[p] = m
        self.last_rank_times = tuple(times)
        return defined

    def _sweep(self, kernel, boxes_per_rank, arrays, kw) -> Set[str]:
        """Issue ``kernel`` over each rank's boxes on that rank's views
        (:func:`kernel_view`: unsigned arrays widened); returns the
        names it defined."""
        defined: Set[str] = set()
        for p, boxes in enumerate(boxes_per_rank):
            bufs = None
            for box in boxes:
                if box.is_empty():
                    continue
                if bufs is None:
                    bufs = {a.name: kernel_view(self._device[a.name][p],
                                                a.dtype) for a in arrays}
                res = kernel(box, bufs, **kw) or {}
                for name, val in res.items():
                    stored = self._device[name][p]
                    if val is not stored:     # a new tensor or a widened put
                        stored.copy_(val)     # narrows to the stored bits
                    defined.add(name)
        return defined

    # -- one-program steps and captured cycles --------------------------
    def execute_step(self, plan, arrays_by_name, kernel, part_regions,
                     arrays, uses=None, defs=None, kw=None) -> bool:
        """One apply_kernel step as ONE program (see the module
        docstring): a CUDA graph on a card, the same copies and sweeps
        in the same order on the CPU.  Fuses only a ``device_kernel``
        whose ``kw`` hashes and returns True; anything else takes the
        classic two-phase path and returns False."""
        kw = kw or {}
        kernel = resolve_kernel(kernel, self.device_class)
        if self.time_ranks or kernel is None or not getattr(
                kernel, "__hdarray_device__", False):
            return super().execute_step(
                plan, arrays_by_name, kernel, part_regions, arrays,
                uses=uses, defs=defs, kw=kw)
        try:
            step = self._step(plan, arrays_by_name, kernel, kw,
                              part_regions, arrays, uses, defs)
        except TypeError:                  # kw does not hash
            return super().execute_step(
                plan, arrays_by_name, kernel, part_regions, arrays,
                uses=uses, defs=defs, kw=kw)
        self._run_program("step", [step], list(arrays), 1)
        return True

    def capture_cycle(self, cycle, reps: int) -> Optional[Callable]:
        """Capture a steady pipeline period (each step a dict with keys
        ``plan`` / ``kernel`` / ``regions`` / ``arrays`` / ``uses`` /
        ``defs`` / ``kw``, see ``HDArrayRuntime._run_pipeline_serial``)
        over the union of its arrays, and return a runner that executes
        ``reps`` periods in one host call.  None when a kernel is not
        device-marked or a ``kw`` does not hash, as in the reference.

        On a card the runner replays ONE graph of one period ``reps``
        times.  A graph of the whole window would take as long to
        capture as the window takes to run eagerly, hold ``reps`` times
        the nodes, and be keyed by ``reps``; one period is captured in
        the time of two steps and serves every window of that cycle.
        The graph is cached under a ``("scan", ...)`` key.  On the CPU
        the runner issues the same steps eagerly."""
        if reps < 1 or not cycle:
            return None
        resolved = [resolve_kernel(st["kernel"], self.device_class)
                    for st in cycle]
        if any(k is not None and not getattr(k, "__hdarray_device__", False)
               for k in resolved):
            return None
        union: List["HDArray"] = []        # first-seen order
        for st in cycle:
            for a in st["arrays"]:
                if all(a.name != u.name for u in union):
                    union.append(a)
        by_name = {a.name: a for a in union}
        try:
            steps = [self._step(st["plan"], by_name, kernel,
                                st.get("kw") or {}, st["regions"],
                                st["arrays"], st["uses"], st["defs"])
                     for st, kernel in zip(cycle, resolved)]
        except TypeError:
            return None

        def run() -> None:
            self._run_program("scan", steps, union, reps)

        return run

    def _step(self, plan, by_name, kernel, kw, regions, arrays, uses,
              defs) -> _Step:
        kw_key = tuple(sorted(kw.items()))
        hash((kernel, kw_key))             # TypeError: not capturable
        groups = [(by_name[ap.array], sorted(ap.messages.items()),
                   self._copy_kind(ap.kind))
                  for ap in plan.arrays if ap.messages]
        gsig = tuple((arr.name, kind, tuple(msgs))
                     for arr, msgs, kind in groups)
        regions = list(regions)
        rsig = tuple(r.bounds for r in regions)
        split = None
        if kernel is not None and groups and uses is not None \
                and defs is not None:
            split = self._halo_split(plan, regions, uses, defs, gsig, rsig)
        skey = None if split is None else tuple(
            tuple(tuple(b.bounds for b in boxes) for boxes in half)
            for half in split)
        return _Step(groups, kernel, kw, regions, arrays, split,
                     (kernel, kw_key, rsig, gsig, skey),
                     {arr.name for arr, _m, _k in groups})

    def _halo_split(self, plan, regions, uses, defs, gsig, rsig):
        """:func:`halo_split`, memoized per step signature: it is pure
        section algebra over a steady plan, and computed fresh it costs
        more host time than the step's launches."""
        try:
            skey = (gsig, rsig, tuple(sorted(uses.items())),
                    tuple(sorted(defs.items())))
            return self._splits[skey]
        except KeyError:
            split = self._splits[skey] = halo_split(plan, regions, uses,
                                                    defs)
            return split
        except TypeError:                  # unhashable Access values
            return halo_split(plan, regions, uses, defs)

    def _run_program(self, tag: str, steps: List[_Step],
                     arrays: Sequence["HDArray"], reps: int) -> None:
        """Run ``reps`` repetitions of ``steps`` as one program and
        account them as that many unfused steps."""
        self.last_rank_times = None      # one program, no per-rank timing
        for a in arrays:
            self.sync_device(a)
        if self.device.type == "cuda" and all(
                st.key in self._warm for st in steps):
            key = (tag, tuple(st.key for st in steps),
                   tuple((a.name, a.shape, a.dtype.str,
                          self._device[a.name].data_ptr()) for a in arrays))
            prog = self._graphs.get(key)
            if prog is None:
                prog = self._graphs[key] = self._capture(steps, arrays)
            for _ in range(reps):
                prog.graph.replay()
            counts.add_replays(prog.tally, reps)
            touched = prog.touched
        else:
            # the CPU; on a card the first run of a step signature, the
            # warm-up before its capture
            touched = set()
            for _ in range(reps):
                for st in steps:
                    touched |= self._issue(st)
            self._warm.update(st.key for st in steps)
        for name in touched:
            self._host_ok[name] = False
        for st in steps:
            self._account(st.groups, reps)
            if st.kernel is not None:
                self.device_kernel_launches += reps

    def _capture(self, steps: List[_Step],
                 arrays: Sequence["HDArray"]) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        touched: Set[str] = set()
        with counts.recording() as tally:
            with torch.cuda.graph(graph, stream=self._stream("capture")):
                for st in steps:
                    touched |= self._issue(st)
        return _Graph(graph, list(tally), frozenset(touched),
                      frozenset(a.name for a in arrays))

    def _issue(self, st: _Step) -> Set[str]:
        """Issue one step on the current stream: the copies, then the
        kernel; with a halo split, the interior sweep beside the copies
        (on a card the copies go on a side stream forked before the
        interior sweep and joined before the boundary sweeps).  Returns
        the names it writes."""
        touched = set(st.traffic)
        if st.split is None:
            self._copy(st.groups)
            if st.kernel is not None:
                touched |= self._sweep(st.kernel, [(r,) for r in st.regions],
                                       st.arrays, st.kw)
            return touched
        interior, boundary = st.split
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            side = self._stream("side")
            side.wait_stream(cur)
            touched |= self._sweep(st.kernel, interior, st.arrays, st.kw)
            with torch.cuda.stream(side):
                self._copy(st.groups)
            cur.wait_stream(side)
        else:
            touched |= self._sweep(st.kernel, interior, st.arrays, st.kw)
            self._copy(st.groups)
        touched |= self._sweep(st.kernel, boundary, st.arrays, st.kw)
        return touched

    def _copy(self, groups: List[Group]) -> None:
        """Issue each message as section copies on the current stream:
        views and ``copy_`` only, nothing allocated."""
        for arr, msgs, _kind in groups:
            dev = self._device[arr.name]
            for (src, dst), secs in msgs:
                s, d = dev[src], dev[dst]
                for sl in secs.iter_slices():
                    d[sl] = s[sl]

    def _account(self, groups: List[Group], reps: int = 1) -> None:
        """Count ``reps`` executions of the groups' messages: payload
        bytes, and one message and one copy per box."""
        for arr, msgs, kind in groups:
            for _pair, secs in msgs:
                n = reps * len(secs)
                self.bytes_moved += reps * secs.volume() * arr.itemsize
                self.messages_executed += n
                self.copy_counts[kind] += n

    # -- helpers --------------------------------------------------------
    @staticmethod
    def _copy_kind(kind: Optional["CommKind"]) -> str:
        key = kind.value if kind is not None else "p2p"
        return key if key in _COPY_KINDS else "p2p"

    def _stream(self, name: str) -> "torch.cuda.Stream":
        stream = self._streams.get(name)
        if stream is None:
            stream = self._streams[name] = torch.cuda.Stream(self.device)
        return stream

    def _drop_graphs(self, name: str) -> None:
        """Forget every graph that names array ``name``: its tensor is
        going, and the allocator may hand its addresses to another; or
        its mesh changed, which leaves the old step signatures behind."""
        self._graphs = {k: g for k, g in self._graphs.items()
                        if name not in g.names}

    # -- reductions -----------------------------------------------------
    def reduce_local(self, arr: "HDArray", per_device, op: str):
        """The local fold runs on the host mirrors, exactly like the
        Sim oracle — one d2h sync when the resident copy is newer."""
        self.sync_host(arr)
        return super().reduce_local(arr, per_device, op)
