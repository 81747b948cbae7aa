"""Machine-independent µ-op trace IR, lowered from ATen ops.

:class:`TraceOp`, :class:`TraceRegion` and :class:`Trace` are
``repro/core/trace.py``'s, field for field, so the scheduling backends
(``core/backends/``) consume a trace of either package unchanged. What
differs is where a trace comes from: the JAX package parses compiled HLO
(``lower_text``); the port records the ATen ops a PyTorch function
dispatches (:func:`lower_step`), the counterpart of ``lower_text``, in
place of ``core/hloparse.py``, which has nothing to parse here.

:func:`lower_step` runs the function under a ``TorchDispatchMode``,
usually on meta tensors (shapes and dtypes, no storage, no device), and
records one :class:`TraceOp` per ATen op into one boundary region. The
eager card runs one kernel per op, so each non-view op crosses HBM:

* ``dma_bytes`` = the bytes it reads + the bytes it writes. A gather
  reads only the rows it picks; an in-place write into a slice counts
  the update, as ``dynamic-update-slice`` does;
* views are ``free`` (no work, no traffic): the op schema's return
  ``alias_info`` says so, or the output shares its input's storage;
* ``deps`` come from tensor identity: the op that last made or wrote
  each tensor an op reads.

A function wrapped by :func:`kernel` is one launch on the card (the
decode kernels write the step's rows and attend in one): lowered, its
ATen ops form an ``inline`` region, as an HLO fusion does, whose HBM
traffic is what enters and leaves it — the tensors from outside it
reads, the rows it writes into them, and what it returns.

Under a mesh the function's tensors are DTensors: the recorder lets
DTensor run each op and records the ops on the local shards that it
dispatches, the collectives of its redistributions among them (and
skips the fake-tensor ops of its sharding propagation), so a trace is
one rank's program, as the JAX package's compiled SPMD module is. A
collective is one record with its wire bytes (``isa.collective``) and
lands in ``Trace.collectives`` with its group's size. A :func:`repeat`
loop is one region whose trips multiply its body; the backward pass of
such a body (the autograd nodes its ops made, run later by
``torch.autograd``) is recorded as a loop region of the same trips.
``lower_call(..., memory=True)`` also tracks the storages the call
makes, alive at once (``Trace.memory``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import (_disable_current_modes,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_flatten

from repro_torch.core import isa
from repro_torch.utils.loops import LoopRecorder


@dataclasses.dataclass
class TraceOp:
    """One trace record: a decomposed instruction, an inlined call-like
    region, a loop region, or an alias-elided carry copy."""

    name: str
    opcode: str
    kind: str = "op"              # "op" | "inline" | "loop" | "elided"
    uops: tuple = ()              # ((µ-op class, units), ...)
    deps: tuple = ()              # operand names (region-local)
    flops: float = 0.0
    coll_bytes: float = 0.0
    coll_kind: str = ""
    unknown: bool = False
    free: bool = False            # FREE_OPS: zero latency base
    lat_cls: str | None = None    # latency class (None: while/fusion)
    # boundary HBM bytes (slice-capped); None when outside a boundary
    # region or for while/free ops — backends must distinguish "no
    # boundary here" from a genuine 0-byte boundary (fused edge)
    dma_bytes: float | None = None
    region: "TraceRegion | None" = None   # inline / loop body
    trips: int = 1                # loop trip count
    # inline only: body parameter name -> outer operand name, and the
    # body root's name — lets a flattening backend (mca_sched) stitch
    # dependency edges across the call boundary
    param_map: dict | None = None
    root_name: str | None = None


@dataclasses.dataclass
class TraceRegion:
    """An ordered op list lowered from one computation visit.

    ``boundary`` marks regions whose op results cross the HBM boundary
    (the entry computation and ``while`` bodies); inlined fusion/call
    bodies stay on chip and carry no per-op traffic.
    """

    name: str
    boundary: bool
    ops: list

    def n_ops(self) -> int:
        """Total op records in this region and every nested region."""
        n = 0
        for op in self.ops:
            n += 1
            if op.region is not None:
                n += op.region.n_ops()
        return n


@dataclasses.dataclass(frozen=True)
class StoreRecord:
    """One store that crosses HBM, for the write-allocate scan
    (``core/wa.analyze_trace_stores``): an op's fresh output (``kind``
    ``"fresh"``) or a write into an existing tensor (``"write"``: a copy
    into a slice, ``index_put_``, ``scatter_``, an in-place op).
    ``dims`` are the written region's, ``buffer_dims`` those of the
    tensor it lands in (its base, for a view), ``dtype`` the element
    type's HLO name (``f32``, ``bf16``...)."""

    opcode: str
    kind: str
    dims: tuple
    buffer_dims: tuple
    dtype: str
    count: int = 1                # times it runs (a loop body's: trips)


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective of a trace: its HLO kind (``"all-reduce"``...), the
    ATen op, the bytes it returns or writes (``payload``), its wire bytes
    (``isa.collective``), its group's size, and the times it runs (the
    trips of the loops around it)."""

    kind: str
    opcode: str
    payload: float
    wire: float
    group: int
    count: int = 1


@dataclasses.dataclass
class Trace:
    """A lowered module: the entry region plus lowering metadata.

    ``stores`` (the port's addition) lists the stores that cross HBM, in
    op order: every boundary op's, a kernel region's writes into tensors
    from outside it and what it returns; ``None`` unless the lowering
    asked for them (:func:`lower_call`'s ``stores``). ``collectives``
    lists the :class:`CollectiveRecord` of each collective, in op order.
    ``memory`` (``lower_call(..., memory=True)``): ``{"peak_bytes",
    "end_bytes"}``, the most bytes of storages made during the call
    alive at once, and those still alive when it returned (its result
    among them). ``result`` is what the call returned, when kept."""

    module_name: str
    entry: TraceRegion
    n_devices: int = 1
    stores: tuple | None = None
    collectives: tuple = ()
    memory: dict | None = None
    result: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    def n_ops(self) -> int:
        """Total op records across the whole trace."""
        return self.entry.n_ops()


def lower_step(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` and lower the ATen ops it dispatches.

    Pass meta tensors to lower at any size without memory or a device;
    the function must then make no host sync (no ``.item()``, no
    data-dependent shape). Returns the :class:`Trace` (module docstring).
    """
    return lower_call(fn, args, kwargs)


def lower_call(fn, args=(), kwargs=None, *, on_op=None,
               stores: bool = False, memory: bool = False,
               keep_result: bool = False) -> Trace:
    """:func:`lower_step` with the call's arguments as a tuple and a dict,
    and a hook: ``on_op(opcode, ins, outs)`` is called for every non-view
    op with the ``isa.Operand`` of each tensor it reads and of what it
    writes (its fresh outputs, or the elements it writes in place).
    ``stores=True`` also records the trace's HBM stores (``Trace.stores``,
    what ``core/wa.analyze_trace_stores`` scans); ``memory=True`` tracks
    the storages the call makes (``Trace.memory``); ``keep_result=True``
    keeps what it returns (``Trace.result``). A remat checkpoint
    recomputes its whole body in the backward pass here (no early
    stop), so the trace prices every op it may run."""
    rec = _Recorder(on_op, stores, memory)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False), rec:
        try:
            result = fn(*args, **(kwargs or {}))
        finally:
            rec.backward_loop(None)
    entry = rec.scopes[0]
    mem = None
    if memory:
        mem = {"peak_bytes": float(rec.peak), "end_bytes": float(rec.live_now)}
    # tensors that outlive the call keep their finalizers: let them find
    # nothing, and hold no scope of the trace
    rec.info.clear()
    rec.live.clear()
    return Trace(getattr(fn, "__name__", "step"),
                 TraceRegion(entry.name, True, entry.ops),
                 stores=None if rec.stores is None else tuple(rec.stores),
                 collectives=tuple(rec.collectives), memory=mem,
                 result=result if keep_result else None)


def kernel(fn):
    """Mark ``fn`` as one kernel launch for :func:`lower_step`.

    Outside a lowering the wrapper calls ``fn`` and nothing else. Inside
    one, ``fn``'s ATen ops become one ``inline`` region (module
    docstring); a kernel called inside another is part of it.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        rec = _get_current_dispatch_mode()
        if not isinstance(rec, _Recorder) or len(rec.scopes) > 1:
            return fn(*args, **kwargs)
        return rec.fused(fn.__name__, fn, args, kwargs)
    return wrapped


def _operand(t: torch.Tensor) -> isa.Operand:
    return isa.Operand(tuple(t.shape), t.element_size())


#: HLO element-type names of torch dtypes (``core/wa.py`` tiles by them)
_HLO_DTYPES = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def _store(opcode: str, kind: str, region: torch.Tensor,
           buffer: torch.Tensor) -> StoreRecord:
    base = buffer._base if buffer._base is not None else buffer
    return StoreRecord(opcode, kind, tuple(region.shape), tuple(base.shape),
                       _HLO_DTYPES.get(buffer.dtype, "f32"))


def _update_of(base: str, mutated: torch.Tensor, rest: list):
    """The tensor whose extent an in-place op writes into ``mutated``:
    the values of ``index_put_``/``index_copy_``/``index_add_``, the
    source (or index) of a scatter, else ``mutated`` itself (a copy into
    a slice is a write of the slice)."""
    if base in ("index_put", "_index_put_impl", "index_copy",
                "index_add") and rest:
        return rest[-1]
    if base.startswith("scatter") and rest:
        return rest[-1] if rest[-1].dtype == mutated.dtype else rest[0]
    return mutated


def _storage(t: torch.Tensor) -> tuple:
    """The storage a tensor views, and its bytes."""
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


def _read_bytes(ext_read: dict) -> float:
    """Bytes a kernel region reads from outside: each storage's views'
    bytes, at most the storage's own (a stencil's shifted views of one
    grid read the grid once)."""
    return sum(min(float(nbytes), sum(views.values()))
               for (_, nbytes), views in ext_read.items())


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_size(args, kwargs) -> int:
    """Ranks in a collective's group: its ``ProcessGroup`` argument (the
    c10d forms), or the group its name resolves to (the functional
    forms, whose group is a name)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    flat = list(args) + list((kwargs or {}).values())
    for a in flat:
        if isinstance(a, torch.ScriptObject):
            a = dist.ProcessGroup.unbox(a)       # the c10d ops' argument
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    for a in flat:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_kind(func) -> str | None:
    """The HLO kind of a collective op (``isa.COLLECTIVE_OPS``), else
    None."""
    if func.namespace not in ("_c10d_functional", "c10d",
                              "_c10d_functional_autograd"):
        return None
    return isa.COLLECTIVE_OPS.get(
        isa.base_name(func.overloadpacket.__name__))


def _autograd_mark() -> int:
    """The autograd sequence number the next node made on this thread
    will get, less one: nodes made after this call have larger ones."""
    with _disable_current_modes(), torch.enable_grad():
        return (torch.zeros(1, requires_grad=True) * 1).grad_fn._sequence_nr()


@functools.cache
def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class _Scope:
    """Ops recorded into one region: the entry, a kernel's body, or a
    loop's body."""

    def __init__(self, name: str, boundary: bool, owner=None,
                 mult: int = 1, trips: int = 1):
        self.name, self.boundary, self.trips = name, boundary, trips
        # the scope whose tensors count as made here: a loop body inside
        # a kernel body belongs to the kernel's; ``mult`` its trips
        self.owner, self.mult = owner or self, mult
        self.ops: list = []
        self.params: list = []        # parameter records (kernel bodies)
        self.param_of: dict = {}      # outer producer -> parameter name
        # storage -> {id of a view read: bytes}, what it reads from outside
        self.ext_read: dict = {}
        self.ext_write = 0.0          # bytes written into outside tensors
        # id -> tensor made or written here (kernel bodies only: what a
        # kernel region returns is priced from it)
        self.touched: dict = {}
        self.named: set = set()       # ids whose last writer is an op here


@dataclasses.dataclass
class _LoopNodes:
    """The autograd nodes a loop body's ops made, by sequence number:
    those in ``(lo, hi)``; their backward runs ``trips`` times."""

    lo: int
    hi: int
    trips: int


class _Recorder(LoopRecorder):
    """Records every ATen op into the innermost open :class:`_Scope`."""

    def __init__(self, on_op=None, stores: bool = False,
                 memory: bool = False):
        super().__init__()
        self.on_op = on_op
        self.scopes = [_Scope("entry", True)]
        # id(tensor) -> (name of the op that made or last wrote it, the
        # scope that op is in, the scope its storage was made in; None,
        # None, None for a tensor made before the lowering). A view's
        # storage is its input's. An entry goes when its tensor dies, so
        # a later tensor at the same id starts afresh.
        self.info: dict = {}
        self.count = 0
        # StoreRecords of HBM stores, when asked for
        self.stores: list | None = [] if stores else None
        self.collectives: list = []
        # storages made during the call: key -> [bytes, live tensors]
        self.memory = memory
        self.live: dict = {}
        self.live_now = self.peak = 0
        # loops whose bodies made autograd nodes, and the backward loop
        # region open now (its _LoopNodes and scope)
        self.loop_nodes: list = []
        self.bwd = None

    # -- helpers -------------------------------------------------------------
    def _name(self, opcode: str) -> str:
        self.count += 1
        return f"{opcode}.{self.count}"

    def _read(self, t: torch.Tensor, scope: _Scope, nbytes):
        """Dependency name of ``t`` as ``scope`` sees it; charges a
        kernel body ``nbytes`` (None: nothing) read from a tensor made
        outside it, once a view (:func:`_read_bytes` caps a storage's)."""
        name, where, origin = self.info.get(id(t), (None, None, None))
        own = scope.owner
        if not scope.boundary and origin is not own and nbytes is not None:
            views = own.ext_read.setdefault(_storage(t), {})
            views[id(t)] = max(views.get(id(t), 0.0), float(nbytes))
        if name is None or where is scope or scope.boundary:
            return name
        p = scope.param_of.get(name)
        if p is None:
            p = scope.param_of[name] = self._name("parameter")
            scope.params.append(TraceOp(p, "parameter", uops=(("sc", 1),),
                                        free=True, lat_cls="vpu"))
        return p

    def _set(self, t: torch.Tensor, name: str, origin) -> None:
        scope = self.scopes[-1]
        key = id(t)
        if key not in self.info:
            weakref.finalize(t, self.info.pop, key, None)
        self.info[key] = (name, scope, origin)
        scope.named.add(key)

    def _touch(self, scope: _Scope, t: torch.Tensor) -> None:
        if not scope.boundary:
            scope.touched[id(t)] = t

    def _hold(self, t: torch.Tensor, made: bool) -> None:
        """Count ``t`` as holding its storage (``made``: a storage this
        call made, new if unseen) until it dies."""
        if not self.memory:
            return
        st = t.untyped_storage()
        key = st._cdata
        rec = self.live.get(key)
        if rec is None:
            if not made:
                return
            rec = self.live[key] = [st.nbytes(), 0]
            self.live_now += rec[0]
            self.peak = max(self.peak, self.live_now)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self.live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] <= 0:
            self.live_now -= rec[0]
            del self.live[key]

    def _mult(self) -> int:
        """The times an op recorded now runs: the trips of every loop
        region open around it."""
        return math.prod(s.trips for s in self.scopes)

    def _origin(self, t: torch.Tensor):
        return self.info.get(id(t), (None, None, None))[2]

    def _stored(self, opcode: str, kind: str, pairs) -> None:
        """Record the stores of ``(region, buffer)`` pairs, if asked."""
        if self.stores is not None:
            self.stores += [_store(opcode, kind, r, b) for r, b in pairs]

    # -- recording -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            # let DTensor run the op: its local ops come back here
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None or any(
                issubclass(t, torch._subclasses.FakeTensor) for t in types):
            # DTensor's sharding propagation on fake tensors: not the
            # rank's program
            return func(*args, **kwargs)
        if self.loop_nodes:
            self.backward_loop(self._loop_of_node())
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _loop_of_node(self):
        """The innermost loop whose body made the autograd node running
        now (None outside a backward pass, or for another node)."""
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        seq = node._sequence_nr()
        best = None
        for ln in self.loop_nodes:
            if ln.lo < seq < ln.hi and (best is None or ln.lo > best.lo):
                best = ln
        return best

    def backward_loop(self, loop) -> None:
        """Record from now on into the backward loop region of ``loop``
        (a :class:`_LoopNodes`), closing the one open if it is another;
        None closes it."""
        if self.bwd is not None and self.bwd[0] is loop:
            return
        if self.bwd is not None:
            ln, body, first = self.bwd
            self.bwd = None
            if self.scopes[-1] is body:
                self.scopes.pop()
                self._close_loop(body, ln.trips, first)
        if loop is not None:
            body, first = self._open_loop(loop.trips)
            self.bwd = (loop, body, first)

    def _record(self, func, args, kwargs, out) -> None:
        scope = self.scopes[-1]
        schema = func._schema
        opcode = func.overloadpacket.__name__
        name = self._name(opcode)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        # mutated operands: arguments the schema marks as written
        mutated = []
        flat_args = list(args) + [kwargs.get(a.name) for a in
                                  schema.arguments[len(args):]]
        for a, v in zip(schema.arguments, flat_args):
            if a.alias_info is not None and a.alias_info.is_write:
                mutated += _tensors(v)
        kind = _collective_kind(func)
        if kind is not None and not mutated:
            # the c10d forms write their first tensor argument, return it
            # unannotated or not at all
            landing = {o.untyped_storage()._cdata for o in outs}
            mutated = [t for t in ins
                       if t.untyped_storage()._cdata in landing] \
                if outs else ins[:1]
        mutated_ids = {id(t) for t in mutated}
        in_storages = {t.untyped_storage()._cdata for t in ins}
        aliases = [r.alias_info is not None for r in schema.returns]
        view = not mutated and outs and (
            any(aliases) or all(o.untyped_storage()._cdata in in_storages
                                for o in outs))
        base = isa.base_name(opcode)
        if view:
            deps = tuple(d for d in (self._read(t, scope, None) for t in ins)
                         if d is not None)
            origin = self._origin(ins[0]) if ins else scope.owner
            scope.ops.append(TraceOp(name, opcode, uops=(("sc", 1),),
                                     deps=deps, free=True,
                                     lat_cls="vpu"))
            for o in outs:
                self._set(o, name, origin)
                self._hold(o, False)
            return
        gathered = sum(_operand(o).bytes for o in outs) \
            if base in isa.GATHER_OPS else None

        def charge(i, t):
            if id(t) in mutated_ids and base in isa.OVERWRITE_OPS:
                return None                 # overwritten, not read
            if gathered is not None and i == 0:
                return min(gathered, _operand(t).bytes)   # picked rows
            return _operand(t).bytes
        reads = [charge(i, t) for i, t in enumerate(ins)]
        deps = tuple(d for d in (self._read(t, scope, c)
                                 for t, c in zip(ins, reads))
                     if d is not None)
        fresh = [o for o in outs if id(o) not in mutated_ids]
        written = None
        rest = [t for t in ins if id(t) not in mutated_ids]
        if mutated:
            if base in ("index_put", "_index_put_impl", "index_copy",
                        "index_add") and rest:
                written = rest[-1].numel()
            elif base.startswith("scatter") and rest:
                written = rest[0].numel()
            else:
                written = sum(t.numel() for t in mutated)
        if kind is not None:
            landed = mutated if mutated else fresh
            payload = float(sum(_operand(t).bytes for t in landed))
            g = _group_size(args, kwargs)
            u = isa.collective(kind, payload, sum(t.numel() for t in landed),
                               g)
            self.collectives.append(CollectiveRecord(
                kind, opcode, payload, u.coll_bytes, g, self._mult()))
        else:
            u = isa.decompose(opcode, [_operand(t) for t in ins],
                              [_operand(o) for o in fresh], written)
        if self.on_op is not None:
            self.on_op(opcode, [_operand(t) for t in ins],
                       [_operand(o) for o in fresh] if not mutated else
                       [isa.Operand((written,), mutated[0].element_size())])
        op = TraceOp(name, opcode, uops=tuple(u.uops), deps=deps,
                     flops=u.flops, coll_bytes=u.coll_bytes,
                     coll_kind=u.coll_kind, unknown=u.unknown,
                     free=base in isa.ALLOC_OPS or base in isa.WAIT_OPS,
                     lat_cls=isa.latency_class(opcode))
        w_bytes = 0.0
        if mutated:
            w_bytes = float(written * mutated[0].element_size())
        if scope.boundary and not op.free:
            op.dma_bytes = float(sum(c for c in reads if c is not None)) \
                + w_bytes + sum(_operand(o).bytes for o in fresh)
            self._stored(opcode, "fresh", [(o, o) for o in fresh])
            self._stored(opcode, "write", [(_update_of(base, t, rest), t)
                                           for t in mutated])
        elif not scope.boundary:
            for t in mutated:
                if self._origin(t) is not scope.owner:
                    scope.owner.ext_write += w_bytes * scope.mult
                    self._stored(opcode, "write",
                                 [(_update_of(base, t, rest), t)])
        scope.ops.append(op)
        for t in mutated:
            self._set(t, name, self._origin(t))
            self._touch(scope, t)
        for o in fresh:
            self._set(o, name, scope.owner)
            self._touch(scope, o)
            self._hold(o, True)

    def _open_loop(self, trips: int) -> tuple:
        """Push the body scope of a loop region of ``trips`` trips;
        returns it and the index of its first store."""
        outer = self.scopes[-1]
        body = _Scope(f"while.{self.count + 1}", outer.boundary,
                      None if outer.boundary else outer.owner,
                      outer.mult * trips, trips)
        self.scopes.append(body)
        return body, len(self.stores or ())

    def looped(self, trips: int, step) -> None:
        """Run ``step(0)`` as the body of one ``repeat`` loop region
        (``utils/loops.py``); the backward pass of the autograd nodes
        its ops make is a loop region of the same trips."""
        self.backward_loop(None)
        body, first_store = self._open_loop(trips)
        lo = _autograd_mark()
        try:
            step(0)
        finally:
            self.backward_loop(None)
            self.scopes.pop()
        hi = _autograd_mark()
        if hi > lo + 1:
            self.loop_nodes.append(_LoopNodes(lo, hi, trips))
        self._close_loop(body, trips, first_store)

    def _close_loop(self, body: _Scope, trips: int, first_store: int) -> None:
        """Append the loop op of a popped body scope to the scope below."""
        outer = self.scopes[-1]
        name = self._name("while")
        if self.stores is not None:
            self.stores[first_store:] = [
                dataclasses.replace(st, count=st.count * trips)
                for st in self.stores[first_store:]]
        inner = {o.name for o in body.ops}
        deps = tuple(body.param_of) if body.param_of else tuple(
            dict.fromkeys(d for op in body.ops for d in op.deps
                          if d not in inner))
        outer.ops.append(TraceOp(name, "while", kind="loop", deps=deps,
                                 lat_cls=None, trips=trips,
                                 region=TraceRegion(body.name,
                                                    body.boundary,
                                                    body.params + body.ops)))
        self._rehome(body, name, outer)
        if not outer.boundary:
            outer.touched.update(body.touched)

    def _rehome(self, body: _Scope, name: str, outer: _Scope) -> None:
        """Tensors last written in ``body`` count as made or written by
        its region's op ``name`` in ``outer``."""
        for key in body.named:
            entry = self.info.get(key)
            if entry is None:
                continue            # died inside the region
            origin = entry[2]
            self.info[key] = (name, outer, outer if origin is body
                              else origin)
            outer.named.add(key)

    def fused(self, kname: str, fn, args, kwargs):
        """Run a :func:`kernel` ``fn`` as one inline region."""
        self.backward_loop(None)
        outer = self.scopes[-1]
        body = _Scope(f"{kname}.{self.count + 1}", False)
        self.scopes.append(body)
        try:
            result = fn(*args, **kwargs)
        finally:
            self.scopes.pop()
        name = self._name(kname)
        rets = _tensors(result)
        root = self.info.get(id(rets[0]), (None,))[0] if rets else None
        # what it returns: tensors it made or wrote, and views of those
        # it made (``detach``, a reshape)
        made = [t for t in rets if self._origin(t) is body]
        out_bytes = sum(float(_operand(t).bytes) for t in rets
                        if id(t) in body.touched
                        or self._origin(t) is body)
        op = TraceOp(
            name, kname, kind="inline",
            deps=tuple(body.param_of), lat_cls=None,
            dma_bytes=(_read_bytes(body.ext_read) + body.ext_write
                       + out_bytes) if outer.boundary else None,
            region=TraceRegion(body.name, False, body.params + body.ops),
            param_map={p: o for o, p in body.param_of.items()},
            root_name=root)
        outer.ops.append(op)
        if outer.boundary:
            self._stored(kname, "fresh", [(t, t) for t in made])
        self._rehome(body, name, outer)
        return result
