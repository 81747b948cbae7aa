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
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_flatten

from repro_torch.core import isa


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


@dataclasses.dataclass
class Trace:
    """A lowered module: the entry region plus lowering metadata."""

    module_name: str
    entry: TraceRegion
    n_devices: int = 1

    def n_ops(self) -> int:
        """Total op records across the whole trace."""
        return self.entry.n_ops()


def lower_step(fn, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` and lower the ATen ops it dispatches.

    Pass meta tensors to lower at any size without memory or a device;
    the function must then make no host sync (no ``.item()``, no
    data-dependent shape). Returns the :class:`Trace` (module docstring).
    """
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    entry = rec.scopes[0]
    return Trace(getattr(fn, "__name__", "step"),
                 TraceRegion(entry.name, True, entry.ops))


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


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Scope:
    """Ops recorded into one region: the entry, or a kernel's body."""

    def __init__(self, name: str, boundary: bool):
        self.name, self.boundary = name, boundary
        self.ops: list = []
        self.params: list = []        # parameter records (kernel bodies)
        self.param_of: dict = {}      # outer producer -> parameter name
        self.ext_read: dict = {}      # id -> bytes read from outside
        self.ext_write = 0.0          # bytes written into outside tensors
        self.touched: dict = {}       # id -> tensor made or written here
        self.named: set = set()       # ids whose last writer is an op here


class _Recorder(TorchDispatchMode):
    """Records every ATen op into the innermost open :class:`_Scope`."""

    def __init__(self):
        super().__init__()
        self.scopes = [_Scope("entry", True)]
        # id(tensor) -> (name of the op that made or last wrote it, the
        # scope that op is in, the scope its storage was made in; None,
        # None, None for a tensor made before the lowering). A view's
        # storage is its input's.
        self.info: dict = {}
        self.keep: dict = {}          # every tensor seen, so ids stay unique
        self.count = 0

    # -- helpers -------------------------------------------------------------
    def _name(self, opcode: str) -> str:
        self.count += 1
        return f"{opcode}.{self.count}"

    def _read(self, t: torch.Tensor, scope: _Scope, nbytes):
        """Dependency name of ``t`` as ``scope`` sees it; charges a
        kernel body ``nbytes`` (None: nothing) read from a tensor made
        outside it, once a tensor."""
        name, where, origin = self.info.get(id(t), (None, None, None))
        if not scope.boundary and origin is not scope and nbytes is not None:
            scope.ext_read[id(t)] = max(scope.ext_read.get(id(t), 0.0),
                                        float(nbytes))
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
        self.keep[id(t)] = t
        self.info[id(t)] = (name, scope, origin)
        scope.named.add(id(t))

    def _origin(self, t: torch.Tensor):
        return self.info.get(id(t), (None, None, None))[2]

    # -- recording -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        scope = self.scopes[-1]
        schema = func._schema
        opcode = func.overloadpacket.__name__
        name = self._name(opcode)
        ins = _tensors((args, kwargs))
        for t in ins:
            self.keep[id(t)] = t
        outs = _tensors(out)
        # mutated operands: arguments the schema marks as written
        mutated = []
        flat_args = list(args) + [kwargs.get(a.name) for a in
                                  schema.arguments[len(args):]]
        for a, v in zip(schema.arguments, flat_args):
            if a.alias_info is not None and a.alias_info.is_write:
                mutated += _tensors(v)
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
            origin = self._origin(ins[0]) if ins else scope
            scope.ops.append(TraceOp(name, opcode, uops=(("sc", 1),),
                                     deps=deps, free=True,
                                     lat_cls="vpu"))
            for o in outs:
                self._set(o, name, origin)
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
        if mutated:
            tens = [t for t in ins if id(t) not in mutated_ids]
            if base in ("index_put", "_index_put_impl", "index_copy",
                        "index_add") and tens:
                written = tens[-1].numel()
            elif base.startswith("scatter") and tens:
                written = tens[0].numel()
            else:
                written = sum(t.numel() for t in mutated)
        u = isa.decompose(opcode, [_operand(t) for t in ins],
                          [_operand(o) for o in fresh], written)
        op = TraceOp(name, opcode, uops=tuple(u.uops), deps=deps,
                     flops=u.flops, unknown=u.unknown,
                     free=base in isa.ALLOC_OPS,
                     lat_cls=isa.latency_class(opcode))
        w_bytes = 0.0
        if mutated:
            w_bytes = float(written * mutated[0].element_size())
        if scope.boundary and not op.free:
            op.dma_bytes = float(sum(c for c in reads if c is not None)) \
                + w_bytes + sum(_operand(o).bytes for o in fresh)
        elif not scope.boundary:
            for t in mutated:
                if self._origin(t) is not scope:
                    scope.ext_write += w_bytes
        scope.ops.append(op)
        for t in mutated:
            self._set(t, name, self._origin(t))
            scope.touched[id(t)] = t
        for o in fresh:
            self._set(o, name, scope)
            scope.touched[id(o)] = o

    def fused(self, kname: str, fn, args, kwargs):
        """Run a :func:`kernel` ``fn`` as one inline region."""
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
        out_bytes = sum(float(_operand(t).bytes) for t in rets
                        if id(t) in body.touched)
        op = TraceOp(
            name, kname, kind="inline",
            deps=tuple(body.param_of), lat_cls=None,
            dma_bytes=(sum(body.ext_read.values()) + body.ext_write
                       + out_bytes) if outer.boundary else None,
            region=TraceRegion(body.name, False, body.params + body.ops),
            param_map={p: o for o, p in body.param_of.items()},
            root_name=root)
        outer.ops.append(op)
        for key in body.named:
            _, _, origin = self.info[key]
            self.info[key] = (name, outer, outer if origin is body
                              else origin)
            outer.named.add(key)
        return result
