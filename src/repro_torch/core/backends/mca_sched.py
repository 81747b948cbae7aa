"""LLVM-MCA-style cycle-simulator backend over the µ-op trace IR.

Where ``tp_bound`` assumes perfect ILP (every port busy whenever work
exists — an optimistic lower bound), this backend *schedules*: µ-ops
are dispatched in program order through a finite front end, wait in a
bounded scheduler window, and issue out of order onto concrete ports.
Three effects the analytical bound cannot see are modeled, mirroring
what llvm-mca's dispatch/scheduler/retire stages add over a pure
reciprocal-throughput sum (the paper's Fig. 3 comparison):

 * **dispatch stalls** — at most ``issue_width`` µ-ops enter the
   scheduler per cycle (machines that leave ``issue_width`` unmodeled
   get a generous default so the front end is never the artificial
   bottleneck);
 * **bounded window** — µ-op *j* cannot dispatch until µ-op
   *j - window* has completed, approximating reservation-station /
   ROB pressure;
 * **port contention** — each µ-op occupies exactly one admissible
   port for its reciprocal-throughput cycles; the scheduler picks the
   earliest-free port (the oldest-ready heuristic, since µ-ops are
   visited in program order), so imbalance shows up as real stalls
   instead of being averaged away.

Inlined fusion/call regions are flattened into the parent stream with
dependency edges stitched across the call boundary (the trace's
``param_map`` / ``root_name``); ``while`` loops are simulated once and
contribute ``trips x`` their steady-state makespan as macro-ops, the
same LCD treatment the analytical backend applies.

The reported estimate is **pessimistic-or-equal by construction**:
``sim_cycles = max(simulated makespan, TP in-core bound, LCD floors)``
— a simulator approximation can therefore never report an infeasible
cycle count below the provable lower bound (pinned per machine by
tests/test_trace_backends.py).

A copy of ``repro/core/backends/mca_sched.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

from repro_torch.core.machine import get_machine
from repro_torch.core.report import Report
from repro_torch.core.trace import Trace, TraceRegion
from repro_torch.core.backends.tp_bound import _Walk

#: scheduler-window default (µ-ops in flight), roughly an out-of-order
#: reservation station of the size llvm-mca assumes for modern cores
DEFAULT_WINDOW = 64
#: front-end width used when a machine leaves issue_width unmodeled (0)
DEFAULT_ISSUE_WIDTH = 6
#: µ-op classes the in-core scheduler does not see (off-core engines)
_OFFCORE = ("dma", "ici")


class _SimOp:
    """One flattened schedulable record."""

    __slots__ = ("deps", "pairs", "macro")

    def __init__(self, deps, pairs=(), macro=None):
        self.deps = deps        # indices of producer _SimOps
        self.pairs = pairs      # ((class, units), ...) port µ-ops
        self.macro = macro      # fixed duration (loop floors), or None


class McaSchedBackend:
    """The cycle-simulator backend (``Backend.run`` protocol)."""

    name = "mca_sched"

    def __init__(self, window: int = DEFAULT_WINDOW,
                 issue_width: int | None = None):
        self.window = max(1, window)
        self.issue_width = issue_width

    def run(self, trace: Trace, machine, warn: bool = True) -> Report:
        """Simulate one trace on one machine; returns a Report.

        The analytical walk runs first (same trace) to fill the
        occupation/traffic/CP/LCD fields; the simulation then sets
        ``sim_cycles``, which the Report's backend-resolved accessors
        (``incore_cycles`` and the bounds) prefer.
        """
        model = get_machine(machine)
        walk = _Walk(model, warn=warn)
        rep = walk.run(trace, self.name)
        raw = self._simulate(trace.entry, model, walk)
        rep.sim_cycles = max(raw, rep.tp_incore_cycles, rep.serial_cycles)
        return rep

    # -- flattening ----------------------------------------------------------
    def _flatten(self, region: TraceRegion, alias: dict, out: list,
                 model, walk) -> dict:
        """Append region ops to ``out``; returns {local name: op index}.

        ``alias`` maps body parameter names to producer indices in the
        enclosing stream (dependency stitching across inlining).
        """
        local: dict = {}

        def resolve(op):
            ids = [local[d] for d in op.deps if d in local]
            if op.opcode == "parameter" and op.name in alias:
                ids.append(alias[op.name])
            return tuple(ids)

        for op in region.ops:
            if op.kind == "elided":
                out.append(_SimOp(resolve(op)))
                local[op.name] = len(out) - 1
            elif op.kind == "inline":
                deps = resolve(op)
                if op.region is None:
                    out.append(_SimOp(deps))
                    local[op.name] = len(out) - 1
                    continue
                inner_alias = {}
                for pname, opnd in (op.param_map or {}).items():
                    if opnd in local:
                        inner_alias[pname] = local[opnd]
                inner = self._flatten(op.region, inner_alias, out,
                                      model, walk)
                root = inner.get(op.root_name)
                if root is None:        # degenerate body: barrier op
                    out.append(_SimOp(deps))
                    root = len(out) - 1
                local[op.name] = root
            elif op.kind == "loop":
                floor = 0.0
                if op.region is not None:
                    body = self._simulate(op.region, model, walk)
                    floor = op.trips * body
                out.append(_SimOp(resolve(op), macro=floor))
                local[op.name] = len(out) - 1
            else:
                pairs = tuple((c, u) for c, u in op.uops
                              if c not in _OFFCORE)
                out.append(_SimOp(resolve(op), pairs=pairs))
                local[op.name] = len(out) - 1
        return local

    # -- scheduling ----------------------------------------------------------
    def _simulate(self, region: TraceRegion, model, walk) -> float:
        ops: list = []
        self._flatten(region, {}, ops, model, walk)
        width = self.issue_width or model.issue_width or \
            DEFAULT_ISSUE_WIDTH
        step = 1.0 / width
        window = self.window
        free: dict = {}                 # port -> busy-until (cycles)
        comp = [0.0] * len(ops)
        t_disp = 0.0
        makespan = 0.0
        for j, op in enumerate(ops):
            if j >= window:             # RS entry frees at completion
                t_disp = max(t_disp, comp[j - window])
            ready = max((comp[i] for i in op.deps), default=0.0)
            if op.macro is not None:
                end = max(t_disp, ready) + op.macro
            elif not op.pairs:
                end = max(t_disp, ready)
            else:
                end = 0.0
                for cls, units in op.pairs:
                    entry = model.table.get(cls)
                    if entry is None:
                        entry = walk.fallback_entry(cls)
                    occ = units * entry.cycles_per_unit
                    port = min(entry.ports,
                               key=lambda p: free.get(p, 0.0))
                    start = max(t_disp, ready, free.get(port, 0.0))
                    free[port] = start + occ
                    end = max(end, start + max(entry.latency, occ))
            comp[j] = end
            makespan = max(makespan, end)
            t_disp += step
        return makespan
