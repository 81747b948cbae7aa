"""Analytical TP/CP/LCD backend — OSACA semantics over the trace IR.

Reproduces the paper's three analyses (the pre-refactor monolithic
analyzer, bit-for-bit — pinned by tests/test_golden_compare.py):

 * TP  — every µ-op's port occupation is distributed evenly over its
         admissible ports; the block lower bound is the maximum per-port
         sum (perfect ILP assumption -> optimistic/lower bound).
 * CP  — longest latency path through the dataflow DAG.
 * LCD — for `while` loops (layer scans, decode loops, optimizer loops),
         the body's carried-dependency path sets the per-iteration floor:
         cycles(loop) = trips * max(TP_body, LCD_body).

The walk also re-accumulates FLOPs / HBM bytes / collective bytes with
loop-trip multipliers — XLA's own cost_analysis visits while bodies
once, which under-counts a scanned N-layer model by N x (DESIGN.md
§3.1). The walk order mirrors the trace's lowering order exactly so
floating-point accumulation is reproducible.

A copy of ``repro/core/backends/tp_bound.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import warnings
from collections import defaultdict

from repro_torch.core.machine import get_machine
from repro_torch.core.report import Report, is_mem_port
from repro_torch.core.trace import Trace, TraceRegion


class _Acc:
    """Mutable per-region accumulator (ports, traffic, counters)."""

    def __init__(self):
        self.ports = defaultdict(float)
        self.flops = 0.0
        self.bytes_hbm = 0.0
        self.coll = defaultdict(float)
        self.n = 0
        self.unknown = 0
        self.fallback = 0
        self.serial = 0.0
        self.cp = 0.0
        self.trips_seen = {}
        self.loop_bytes = {}


class TpBoundBackend:
    """The default analytical backend (``Backend.run`` protocol)."""

    name = "tp_bound"

    def run(self, trace: Trace, machine, warn: bool = True) -> Report:
        """Walk one trace against one machine model; returns a Report."""
        return _Walk(get_machine(machine), warn).run(trace, self.name)


class _Walk:
    """One (trace, machine) walk; holds the per-run warning dedupe."""

    def __init__(self, model, warn: bool = True):
        self.model = model
        self.warn = warn
        self._warned_classes: set = set()
        self._fallback_classes: set = set()

    def run(self, trace: Trace, backend_name: str) -> Report:
        """Accumulate the whole trace and assemble the Report."""
        acc = _Acc()
        self.region(trace.entry, acc)
        tp = max(acc.ports.values()) if acc.ports else 0.0
        return Report(
            tp_cycles=tp, cp_cycles=acc.cp, serial_cycles=acc.serial,
            port_occupation=dict(acc.ports), flops=acc.flops,
            bytes_hbm=acc.bytes_hbm, coll_bytes=dict(acc.coll),
            n_instrs=acc.n, unknown_ops=acc.unknown,
            trips_seen=dict(acc.trips_seen),
            loop_bytes=dict(acc.loop_bytes),
            fallback_uops=acc.fallback,
            fallback_classes=tuple(sorted(self._fallback_classes)),
            backend=backend_name)

    # -- machine-file access -------------------------------------------------
    def fallback_entry(self, cls: str):
        """Entry for a µ-op class the machine file does not cover.

        Prefers `vpu` (the historical fallback); a machine registered
        without one (e.g. injected straight into the MACHINES dict,
        bypassing validate_model) degrades to the cheapest available
        non-memory class instead of raising KeyError. Warns once per
        missing class per walk (suppressed under ``compare()``, which
        warns once in the parent); occurrences are counted on the
        report (`Report.fallback_uops` / `fallback_classes`).
        """
        entry = self.model.table.get("vpu")
        if entry is None:
            cands = {c: e for c, e in self.model.table.items()
                     if c not in ("dma", "ici")} or dict(self.model.table)
            if not cands:
                raise KeyError(
                    f"machine {self.model.name!r} has an empty µ-op table")
            entry = min(cands.values(), key=lambda e: e.cycles_per_unit)
        self._fallback_classes.add(cls)
        if self.warn and cls not in self._warned_classes:
            self._warned_classes.add(cls)
            warnings.warn(
                f"machine {self.model.name!r} has no entry for µ-op "
                f"class {cls!r}; degrading to the cheapest available "
                f"class (counted in Report.fallback_uops)",
                RuntimeWarning, stacklevel=3)
        return entry

    def _occupy(self, acc, cls: str, units: float) -> float:
        entry = self.model.table.get(cls)
        if entry is None:
            entry = self.fallback_entry(cls)
            acc.fallback += 1
        cyc = units * entry.cycles_per_unit
        if entry.port_weights is None:
            share = cyc / len(entry.ports)
            for p in entry.ports:
                acc.ports[p] += share
        else:
            wsum = sum(entry.port_weights)
            for p, w in zip(entry.ports, entry.port_weights):
                acc.ports[p] += cyc * (w / wsum)
        return cyc

    # -- walk ----------------------------------------------------------------
    def _op_cost(self, op, acc) -> float:
        """Occupies ports; returns the op's own min-cycles (CP/LCD
        edge weight)."""
        if op.kind == "inline":
            if op.region is None:
                return 0.0
            return self.region(op.region, acc)
        if op.kind == "loop":
            n = op.trips
            acc.trips_seen[op.name] = n
            if op.region is None:
                return 0.0
            sub = _Acc()
            body_cp = self.region(op.region, sub)
            body_tp = max((c for p, c in sub.ports.items()
                           if not is_mem_port(p)), default=0.0)
            floor = n * max(body_tp, body_cp, sub.serial)
            # merge: occupation scaled by trips
            for p, c in sub.ports.items():
                acc.ports[p] += c * n
            acc.flops += sub.flops * n
            acc.bytes_hbm += sub.bytes_hbm * n
            for k, v in sub.coll.items():
                acc.coll[k] += v * n
            acc.n += sub.n
            acc.unknown += sub.unknown
            acc.fallback += sub.fallback
            acc.serial += floor
            acc.trips_seen.update(sub.trips_seen)
            acc.loop_bytes.update(sub.loop_bytes)
            acc.loop_bytes[op.name] = (n, sub.bytes_hbm, sub.flops)
            return floor

        own = 0.0
        for cls, units in op.uops:
            cyc = self._occupy(acc, cls, units)
            if cls not in ("dma", "ici"):
                own += cyc      # CP/LCD chains are in-core (prefetchable
                                # memory traffic is not a dependency)
        acc.flops += op.flops
        if op.coll_bytes:
            acc.coll[op.coll_kind] += op.coll_bytes
        acc.n += 1
        acc.unknown += int(op.unknown)
        return own

    def _latency(self, op, own_cycles: float) -> float:
        if op.lat_cls is None:          # while / fusion
            base = 0.0
        else:
            entry = self.model.table.get(op.lat_cls)
            if entry is None:
                entry = self.fallback_entry(op.lat_cls)
            base = entry.latency
        if op.free:
            base = 0.0
        # a consumer needing the full result also waits for throughput
        return base + own_cycles

    def region(self, region: TraceRegion, acc) -> float:
        """Walk one region; returns its CP length (cycles)."""
        depth: dict = {}
        cp = 0.0
        for op in region.ops:
            if op.kind == "elided":      # alias-elided carry copy: free
                d = max((depth.get(o, 0.0) for o in op.deps),
                        default=0.0)
                depth[op.name] = d
                continue
            own = self._op_cost(op, acc)
            lat = self._latency(op, own)
            d = lat + max((depth.get(o, 0.0) for o in op.deps),
                          default=0.0)
            depth[op.name] = d
            cp = max(cp, d)
            if op.dma_bytes is not None:
                acc.bytes_hbm += op.dma_bytes
                self._occupy(acc, "dma", op.dma_bytes)
        acc.cp = max(acc.cp, cp)
        return cp
