"""The analysis result record shared by every scheduling backend.

A :class:`Report` is what ``portmodel.analyze`` / ``compare`` return:
TP/CP/LCD cycles, per-port occupation, trip-multiplied traffic
accounting, and (once resolved) the memory-ladder fields. Since the
backend split it also carries which engine produced it (``backend``)
and, for cycle-simulator backends, the simulated in-core makespan
(``sim_cycles``) — the per-backend accessors (:attr:`incore_cycles`
and the bounds built on it) resolve to whichever estimate the backend
filled, so downstream consumers (serve planner, roofline, benchmarks)
are backend-agnostic.

Defined in its own module so the backends can construct Reports
without importing the ``portmodel`` frontend (which imports them).

A copy of ``repro/core/report.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import MachineModel

_MEM_PORTS = ("DMA", "ICI", "MEM")


def is_mem_port(p: str) -> bool:
    """True for off-core ports (memory / interconnect interfaces)."""
    return p.startswith(_MEM_PORTS)


@dataclasses.dataclass
class Report:
    """Result of analyzing one HLO module on one machine with one
    scheduling backend (see the module docstring)."""

    tp_cycles: float              # max per-port occupation (incl. DMA/ICI)
    cp_cycles: float              # latency-critical path (in-core)
    serial_cycles: float          # sum of sequential loop floors
    port_occupation: dict         # port -> cycles
    flops: float
    bytes_hbm: float
    coll_bytes: dict              # kind -> wire bytes
    n_instrs: int
    unknown_ops: int
    trips_seen: dict              # loop name -> trips
    loop_bytes: dict = dataclasses.field(default_factory=dict)
    # loop name -> (trips, bytes/iter, flops/iter) for bottleneck attribution
    # µ-ops whose class had no machine-file entry and were degraded to the
    # cheapest available class (see backends.tp_bound)
    fallback_uops: int = 0
    # names of the µ-op classes that were degraded (for the one-shot
    # warning compare() emits in the parent process)
    fallback_classes: tuple = ()
    # which scheduling backend produced this report
    backend: str = "tp_bound"
    # cycle-simulator backends: simulated in-core makespan (dispatch
    # stalls + port contention + dep latencies); None for analytical
    # backends, whose in-core estimate is the TP bound
    sim_cycles: float | None = None
    # memory-ladder resolution (filled by compare()/resolve_tiers — the
    # backends themselves are tier-agnostic): ECM memory term in seconds
    # and the slowest / home tier of the module's traffic on this machine.
    t_mem_tier: float | None = None
    bottleneck_tier: str | None = None
    home_tier: str | None = None

    @property
    def tp_incore_cycles(self) -> float:
        """OSACA semantics: the in-core bound assumes operands resident
        (L1 on CPU, VMEM on TPU) — memory/interconnect ports excluded."""
        vals = [c for p, c in self.port_occupation.items()
                if not is_mem_port(p)]
        return max(vals) if vals else 0.0

    @property
    def incore_cycles(self) -> float:
        """Backend-resolved in-core estimate: the simulated makespan
        when this report came from a cycle simulator, else the
        analytical TP lower bound."""
        if self.sim_cycles is not None:
            return self.sim_cycles
        return self.tp_incore_cycles

    @property
    def bound_cycles(self) -> float:
        """ECM-style full bound: all ports + sequential loop floors
        (+ the simulated in-core makespan for simulator backends)."""
        return max(self.tp_cycles, self.incore_cycles, self.serial_cycles)

    @property
    def bound_incore_cycles(self) -> float:
        """In-core bound: the backend's in-core estimate vs the loop
        floors (no memory ports)."""
        return max(self.incore_cycles, self.serial_cycles)

    def seconds(self, machine: MachineModel) -> float:
        """Full ECM-style bound (all ports + loop floors) in seconds."""
        return self.bound_cycles / machine.clock_hz

    def seconds_incore(self, machine: MachineModel) -> float:
        """In-core bound (operands resident; no memory ports) in seconds."""
        return self.bound_incore_cycles / machine.clock_hz

    def tier_bound_seconds(self, machine: MachineModel) -> float:
        """Tier-resolved bound: in-core time vs the memory-ladder term.

        Falls back to the flat port-model bound when the tier fields
        have not been resolved (see `portmodel.resolve_tiers`).
        """
        if self.t_mem_tier is None:
            return self.seconds(machine)
        return max(self.seconds_incore(machine), self.t_mem_tier)

    def bottleneck(self) -> str:
        """Dominant limiter: the busiest port, or 'LCD(serial)' when
        the sequential loop floors exceed every port."""
        if not self.port_occupation:
            return "none"
        if self.serial_cycles > self.tp_cycles:
            return "LCD(serial)"
        return max(self.port_occupation, key=self.port_occupation.get)
