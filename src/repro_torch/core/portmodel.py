"""Frontend of the in-core prediction engine.

The counterpart of ``repro/core/portmodel.py``. The pipeline is the JAX
package's, with an ATen trace in place of HLO text:

    trace.lower_step (the µ-op trace IR of one PyTorch function) -> a
    scheduling backend per (machine, backend) pair (core/backends/:
    analytical ``tp_bound``, simulated ``mca_sched``) -> Report
    (core/report.py) -> resolve_tiers (memory ladder).

``analyze`` prices one trace on one machine with one backend,
``compare`` fans one trace across machines x backends, and
``resolve_tiers`` fills a report's memory-ladder fields. ``compare``
runs serially: the JAX package's process pool changes no result
(``tests/test_trace_backends.py::test_compare_pool_matches_serial_nested``).
"""

from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core import backends as backends_lib
from repro_torch.core.backends.mca_sched import McaSchedBackend
from repro_torch.core.backends.tp_bound import TpBoundBackend
from repro_torch.core.machine import get_machine, registered_names
from repro_torch.core.report import Report
from repro_torch.core.trace import Trace


def analyze(trace: Trace, machine, backend="tp_bound") -> Report:
    """Price one trace on one machine (name or MachineModel) with one
    scheduling backend (name, alias, or Backend instance). As in the
    JAX package, the memory-ladder fields are left unresolved
    (:func:`resolve_tiers` fills them; :func:`compare` does)."""
    return backends_lib.get_backend(backend).run(trace, get_machine(machine))


def resolve_tiers(report: Report, machine) -> Report:
    """Fill a report's memory-ladder fields against one machine.

    Resolves the report's trip-multiplied HBM/DRAM traffic through the
    machine's MemTier ladder (core/memtier.py) and writes `t_mem_tier`,
    `bottleneck_tier`, and `home_tier` in place (returning the report
    for chaining). The working set is approximated by the traffic
    itself — whole-step analyses land on the backing tier, which is the
    flat pre-ladder behaviour.
    """
    from repro_torch.core import memtier  # local: memtier imports machine

    model = get_machine(machine)
    res = memtier.memory_seconds(model, report.bytes_hbm,
                                 cores_active=model.cores or 1)
    report.t_mem_tier = res.seconds
    report.bottleneck_tier = res.bottleneck_tier
    report.home_tier = res.home
    return report


def _warn_degraded_once(tasks, reports) -> None:
    """One warning for every µ-op class degraded in a fan-out (the
    backends run with warnings off and count them on the Report)."""
    degraded: dict = {}
    total = 0
    for (model, _b), rep in zip(tasks, reports):
        if rep.fallback_uops:
            total += rep.fallback_uops
            degraded.setdefault(model.name, set()).update(
                rep.fallback_classes)
    if not degraded:
        return
    detail = "; ".join(f"{m}: missing {sorted(cs)}"
                       for m, cs in degraded.items())
    warnings.warn(
        f"{total} µ-ops degraded to fallback classes during compare() "
        f"({detail}); counts are on Report.fallback_uops",
        RuntimeWarning, stacklevel=3)


def compare(trace: Trace, machines=None, backends=None) -> dict:
    """Price one trace across machines (and backends).

    `machines`: iterable of names and/or MachineModels; defaults to every
    registered machine. Every report comes back with its memory-ladder
    fields resolved (`resolve_tiers`), so callers can read the
    tier-resolved bound (`Report.tier_bound_seconds`) directly.

    `backends`: None or a single name keeps the shape ``{machine name:
    Report}`` (default backend: the analytical ``tp_bound``). An iterable
    of names returns ``{machine name: {backend name: Report}}`` — e.g.
    ``backends=("tp", "mca")`` for the paper's OSACA-vs-MCA comparison.
    Order is preserved. When both stock engines are asked for, only the
    simulator runs: its report contains the tp_bound one.
    """
    if machines is None:
        machines = registered_names()
    models = [get_machine(m) for m in machines]
    flat = backends is None or isinstance(backends, str) or \
        isinstance(backends, backends_lib.Backend)
    bspecs = ["tp_bound"] if backends is None else \
        ([backends] if flat else list(backends))
    bobjs, _seen = [], set()
    for b in bspecs:
        obj = backends_lib.get_backend(b)
        if obj.name not in _seen:
            _seen.add(obj.name)
            bobjs.append(obj)
    by_name = {b.name: b for b in bobjs}
    derive_tp = (not flat and {"tp_bound", "mca_sched"} <= set(by_name)
                 and type(by_name["tp_bound"]) is TpBoundBackend
                 and isinstance(by_name["mca_sched"], McaSchedBackend))
    run_objs = [b for b in bobjs if b.name != "tp_bound"] \
        if derive_tp else bobjs
    tasks = [(model, obj) for model in models for obj in run_objs]
    reports = [resolve_tiers(obj.run(trace, model, warn=False), model)
               for model, obj in tasks]
    _warn_degraded_once(tasks, reports)
    if flat:
        return {m.name: r for (m, _), r in zip(tasks, reports)}
    got = {(m.name, b.name): r for (m, b), r in zip(tasks, reports)}
    out: dict = {m.name: {} for m in models}
    for m in models:
        for b in bobjs:             # preserve the requested order
            if derive_tp and b.name == "tp_bound":
                out[m.name][b.name] = _derive_tp_report(
                    got[(m.name, "mca_sched")])
            else:
                out[m.name][b.name] = got[(m.name, b.name)]
    return out


def _derive_tp_report(mca_rep: Report) -> Report:
    """The tp_bound Report contained in a stock mca_sched Report: the
    simulator's analytic fields come from the same walk; clearing
    ``sim_cycles`` restores the analytical accessors. Dict fields are
    copied so the two reports share no mutable state."""
    return dataclasses.replace(
        mca_rep, backend="tp_bound", sim_cycles=None,
        port_occupation=dict(mca_rep.port_occupation),
        coll_bytes=dict(mca_rep.coll_bytes),
        trips_seen=dict(mca_rep.trips_seen),
        loop_bytes=dict(mca_rep.loop_bytes),
        fallback_classes=tuple(mca_rep.fallback_classes))
