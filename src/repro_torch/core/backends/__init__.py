"""Pluggable scheduling backends over the µ-op trace IR.

A backend turns one machine-independent :class:`repro_torch.core.trace.Trace`
into a :class:`repro_torch.core.report.Report` for one machine:

    class Backend(Protocol):
        name: str
        def run(self, trace, machine, warn=True) -> Report: ...

Shipped backends:

 * ``tp_bound``  — the analytical OSACA-style port-occupation bound
   (TP/CP/LCD); optimistic/lower bound, the default everywhere.
 * ``mca_sched`` — an LLVM-MCA-style cycle simulator (in-order
   dispatch, bounded scheduler window, out-of-order issue with port
   contention); pessimistic-or-equal by construction.

Both run over the *same* trace, so a registry-wide
``portmodel.compare`` decomposes each module exactly once. Register
additional engines with :func:`register_backend`; short aliases
(``tp``, ``mca``, ``osaca``) resolve through :func:`get_backend`.

A copy of ``repro/core/backends/__init__.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.report import Report
from repro_torch.core.trace import Trace, TraceOp, TraceRegion


@runtime_checkable
class Backend(Protocol):
    """The backend protocol: a name and a ``run(trace, machine)``."""

    name: str

    def run(self, trace: Trace, machine, warn: bool = True) -> Report:
        """Schedule one trace on one machine; returns a Report."""
        ...


#: name -> Backend instance. Mutated only through register_backend().
BACKENDS: dict = {}

#: short/paper spellings accepted anywhere a backend name is
ALIASES = {"tp": "tp_bound", "osaca": "tp_bound", "mca": "mca_sched",
           "llvm-mca": "mca_sched"}


def register_backend(backend: Backend, *, replace: bool = False) -> Backend:
    """Add a backend to the registry; returns it for chaining."""
    if not backend.name:
        raise ValueError("backend needs a non-empty name")
    if backend.name in BACKENDS and not replace:
        raise ValueError(f"backend {backend.name!r} already registered "
                         f"(pass replace=True)")
    BACKENDS[backend.name] = backend
    return backend


def get_backend(backend) -> Backend:
    """Resolve a backend by name/alias, or pass an instance through."""
    if not isinstance(backend, str):
        if isinstance(backend, Backend):
            return backend
        raise TypeError(f"not a backend: {backend!r}")
    name = ALIASES.get(backend, backend)
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; registered: "
                       f"{sorted(BACKENDS)}") from None


def registered_backends() -> tuple:
    """Names of every registered backend, in registration order."""
    return tuple(BACKENDS)


def uops_seconds(machine, uops, backend="tp_bound") -> float:
    """Price a raw µ-op list on one machine through a backend.

    Builds a one-op trace from ``uops`` (``[(class, units), ...]``) and
    returns the backend's in-core estimate in seconds. With the default
    ``tp_bound`` this equals the closed-form balanced-port arithmetic
    the kernel autotuner historically used; a simulator backend adds
    its dispatch/latency pessimism. Degradation of unknown classes is
    silent here (the caller is pricing a hypothetical, not a module).
    """
    from repro_torch.core.machine import get_machine
    op = TraceOp(name="uops", opcode="priced", kind="op",
                 uops=tuple(uops), lat_cls="vpu")
    tr = Trace("uops", TraceRegion("uops", False, [op]))
    model = get_machine(machine)
    rep = get_backend(backend).run(tr, model, warn=False)
    return rep.seconds_incore(model)


def _register_builtin() -> None:
    from repro_torch.core.backends.mca_sched import McaSchedBackend
    from repro_torch.core.backends.tp_bound import TpBoundBackend
    register_backend(TpBoundBackend())
    register_backend(McaSchedBackend())


_register_builtin()
