"""A Python loop that a trace lowering records as one loop region.

Kept apart from ``core/trace.py`` so that plain kernel versions
(``kernels/stream/ref.py``) can write such loops without depending on
the analysis layer: ``core.trace``'s recorder is a :class:`LoopRecorder`.
"""

from __future__ import annotations

from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)


class LoopRecorder(TorchDispatchMode):
    """A dispatch mode that records a :func:`repeat` loop as one region."""

    def looped(self, trips: int, step) -> None:
        """Record ``step(0)`` as the body of a loop of ``trips`` trips."""
        raise NotImplementedError


def repeat(trips: int, step) -> None:
    """Run ``step(i)`` for ``i`` in ``range(trips)``: a loop of identical
    steps, whose carried state ``step`` keeps in tensors it writes in
    place (or in its closure).

    Outside a lowering it is the plain loop. Inside one (a
    :class:`LoopRecorder`, ``core.trace.lower_step``), ``step(0)`` runs
    once and its ATen ops become one ``loop`` region of ``trips`` trips,
    as the JAX package's ``lax.scan``/``fori_loop`` lower to one HLO
    ``while``: the backends price the body times its trips (and its
    loop-carried chain), the trace stays one body long, and lowering a
    loop of thousands of steps costs one step.
    """
    rec = _get_current_dispatch_mode()
    if not isinstance(rec, LoopRecorder) or trips < 1:
        for i in range(trips):
            step(i)
        return
    rec.looped(int(trips), step)
