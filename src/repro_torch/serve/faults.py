"""Seeded, deterministic fault injection for the serve engines.

The counterpart of ``repro/serve/faults.py``.
:class:`FaultyEngine` wraps either engine (dense or paged) behind the
exact engine surface the router drives (``admit`` / ``step`` /
``cancel`` / ``free_slots`` / ``slots``) and injects failures from a
precomputed, index-keyed schedule:

- ``step_error``: the decode round raises :class:`TransientFault`
  before touching the wrapped engine (a crashed dispatch).
- ``stuck``: the round makes no progress at all and reports a step
  latency of ``factor`` x the planned budget (a wedged replica).
- ``slow``: the round completes but reports ``factor`` x budget (a
  straggling replica).
- ``nonfinite``: a slot's cache rows are NaN-poisoned *before* the
  round, so the chunk's ``ok`` guard (``serve.decode``) trips and the
  engine quarantines the request; the injector scrubs the NaNs
  afterwards so recycled pages and slots cannot re-poison later
  admissions.
- ``admit_error``: the admission raises :class:`TransientFault`.
- ``pool_exhausted``: the admission raises
  :class:`~repro_torch.serve.pages.PoolExhausted` (injected on either
  layout, modeling a saturated page pool).

Poison and scrub write the cache's own tensors in place, never a new
cache: a CUDA-graph replay (``serve.decode.ChunkGraphs``) reads the
tensors whose addresses it captured, so the poison reaches the graph and
the graph keeps its cache.

Faults are keyed on the wrapper's own monotone step and admission
counters, never on wall-clock, so every recovery path in
``repro_torch.serve.health`` is reproducible on the virtual clock:
``last_step_seconds`` is *always* set (the planned budget when healthy,
``factor`` x budget under stuck/slow), and the chaos harness
(``repro_torch.bench.fig10_chaos``) advances simulated time from it.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch

from repro_torch.models.model import _walk
from repro_torch.serve.pages import PoolExhausted
from repro_torch.serve.planner import planned_round_seconds

STEP_KINDS = ("step_error", "stuck", "slow", "nonfinite")
ADMIT_KINDS = ("admit_error", "pool_exhausted")
KINDS = STEP_KINDS + ADMIT_KINDS


class TransientFault(RuntimeError):
    """A retryable failure injected into a serve step or admission.

    The router's backoff/retry policy treats it like ``QueueFull``:
    retry with exponential backoff against another (or the same)
    replica, shed only after the retry budget is spent.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires at the listed indices.

    ``at`` holds step indices for step kinds and admission indices for
    admission kinds (both 0-based wrapper-local counters). ``slot``
    picks the poisoned slot for ``nonfinite``; ``factor`` scales the
    planned per-round budget into the reported latency for
    ``stuck``/``slow``.
    """

    kind: str
    at: frozenset
    slot: int = 0
    factor: float = 50.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


def chaos_schedule(seed: int, n_steps: int, rates: dict,
                   slots: int = 1) -> tuple:
    """Draw a deterministic fault schedule from per-kind rates.

    ``rates`` maps fault kind -> per-index probability; each of the
    ``n_steps`` indices is sampled independently per kind from a
    ``numpy`` generator seeded with ``seed``, so identical arguments
    always produce the identical schedule (the property-based chaos
    tests rely on this). ``nonfinite`` faults round-robin their target
    slot over ``slots``. Returns a tuple of :class:`FaultSpec`.
    """
    rng = np.random.default_rng(seed)
    specs = []
    for kind in KINDS:
        rate = float(rates.get(kind, 0.0))
        if rate <= 0.0:
            continue
        hits = np.flatnonzero(rng.random(n_steps) < rate)
        if kind == "nonfinite":
            for j, i in enumerate(hits):
                specs.append(FaultSpec(kind, frozenset({int(i)}),
                                       slot=j % max(1, slots)))
        elif hits.size:
            specs.append(FaultSpec(kind, frozenset(int(i) for i in hits)))
    return tuple(specs)


def _float_leaves(cache: dict) -> list:
    return [t for _, t in _walk(cache) if t.is_floating_point()]


def _poison_leaf(leaf: torch.Tensor, axis1_size: int, index: int) -> None:
    """NaN one axis-1 row of a float leaf whose axis 1 is ``axis1_size``,
    in place."""
    if leaf.dim() >= 2 and leaf.shape[1] == axis1_size:
        leaf[:, index] = float("nan")


def poison_slot(engine, slot: int) -> None:
    """NaN-poison one slot's cache rows so its next logits go non-finite.

    Cache leaves are scan-stacked with the layer axis first, so the
    slot-batched axis (dense KV, recurrent state) is axis 1; paged KV
    leaves carry physical pages on axis 1 instead, and there the last
    *exclusively held* page of the slot is poisoned (poisoning a shared
    page would condemn every other holder, and ``prepare_write`` would
    copy the NaNs into the CoW clone). Recurrent slot-batched leaves
    (the fp32 Mamba and xLSTM state) are poisoned on either layout. Every
    write lands in the cache's own tensors.
    """
    if slot < 0 or slot >= engine.max_slots:
        raise ValueError(f"slot {slot} out of range")
    leaves = _float_leaves(engine.cache)
    for leaf in leaves:
        _poison_leaf(leaf, engine.max_slots, slot)
    if engine.paged:
        pool = engine.pool
        mine = [int(p) for p in engine.block_tables[slot] if p >= 0]
        own = [p for p in mine if pool.refcount[p] == 1]
        if own:
            for leaf in leaves:
                _poison_leaf(leaf, engine.n_pages + 1, own[-1])


def scrub_nonfinite(engine) -> None:
    """Replace every non-finite cache value with 0, in place (post-fault
    cleanup).

    Finite values are left bit for bit, so healthy slots are untouched;
    only the poisoned rows, whose request was quarantined and whose tokens
    are discarded anyway, are neutralized. Without this, a NaN page
    released back to the pool would re-poison whichever request recycles
    it (stale rows are position-masked, but ``0 * NaN`` is still ``NaN``
    through attention).
    """
    for leaf in _float_leaves(engine.cache):
        torch.nan_to_num_(leaf, nan=0.0, posinf=0.0, neginf=0.0)


class FaultyEngine:
    """Engine wrapper that injects scheduled faults, virtual-clock style.

    Everything not intercepted (``cancel``, ``free_slots``, ``slots``,
    ``plan``, ``chunk``, ``set_chunk``, ``drain_quarantined``, ...)
    delegates to the wrapped engine, so the wrapper drops into any
    router slot a real engine occupies. ``budget_s`` is the planned
    healthy per-round latency (defaulting to the wrapped engine's
    analytic plan via
    :func:`repro_torch.serve.planner.planned_round_seconds` when
    available); ``last_step_seconds`` reports it after every
    round — scaled by the fault's ``factor`` under stuck/slow — which
    is what the health tracker scores against the very same budget.
    """

    def __init__(self, inner, faults=(), budget_s: float | None = None):
        self.inner = inner
        self.faults = tuple(faults)
        if budget_s is None:
            plan = getattr(inner, "plan", None)
            if plan is not None:
                budget_s = planned_round_seconds(plan, chunk=inner.chunk)
            else:
                budget_s = 1e-3
        self.budget_s = float(budget_s)
        self.step_idx = 0
        self.admit_idx = 0
        self.injected: Counter = Counter()
        self.last_step_seconds = self.budget_s

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _firing(self, kinds, idx):
        return [f for f in self.faults
                if f.kind in kinds and idx in f.at]

    def admit(self, req, slot=None):
        """Admit through the wrapper, honoring scheduled admission faults."""
        idx = self.admit_idx
        self.admit_idx += 1
        for f in self._firing(ADMIT_KINDS, idx):
            self.injected[f.kind] += 1
            if f.kind == "admit_error":
                raise TransientFault(
                    f"injected admission fault at admit #{idx}")
            raise PoolExhausted(
                f"injected pool exhaustion at admit #{idx}")
        return self.inner.admit(req, slot)

    def step(self):
        """One decode round through the wrapper, honoring step faults."""
        idx = self.step_idx
        self.step_idx += 1
        firing = self._firing(STEP_KINDS, idx)
        self.last_step_seconds = self.budget_s
        poisoned = False
        for f in firing:
            self.injected[f.kind] += 1
            if f.kind == "step_error":
                raise TransientFault(f"injected step fault at step #{idx}")
            if f.kind == "stuck":
                self.last_step_seconds = f.factor * self.budget_s
                return []                     # no progress at all
            if f.kind == "slow":
                self.last_step_seconds = f.factor * self.budget_s
            if f.kind == "nonfinite":
                if self.inner.slots[f.slot] is not None:
                    poison_slot(self.inner, f.slot)
                    poisoned = True
        ret = self.inner.step()
        if poisoned:
            scrub_nonfinite(self.inner)
        return ret
