"""Analytical decode-chunk planning.

The counterpart of ``repro/serve/planner.py``, copied, with the decode
step's ATen trace (:func:`decode_step_trace`, ``core/trace.py``) where
the JAX planner reads the step's compiled HLO.

The serve engine amortizes per-dispatch overhead (host loop, graph
launch) over decode chunks. How many tokens a chunk should hold depends
on how long one decode step *takes* — which is exactly what the
analytical stack models: the decode step's trace is analyzed by the
port model (``portmodel.compare``) and the chunk size is chosen so the
modeled dispatch overhead stays below ``overhead_frac`` of the
tier-resolved per-step cost (``Report.tier_bound_seconds``).

Two things make planning cheap and occupancy-aware:

* **Memoized planning** — lowering the decode step and fanning
  ``portmodel.compare`` across the registry is orders of magnitude more
  expensive than the arithmetic around it, and every engine
  construction replans. Both the lowered trace and the finished plans
  are cached on ``(cfg, batch, max_len, ..., registered
  machine set)`` so repeat plans are O(1) dict hits.
* **Kernel-path pricing** — the trace prices the *dense* decode step:
  every slot reads the full ``max_len`` horizon. When the engine
  routes attention through the split-KV kernel, the only term that
  changes is the KV read traffic — bounded by occupancy rounded to the
  machine's autotuned KV block, not by the horizon. ``plan_chunk_size``
  re-prices that term through the memory ladder per machine
  (:func:`kv_read_seconds`), so the chunk size tracks how full the
  cache actually is.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import memtier, portmodel
from repro_torch.core import trace as trace_lib
from repro_torch.core.machine import (get_machine, registered_names,
                                registry_fingerprint)
from repro_torch.models import model as M

#: (cfg, batch, max_len, n_tokens, temperature) -> lowered Trace
_TRACE_CACHE: dict = {}
#: full plan key (incl. registry content fingerprint) -> ChunkPlan
_PLAN_CACHE: dict = {}
#: (cfg, batch, max_len, backend, registry fingerprint) -> the compare
#: fan-out of the memoized step trace: plans that differ only in how the
#: KV read is re-priced (occupancy, pages, TP) share one fan-out
_REPORT_CACHE: dict = {}
#: planner invocation counters — how each plan request was satisfied
#: (``db_hits`` stays 0: the plan database waits for ROADMAP queue 1
#: item 6)
_PLAN_STATS = {"online_plans": 0, "memo_hits": 0, "db_hits": 0}


def plan_stats() -> dict:
    """Counters of how plan requests were served since the last reset.

    ``online_plans`` counts full plans (trace lowering + port-model
    compare fan-out), ``memo_hits`` in-process memo returns, and
    ``db_hits`` plans loaded from a plan database (none in the port
    yet).
    """
    return dict(_PLAN_STATS)


def reset_plan_stats() -> None:
    """Zero the planner invocation counters (tests and benchmarks)."""
    for k in _PLAN_STATS:
        _PLAN_STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Planned decode chunk: size, the machine it was planned for, the
    tier-resolved per-step model cost there, and the per-machine costs of
    every machine the module was compared on. When the plan priced the
    split-KV kernel path, ``occupancy`` records the bound it assumed and
    ``per_machine_dense`` keeps the unadjusted full-horizon costs."""

    chunk: int
    machine: str
    t_step_seconds: float
    per_machine: dict            # machine name -> tier-resolved step seconds
    occupancy: int | None = None
    per_machine_dense: dict | None = None
    # which scheduling backend priced the step (core/backends)
    backend: str = "tp_bound"
    # KV-writer store flavor resolved for the plan's machine
    # (repro_torch.kernels.stores) and the per-machine selections
    store_flavor: str = "standard"
    per_machine_flavor: dict | None = None
    # paged-KV geometry the plan was priced for (None = dense slots):
    # the occupancy bound rounds to the page grid, not the autotuned
    # KV block, because a page is the paged kernel's DMA unit
    page_size: int | None = None
    # tensor-parallel degree the plan priced (1 = unsharded): the KV
    # stream is divided per shard and the per-step activation
    # all-reduce (kv_traffic.collective_traffic) is added per machine
    tp: int = 1
    # machine name -> seconds of the per-step collective (tp > 1 only)
    per_machine_collective: dict | None = None


def clear_plan_cache() -> None:
    """Drop every memoized planning artifact, together.

    Clears the lowered-trace memo, the finished-plan memo, AND the tile
    autotuner's memo (repro_torch.kernels.tuning) in one call — the three
    caches answer the same "what should this machine run" question, so
    tests that re-register machines must never see one cache
    invalidated and another serving stale answers. The memo keys also
    fold content fingerprints of the registered machines, so a
    ``register(replace=True)`` with *different* machine parameters
    misses the memo even without this call.
    """
    _TRACE_CACHE.clear()
    _PLAN_CACHE.clear()
    _REPORT_CACHE.clear()
    from repro_torch.kernels import tuning
    tuning.clear_cache()


def _meta_tree(shapes):
    """A tree of ``(shape, dtype)`` leaves as meta tensors."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    shape, dtype = shapes
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_step_trace(cfg: ModelConfig, batch: int, max_len: int,
                      n_tokens: int = 1,
                      temperature: float = 0.0) -> trace_lib.Trace:
    """The ATen trace of one n-token decode chunk at serve shapes.

    The counterpart of the JAX planner's ``decode_step_hlo``: the chunk
    (``serve.decode.make_chunk_body``) runs on meta tensors shaped by
    ``M.param_shapes`` and ``M.cache_shapes`` — nothing is materialized
    and no device is touched — with the attention's plain version
    (``impl="ref"``) over the full ``max_len`` horizon, the dense step
    the JAX planner prices before ``_kernel_adjusted``. Each decode
    kernel call lowers to one inline region (``core.trace.kernel``).
    Memoized on the argument key (cfg is a frozen dataclass).
    """
    key = (cfg, batch, max_len, n_tokens, temperature)
    hit = _TRACE_CACHE.get(key)
    if hit is not None:
        return hit
    from repro_torch.serve.decode import make_chunk_body

    body = make_chunk_body(cfg, n_tokens, temperature, impl="ref")
    params = _meta_tree(M.param_shapes(cfg))
    cache = _meta_tree(M.cache_shapes(cfg, batch, max_len))
    tokens = torch.empty((batch, 1), dtype=torch.int64, device="meta")
    pos = torch.empty((batch,), dtype=torch.int32, device="meta")
    noise = None
    if temperature > 0.0:
        noise = torch.empty((n_tokens, batch, cfg.vocab_size),
                            dtype=torch.float32, device="meta")
    tr = trace_lib.lower_step(body, params, cache, tokens, pos, noise=noise)
    _TRACE_CACHE[key] = tr
    return tr


def kv_read_seconds(cfg: ModelConfig, batch: int, kv_tokens: int,
                    machine, *, max_len: int | None = None,
                    tp: int = 1) -> float:
    """Tier-resolved seconds one decode step spends streaming KV.

    ``kv_tokens`` cache rows per slot, K and V, every attention layer —
    the traffic term that distinguishes the dense path (``kv_tokens =
    max_len``) from the split-KV kernel (``kv_tokens`` = occupancy
    rounded to the machine's block). The working set is the allocated
    cache (``max_len`` horizon), so the read resolves to the tier the
    slot cache actually lives in on that machine. ``tp`` divides both
    the stream and the working set per tensor-parallel shard (the
    kvheads -> TP cache layout): a shard streams ``1/tp`` of the rows'
    bytes, and its cache slice may even home a tier *inward* of the
    unsharded one.
    """
    from repro_torch.serve.kv_traffic import kv_row_bytes
    tp = max(1, int(tp))
    row = kv_row_bytes(cfg, batch) / tp
    ws = row * (max_len if max_len is not None else kv_tokens)
    m = get_machine(machine)
    return memtier.memory_seconds(m, row * kv_tokens, ws_bytes=ws,
                                  store_frac=0.0,
                                  cores_active=getattr(m, "cores", 1)
                                  ).seconds


def _kernel_adjusted(cfg: ModelConfig, batch: int, max_len: int,
                     occupancy: int | None, per_machine: dict,
                     page_size: int | None = None, tp: int = 1,
                     collective: dict | None = None) -> dict:
    """Re-price per-machine dense step costs for the executed KV path.

    Swaps the full-horizon unsharded KV read the dense trace priced
    for the one the engine actually streams: bounded by ``occupancy``
    when the split-KV kernel is routed — tiled and rounded exactly as
    the executed kernel path would be
    (``kv_traffic.bounded_decode_plan``; with ``page_size`` set the
    bound rounds to the page grid instead, since the paged kernel's KV
    block is pinned to the page) — and divided per shard when the
    cache is TP-sharded (``tp`` > 1, the kvheads layout). ``collective``
    adds each machine's per-step activation all-reduce seconds
    (``kv_traffic.collective_traffic``) on top. The floor keeps the
    adjusted cost from going below the priced KV stream itself when
    the port model and the ladder disagree about the dense share.
    The dense bound rounds to the tuner's KV block, which on ``h100`` is
    not always the 128-row block the port's dense path runs (see
    ``bounded_decode_plan``).
    """
    from repro_torch.serve.kv_traffic import bounded_decode_plan
    out = {}
    for name, t_dense in per_machine.items():
        if occupancy is None:
            bound = max_len
        elif page_size is not None:
            bound = min(math.ceil(occupancy / page_size) * page_size,
                        max_len)
        else:
            _, bound = bounded_decode_plan(cfg, batch, max_len, occupancy,
                                           name)
        dense_kv = kv_read_seconds(cfg, batch, max_len, name,
                                   max_len=max_len)
        split_kv = kv_read_seconds(cfg, batch, bound, name,
                                   max_len=max_len, tp=tp)
        coll = (collective or {}).get(name, 0.0)
        out[name] = max(t_dense - dense_kv + split_kv + coll,
                        split_kv + coll, 1e-12)
    return out


def plan_chunk_size(cfg: ModelConfig, batch: int, max_len: int, *,
                    machine: str | None = None,
                    dispatch_overhead_s: float = 2e-4,
                    overhead_frac: float = 0.1,
                    max_chunk: int = 32,
                    trace: trace_lib.Trace | None = None,
                    occupancy: int | None = None,
                    backend: str = "tp_bound",
                    store_flavor: str = "auto",
                    page_size: int | None = None,
                    tp: int | None = None) -> ChunkPlan:
    """Pick the decode chunk size from the port model's per-step cost.

    chunk = ceil(dispatch_overhead / (overhead_frac * t_step)) clamped to
    [1, max_chunk]: enough tokens a dispatch that the per-dispatch
    overhead is at most ``overhead_frac`` of the modeled chunk time.
    ``machine`` defaults to ``kernels.tuning.default_machine()`` (``h100``
    on a CUDA host); the compare fan-out prices every registered machine
    and the full table is kept on the plan for reporting.

    ``occupancy`` switches the plan to the split-KV kernel path: the
    per-machine costs are re-priced with the KV read bounded by that
    many rows (rounded to each machine's autotuned block), so a nearly
    empty cache plans *larger* chunks than a full one. ``backend``
    picks the scheduling backend that prices the step (core/backends):
    the analytical ``tp_bound`` by default; ``mca_sched`` plans against
    the simulator's pessimistic-or-equal step cost (never a larger
    chunk). Plans (and the lowered trace) are memoized; passing an
    explicit ``trace`` bypasses the plan cache.

    ``store_flavor`` ("standard" | "nt" | "auto") is resolved per
    machine against the slot cache working set (kernels.stores) and
    recorded on the plan.

    ``page_size`` records paged-KV geometry (serve.pages): the occupancy
    bound then rounds to the page grid (the paged kernel's KV block is
    pinned to the page) instead of the machine's autotuned dense block.

    ``tp`` > 1 prices a tensor-parallel plan as the JAX planner prices
    one without a mesh: the serve layout of a ``(data=1, model=tp)``
    mesh, the KV stream divided per shard and the per-step activation
    all-reduce (``kv_traffic.collective_traffic``) added per machine.
    Meshes themselves wait for ROADMAP queue 1 item 7.
    """
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels.tuning import default_machine
    from repro_torch.utils.sharding import (SERVE_ENGINE_RULES,
                                            rules_fingerprint, tp_degree)
    backend = get_backend(backend).name     # canonical (aliases fold)
    if machine is None:
        machine = default_machine()
    rules = None
    if tp is not None and int(tp) > 1:
        # meshless sharded pricing: stand in for a (1, tp) serve mesh
        mesh_sizes = {"data": 1, "model": int(tp)}
        rules = SERVE_ENGINE_RULES
        tp = tp_degree(mesh_sizes, rules)
    else:
        mesh_sizes, tp = {}, 1
    cache_key = None
    if trace is None:
        cache_key = (cfg, batch, max_len, machine, dispatch_overhead_s,
                     overhead_frac, max_chunk, occupancy, backend,
                     store_flavor, page_size,
                     tuple(sorted(mesh_sizes.items())),
                     rules_fingerprint(rules), tp, registry_fingerprint())
        hit = _PLAN_CACHE.get(cache_key)
        if hit is not None:
            _PLAN_STATS["memo_hits"] += 1
            return hit
        rkey = (cfg, batch, max_len, backend, registry_fingerprint())
        reports = _REPORT_CACHE.get(rkey)
        if reports is None:
            reports = _REPORT_CACHE[rkey] = portmodel.compare(
                decode_step_trace(cfg, batch, max_len, n_tokens=1),
                backends=backend)
    else:
        reports = portmodel.compare(trace, backends=backend)
    _PLAN_STATS["online_plans"] += 1
    per_machine = {name: rep.tier_bound_seconds(get_machine(name))
                   for name, rep in reports.items()}
    if per_machine.get(machine) is None:
        per_machine[get_machine(machine).name] = portmodel.analyze(
            trace or decode_step_trace(cfg, batch, max_len, n_tokens=1),
            machine, backend=backend).tier_bound_seconds(
                get_machine(machine))
    from repro_torch.kernels.stores import resolve_flavor
    from repro_torch.serve.kv_traffic import collective_traffic, kv_row_bytes
    cache_ws = kv_row_bytes(cfg, batch) * max_len
    per_machine_collective = None
    if tp > 1:
        per_machine_collective = {
            r["machine"]: r["coll_seconds"]
            for r in collective_traffic(cfg, batch, tp,
                                        machines=tuple(per_machine),
                                        ws_bytes=cache_ws)}
    per_machine_dense = None
    if occupancy is not None or tp > 1:
        per_machine_dense = dict(per_machine)
        per_machine = _kernel_adjusted(cfg, batch, max_len, occupancy,
                                       per_machine, page_size=page_size,
                                       tp=tp,
                                       collective=per_machine_collective)
    t_step = per_machine[get_machine(machine).name]
    chunk = 1 if t_step <= 0 else math.ceil(
        dispatch_overhead_s / (overhead_frac * t_step))
    chunk = max(1, min(max_chunk, chunk))
    per_machine_flavor = {
        name: resolve_flavor(store_flavor, name, ws_bytes=cache_ws,
                             cores_active=get_machine(name).cores)
        for name in per_machine}
    plan = ChunkPlan(chunk=chunk, machine=get_machine(machine).name,
                     t_step_seconds=t_step, per_machine=per_machine,
                     occupancy=occupancy,
                     per_machine_dense=per_machine_dense,
                     backend=backend,
                     store_flavor=per_machine_flavor[
                         get_machine(machine).name],
                     per_machine_flavor=per_machine_flavor,
                     page_size=page_size, tp=tp,
                     per_machine_collective=per_machine_collective)
    if cache_key is not None:
        _PLAN_CACHE[cache_key] = plan
    return plan


def planned_round_seconds(plan: ChunkPlan, chunk: int | None = None,
                          dispatch_overhead_s: float = 2e-4,
                          machine: str | None = None) -> float:
    """Modeled wall seconds of one decode round at ``chunk`` tokens.

    ``chunk`` in-graph steps at the plan's tier-resolved per-step cost
    plus one dispatch overhead — the health tracker's latency budget
    (``serve.health``) and the fault injector's virtual-clock unit
    (``serve.faults``) both come from here, so "slow" is always
    *slow relative to what the port model predicts for this machine*,
    not an absolute wall-clock constant. ``machine`` prices the round
    on another registered machine's column of the plan (default: the
    plan's own machine).
    """
    c = plan.chunk if chunk is None else max(1, int(chunk))
    t = plan.t_step_seconds if machine is None \
        else plan.per_machine[machine]
    return c * t + dispatch_overhead_s
