"""MemTier-driven tile autotuner for the attention kernels.

The flash kernels used to ship hardcoded ``bq=512, bk=512`` tiles — a
number that is right on exactly one machine. The paper's lesson (and
the ECM lineage behind ``core/memtier.py``) is that the tile size that
keeps a kernel fast is a *property of the memory ladder*, so this
module derives tiles from the machine registry instead. Three effects
are priced per candidate, each straight off the machine file:

* **KV re-streaming** — the causal flash kernel re-reads K/V once per
  query block, so backing-tier traffic scales with ``1/bq``: bigger
  query tiles amortize the stream.
* **Score-tile residency** — the f32 score tile plus the
  online-softmax accumulators resolve to a home tier
  (``memtier.resolve_home``). While that home is *core-private*
  storage (VMEM, L1, L2 — ``MemTier.shared_bw == 0``), the KV stream
  double-buffers behind compute and the terms overlap (``max``); once
  the tile spills to a shared tier (L3/DRAM), every score access
  contends with the stream itself and the terms serialize (``sum``,
  classic pessimistic ECM). This is what the hardcoded 512s got wrong
  on the small-L2 CPUs.
* **Split parallelism** (decode) — KV splits run concurrently, so on a
  many-core socket they engage more cores against the shared DRAM
  ceiling (the flash-decoding win); each split costs one extra
  accumulator combine. Single-busy-core machines keep ``n_splits=1``.

The cheapest candidate wins, ties breaking toward the larger tile
(fewer grid steps amortize launch overhead the model does not price).
Machines therefore disagree — a 128 MB-VMEM TPU keeps the big score
tiles while the 1 MB-L2 Zen 4 core is pushed smaller — and
``tests/test_decode_kernel.py`` pins that spread so the tuner can
never silently degrade back into a constant.

Everything here is pure Python over the registry, so the tuner is
cheap to call at every launch; plans are memoized per ``(machine
name, shape)``.

The counterpart of ``repro/kernels/tuning.py``, copied, with one branch
of its own: on a GPU machine file (``h100``, ``h100_measured``) the
decode plan is priced on the grid the port's decode kernels launch, in
whole waves of the SMs, with the split merge's measured tail
(:func:`_decode_tiles_gpu`); the reference's per-core lanes would give
every extra split a core of its own. The serving path keeps
``decode.default_splits`` (``kernels/attention/ops.py``, the most
splits one wave holds), the same count at yi-9b's and gemma3-4b's
shapes; the flash-attention kernel keeps its
own shared-memory tiles (``kernels/attention/flash.py``), so
:func:`flash_tiles` only prices.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import memtier
from repro_torch.core.machine import MACHINES, get_machine, machine_fingerprint
from repro_torch.utils.hw import GpuSpec, dtype_bytes

#: manual tile-plan memo. Keyed on the machine's *content* fingerprint,
#: not its name: an lru_cache keyed on the name would keep serving the
#: old machine's tiles after a ``register(replace=True)`` with different
#: parameters — the exact staleness bug the plan-DB work audits away.
_TILE_MEMO: dict = {}
#: how tile requests were satisfied (mirrors planner.plan_stats)
_TILE_STATS = {"online": 0, "memo_hits": 0, "db_hits": 0}


def tile_stats() -> dict:
    """Counters of how tile plans were served since the last reset."""
    return dict(_TILE_STATS)


def reset_tile_stats() -> None:
    """Zero the tile-plan counters (tests and benchmarks)."""
    for k in _TILE_STATS:
        _TILE_STATS[k] = 0


def _memoized_tiles(kind: str, machine: str, kwargs: dict, compute):
    """Memo -> plan-DB -> online resolution for one tile request.

    The memo key folds ``machine_fingerprint`` so re-registered
    machines with changed parameters miss cleanly; an installed plan
    database (``serve.plandb``) is consulted before computing, and a
    DB hit is memoized so repeat requests stay O(1) dict probes.
    """
    m = get_machine(machine)
    key = (kind, m.name, machine_fingerprint(machine),
           tuple(sorted(kwargs.items())))
    hit = _TILE_MEMO.get(key)
    if hit is not None:
        _TILE_STATS["memo_hits"] += 1
        return hit
    from repro_torch.serve import plandb
    db = plandb.installed()
    if db is not None:
        plan = db.lookup_tiles(kind, m.name, kwargs)
        if plan is not None:
            _TILE_STATS["db_hits"] += 1
            _TILE_MEMO[key] = plan
            return plan
    _TILE_STATS["online"] += 1
    plan = compute()
    _TILE_MEMO[key] = plan
    return plan

#: candidate block sizes, kernel-friendly powers of two, largest first
#: so that cost ties keep the larger (launch-amortizing) tile
FLASH_BQ_CANDIDATES = (1024, 512, 256, 128)
FLASH_BK_CANDIDATES = (1024, 512, 256, 128)
DECODE_BK_CANDIDATES = (512, 256, 128, 64)
DECODE_SPLIT_CANDIDATES = (8, 4, 2, 1)
#: the GPU decode plan's split merge through L2 (``csrc/decode.cu``): a
#: launch of more than one split ends this long after its slowest split.
#: Measured on an H100 (700 W) at yi-9b's served shape by
#: ``scripts/torch_kernel_ab.py`` as the finished kernel's time less the
#: partials' alone: 2.39 and 2.26 µs in two runs
SPLIT_MERGE_S = 2.3e-6


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One autotuned tiling and the model cost that selected it."""

    machine: str
    bq: int                   # query block (1 token for decode)
    bk: int                   # KV block
    n_splits: int             # KV splits (flash-decoding); 1 for prefill
    seconds: float            # modeled kernel time of the priced shape
    home_tier: str            # tier the resident tile set resolves to
    ws_bytes: float           # per-step resident working set
    store_flavor: str = "standard"   # selected store path (stores.py)


def default_machine() -> str:
    """The machine tiles are tuned for when the caller names none.

    ``h100`` when a CUDA device is present, where the kernels run;
    elsewhere the JAX package's rule off the TPU: the calibrated
    ``host_cpu`` when one is registered, else ``tpu_v5e``.
    """
    import torch
    if torch.cuda.is_available():
        return "h100"
    if "host_cpu" in MACHINES:
        return "host_cpu"
    return "tpu_v5e"


def _mxu_seconds(m, macs: float, backend: str | None = None) -> float:
    """Modeled matmul time of ``macs`` multiply-accumulates on a machine.

    ``backend=None`` keeps the historical closed-form balanced-port
    arithmetic; naming a scheduling backend (core/backends) prices the
    same µ-ops through it instead — ``tp_bound`` is numerically
    identical, ``mca_sched`` adds its dispatch/latency pessimism.
    """
    e = m.table.get("mxu")
    if e is None:
        return 0.0
    passes = macs / (128.0 ** 3)
    if backend is not None:
        from repro_torch.core.backends import uops_seconds
        return uops_seconds(m, [("mxu", passes)], backend)
    return m.seconds(passes * e.cycles_per_unit / max(1, len(e.ports)))


def _vpu_seconds(m, elems: float, weight: float = 1.0,
                 backend: str | None = None) -> float:
    """Modeled elementwise time of ``elems`` f32 lanes (softmax etc.).

    ``backend`` as in :func:`_mxu_seconds`.
    """
    e = m.table.get("vpu")
    if e is None:
        return 0.0
    blocks = elems / (8.0 * 128.0)
    if backend is not None:
        from repro_torch.core.backends import uops_seconds
        return uops_seconds(m, [("vpu", weight * blocks)], backend)
    return m.seconds(weight * blocks * e.cycles_per_unit
                     / max(1, len(e.ports)))


def _resident_ws(bq: int, bk: int, dh: int, eb: int) -> float:
    """Bytes resident across one KV-block step: the f32 score tile, two
    generations of the f32 online-softmax accumulators (acc, m, l —
    read side and update side both live through the rescale), and the
    operand blocks."""
    scores = bq * bk * 4.0
    accs = bq * (dh + 2) * 4.0
    operands = (bq * dh + 2 * bk * dh) * eb
    return scores + 2.0 * accs + operands


def _tier_bw(tier, cores_active: int = 1) -> float:
    """Effective load bandwidth of one tier under ``cores_active``."""
    ld, _ = memtier.effective_bw(tier, cores_active)
    return max(ld, 1.0)


def _overlap_ok(tiers, home) -> bool:
    """Streaming overlaps compute only while the resident tile set
    lives in core-private storage (the innermost tier, or any tier
    with no shared socket ceiling)."""
    return home is tiers[0] or home.shared_bw == 0


def flash_tiles(machine: str, *, s: int, dh: int, h: int, hkv: int,
                dtype: str = "bf16",
                backend: str | None = None) -> TilePlan:
    """Autotuned (bq, bk) for the prefill/training flash kernel.

    Prices the causal kernel at sequence length ``s`` per candidate:
    stream / resident / compute terms composed by the overlap rule
    (module docstring) over the causal half-grid. ``machine`` is a
    registered name — plans are memoized on its content fingerprint
    (:func:`_memoized_tiles`). ``backend`` routes the compute term
    through a scheduling backend (``tp_bound`` reproduces the default
    closed form; ``mca_sched`` opts into simulator pessimism); None
    keeps the historical arithmetic.
    """
    kwargs = dict(s=s, dh=dh, h=h, hkv=hkv, dtype=dtype, backend=backend)
    return _memoized_tiles(
        "flash", machine, kwargs,
        lambda: _flash_tiles_online(machine, s=s, dh=dh, h=h, hkv=hkv,
                                    dtype=dtype, backend=backend))


def _flash_tiles_online(machine: str, *, s: int, dh: int, h: int,
                        hkv: int, dtype: str,
                        backend: str | None) -> TilePlan:
    m = get_machine(machine)
    tiers = memtier.tiers_of(m)
    backing = tiers[-1]
    eb = dtype_bytes(dtype)
    # compute is tiling-invariant: total MACs of the causal half
    t_cmp = _mxu_seconds(m, s * s * dh * h, backend) \
        + _vpu_seconds(m, s * s * h / 2.0, 3.0, backend)
    best = None
    for bq in FLASH_BQ_CANDIDATES:
        for bk in FLASH_BK_CANDIDATES:
            cbq, cbk = min(bq, s), min(bk, s)
            nq = math.ceil(s / cbq)
            nk = math.ceil(s / cbk)
            steps = nq * max(1.0, nk / 2.0)     # causal half grid
            ws = _resident_ws(cbq, cbk, dh, eb)
            home = memtier.resolve_home(tiers, ws)
            # every step touches the resident set ~twice (read+update)
            t_res = steps * 2.0 * ws / _tier_bw(home)
            # each q block streams its causal KV prefix (the flash grid
            # runs per q head, so the stream repeats h times)
            kv_total = nq * (s / 2.0) * 2.0 * dh * eb * h
            t_stream = kv_total / _tier_bw(backing)
            if _overlap_ok(tiers, home):
                total = max(t_stream, t_res, t_cmp)
            else:
                total = t_stream + t_res + t_cmp
            cand = TilePlan(machine=m.name, bq=cbq, bk=cbk, n_splits=1,
                            seconds=total, home_tier=home.name,
                            ws_bytes=ws)
            if best is None or total < best.seconds * (1.0 - 1e-9):
                best = cand
    from repro_torch.kernels.stores import select_store_flavor
    return dataclasses.replace(
        best, store_flavor=select_store_flavor(
            m.name, ws_bytes=s * 2.0 * dh * eb * hkv))


def decode_tiles(machine: str, *, skv: int, dh: int, h: int, hkv: int,
                 batch: int = 1, dtype: str = "bf16",
                 backend: str | None = None) -> TilePlan:
    """Autotuned (bk, n_splits) for the split-KV flash-decode kernel.

    The query tile is the packed (Hkv*G, Dh) head block — one token —
    so KV is streamed exactly once per step and the candidate choice
    trades per-block bookkeeping (favors big ``bk``) against score-row
    residency (favors small ``bk``) while ``n_splits`` buys concurrent
    cores against the shared backing-tier ceiling at the price of one
    cross-split combine pass per split. Memoized and
    ``backend``-routed as in :func:`flash_tiles`. ``dtype`` is a name
    ``dtype_bytes`` reads (``"bfloat16"``, ``str(torch.bfloat16)``).
    """
    kwargs = dict(skv=skv, dh=dh, h=h, hkv=hkv, batch=batch, dtype=dtype,
                  backend=backend)
    return _memoized_tiles(
        "decode", machine, kwargs,
        lambda: _decode_tiles_online(machine, skv=skv, dh=dh, h=h,
                                     hkv=hkv, batch=batch, dtype=dtype,
                                     backend=backend))


def _decode_tiles_online(machine: str, *, skv: int, dh: int, h: int,
                         hkv: int, batch: int, dtype: str,
                         backend: str | None) -> TilePlan:
    m = get_machine(machine)
    if isinstance(m.chip, GpuSpec):
        return _decode_tiles_gpu(m, skv=skv, dh=dh, h=h, hkv=hkv,
                                 batch=batch, dtype=dtype, backend=backend)
    tiers = memtier.tiers_of(m)
    backing = tiers[-1]
    eb = dtype_bytes(dtype)
    cores = max(1, getattr(m, "cores", 1))
    t_cmp = _mxu_seconds(m, 2.0 * batch * h * skv * dh, backend) \
        + _vpu_seconds(m, batch * h * skv, 3.0, backend)
    best = None
    for bk in DECODE_BK_CANDIDATES:
        cbk = min(bk, max(1, skv))
        nb = math.ceil(skv / cbk)
        ws = _resident_ws(h, cbk, dh, eb)
        home = memtier.resolve_home(tiers, ws)
        # per-block bookkeeping: the accumulators and the score rows
        # are touched every KV block
        t_res = batch * nb * 2.0 * ws / _tier_bw(home)
        for n_splits in DECODE_SPLIT_CANDIDATES:
            if n_splits > nb:
                continue
            lanes = min(batch * n_splits, cores)
            kv_total = batch * nb * cbk * 2.0 * dh * eb * hkv
            t_stream = kv_total / _tier_bw(backing, lanes)
            # splits run concurrently; the combine reads every split's
            # partial accumulator back once
            combine = _vpu_seconds(m, n_splits * batch * h * dh, 2.0,
                                   backend)
            par = min(n_splits, cores)
            if _overlap_ok(tiers, home):
                total = max(t_stream, t_res / par, t_cmp / par) + combine
            else:
                total = t_stream + (t_res + t_cmp) / par + combine
            cand = TilePlan(machine=m.name, bq=1, bk=cbk,
                            n_splits=n_splits, seconds=total,
                            home_tier=home.name, ws_bytes=ws)
            if best is None or total < best.seconds * (1.0 - 1e-9):
                best = cand
    from repro_torch.kernels.stores import select_store_flavor
    return dataclasses.replace(
        best, store_flavor=select_store_flavor(
            m.name, ws_bytes=batch * skv * 2.0 * dh * eb * hkv,
            cores_active=min(batch * best.n_splits, cores)))


def _decode_tiles_gpu(m, *, skv: int, dh: int, h: int, hkv: int,
                      batch: int, dtype: str,
                      backend: str | None) -> TilePlan:
    """The decode plan on a GPU machine file, priced on the grid the
    port's kernel launches (``decode.launch_ctas``: one thread block a
    KV head, packed row group, split and slot).

    The blocks run in whole waves of the SMs: ``ceil(blocks / SMs)``
    waves, each as long as one block streaming its split's K and V rows
    through its ring at the per-block rate of the backing tier (one SM's
    rate, capped by the tier's shared ceiling over the blocks streaming
    at once): the first tile of the kernel's ring
    (``decode.kernel_tile_rows``) loads before any math, and the later
    tiles load under the math and the per-block bookkeeping of the score
    tile (their home is an SM's own storage). More than one split adds
    the merge's measured tail (``SPLIT_MERGE_S``) and the reads of the
    other splits' fp32 partials at one block's rate."""
    import torch

    from repro_torch.kernels.attention.decode import (MERGE_MAX_SPLITS,
                                                      KERNEL_MAX_ROWS,
                                                      kernel_tile_rows,
                                                      launch_ctas)
    tiers = memtier.tiers_of(m)
    backing = tiers[-1]
    eb = dtype_bytes(dtype)
    sms = max(1, m.cores)
    rows = min(KERNEL_MAX_ROWS, max(1, h // max(1, hkv)))
    t_cmp = _mxu_seconds(m, 2.0 * batch * h * skv * dh, backend) \
        + _vpu_seconds(m, batch * h * skv, 3.0, backend)
    partial = rows * (dh + 2) * 4.0
    tile = kernel_tile_rows(torch.float32 if eb == 4 else torch.bfloat16,
                            dh)
    best = None
    for bk in DECODE_BK_CANDIDATES:
        cbk = min(bk, max(1, skv))
        nb = math.ceil(skv / cbk)
        ws = _resident_ws(rows, cbk, dh, eb)
        home = memtier.resolve_home(tiers, ws)
        for n_splits in DECODE_SPLIT_CANDIDATES:
            if n_splits > min(nb, MERGE_MAX_SPLITS):
                continue
            ctas = launch_ctas(batch, 1, h, hkv, n_splits)
            waves = math.ceil(ctas / sms)
            active = min(ctas, sms)
            split_rows = math.ceil(nb / n_splits) * cbk
            per_cta = memtier.effective_bw(backing, active)[0] / active
            row_s = 2.0 * dh * eb / per_cta
            t_stream = split_rows * row_s
            t_fill = min(tile, split_rows) * row_s
            t_res = (split_rows / cbk) * 2.0 * ws / _tier_bw(home)
            merge = 0.0
            if n_splits > 1:
                # the tail, and the first block's reads of the others'
                # fp32 partials (acc, m, l) at its share of the rate
                merge = SPLIT_MERGE_S + (n_splits - 1) * partial / per_cta
            t_block = max(t_stream, t_fill + t_res)
            total = max(waves * t_block, t_cmp) + merge
            cand = TilePlan(machine=m.name, bq=1, bk=cbk,
                            n_splits=n_splits, seconds=total,
                            home_tier=home.name, ws_bytes=ws)
            if best is None or total < best.seconds * (1.0 - 1e-9):
                best = cand
    from repro_torch.kernels.stores import select_store_flavor
    return dataclasses.replace(
        best, store_flavor=select_store_flavor(
            m.name, ws_bytes=batch * skv * 2.0 * dh * eb * hkv,
            cores_active=min(launch_ctas(batch, 1, h, hkv, best.n_splits),
                             sms)))


def fit_block(block: int, s: int) -> int:
    """Largest divisor of ``s`` not exceeding ``block``.

    The prefill kernel's grid requires tiles that divide the sequence
    exactly; snapping to the *largest* admissible divisor keeps the
    snapped tile as close to the priced plan as possible (a plain gcd
    collapses e.g. ``(256, 1000)`` to 8-wide blocks — a silent cliff).
    O(sqrt(s)).
    """
    block = max(1, min(block, s))
    if s % block == 0:
        return block
    best = 1
    i = 1
    while i * i <= s:
        if s % i == 0:
            for d in (i, s // i):
                if best < d <= block:
                    best = d
        i += 1
    return best


def clear_cache() -> None:
    """Drop memoized tile plans (tests re-register machines).

    Content-fingerprinted keys already miss when a machine's
    *parameters* change; clearing reclaims memory.
    """
    _TILE_MEMO.clear()
