"""WA-priced KV-cache update traffic: donated (in-place) vs copied.

Each decode step writes one (Hkv, Dh) row per slot into every attention
layer's K and V buffers. With donation the dynamic-update-slice happens
in place — the traffic is the row itself plus whatever read-modify-write
the machine's write-allocate behaviour forces on the partial tiles it
touches (``wa.store_profile``). Without donation, XLA must first copy
the *whole* cache buffer — a system-scale write allocate, the failure
mode the paper's CloverLeaf WA study quantifies (arXiv:2311.04797) and
exactly what the old ``jnp.pad`` regrow in launch/serve.py used to do
every generation. The per-machine delta between the two is the serve
path's WA story in bytes.

:func:`decode_read_traffic` prices the *read* side of the same story:
dense full-horizon KV streaming vs the split-KV kernel's
occupancy-bounded blocks, per machine (each machine's autotuned KV
block sets its rounding).

The paged-KV engine (repro_torch.serve.pages / PagedServeEngine) adds three
traffic classes of its own, all priced through the same MemTier
ladder so the fig8 gates compare like with like:
:func:`page_gather_traffic` (block-table gather reads + the WA-priced
row store of the step), :func:`cow_fork_traffic` (the page copies
copy-on-write adds back), and :func:`page_admission_traffic`
(recycled-page admission vs the dense engine's horizon zero-fill).

A copy of ``repro/serve/kv_traffic.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.core import wa
from repro_torch.core.machine import get_machine, registered_names
from repro_torch.utils.hw import dtype_bytes

_JAX_DTYPE = {"bfloat16": "bf16", "float32": "f32", "float16": "f16"}


def attn_layer_count(cfg: ModelConfig) -> int:
    """Number of attention blocks (the layers that own a KV cache)."""
    return sum(blk.split(":")[0] in ("attn", "attn_local")
               for blk in cfg.layer_plan())


def kv_row_bytes(cfg: ModelConfig, batch: int) -> float:
    """Bytes one cache *row* (one token position) holds across the whole
    stack: K and V, every attention layer, every slot."""
    eb = dtype_bytes(_JAX_DTYPE.get(cfg.param_dtype, "f32"))
    return 2.0 * attn_layer_count(cfg) * batch \
        * cfg.n_kv_heads * cfg.head_dim_eff * eb


def tp_reduce_count(cfg: ModelConfig) -> int:
    """All-reduces one token step issues under tensor parallelism.

    Every mixer ends in an output projection contracting over a
    TP-sharded inner dim (attention heads, mamba/xLSTM inner, sLSTM
    hidden), and every FFN/MoE block contracts over the sharded
    ``mlp``/``emlp`` dim — each contributes one partial-sum all-reduce
    of the (B, d_model) activation per step.
    """
    n = 0
    for blk in cfg.layer_plan():
        n += 1                                   # mixer output projection
        if blk.split(":")[1] != "none":
            n += 1                               # FFN down projection
    return n


def collective_traffic(cfg: ModelConfig, batch: int, tp: int, *,
                       machines=None, ws_bytes: float | None = None,
                       cores_active: int | None = None) -> list:
    """Per-machine traffic of the per-step activation all-reduces.

    With the serving stack TP-sharded over ``tp`` shards, every decode
    token pays :func:`tp_reduce_count` ring all-reduces of the
    (B, d_model) activation: each shard moves ``2 * (tp-1)/tp`` of the
    payload in (loads) and the same out again (allocating stores of
    the reduced chunks). The store side is WA-priced through each
    machine's MemTier ladder (``memtier.transfer_time``) — homed to
    the tier ``ws_bytes`` resolves to (callers pass the serve step's
    resident working set; default is the ring traffic itself) — so the
    per-shard collective bytes preserve the paper's Grace <= SPR <=
    Zen 4 store-traffic ordering exactly like every other serve-path
    traffic class. ``tp=1`` prices to zero on every machine (no mesh,
    no collectives).
    """
    from repro_torch.core import memtier

    tp = max(1, int(tp))
    eb = dtype_bytes(_JAX_DTYPE.get(cfg.param_dtype, "f32"))
    n_red = tp_reduce_count(cfg)
    payload = float(batch * cfg.d_model * eb) * n_red
    ring = 2.0 * (tp - 1) / tp * payload
    rows = []
    for name in (machines if machines is not None else registered_names()):
        m = get_machine(name)
        res = memtier.transfer_time(
            m, ws_bytes=float(ws_bytes) if ws_bytes is not None else
            max(ring, 1.0),
            load_bytes=ring, store_bytes=ring,
            cores_active=cores_active if cores_active is not None
            else m.cores)
        rows.append({
            "machine": m.name, "tp": tp, "n_reduces": n_red,
            "payload_bytes": payload, "ring_bytes": ring,
            "coll_bytes": res.traffic_bytes,
            "coll_seconds": res.seconds,
            "home_tier": res.home,
        })
    if not all(math.isfinite(r["coll_seconds"]) for r in rows):
        raise AssertionError("non-finite collective-traffic pricing")
    return rows


def bounded_decode_plan(cfg: ModelConfig, batch: int, max_len: int,
                        occupancy: int, machine, tp: int = 1) -> tuple:
    """(TilePlan, bounded rows) of the split-KV kernel at an occupancy.

    This is the single source of truth for what the kernel path
    actually runs: the tiling is autotuned at the *streamed* length
    (the occupancy bound — exactly what ``ops.flash_decode`` does with
    its ``kv_len``), and the bound is then rounded up to that plan's
    KV block. Reporters (:func:`decode_read_traffic`) and the planner
    (``serve.planner._kernel_adjusted``) both price through here so
    they can never describe a different plan than the kernel executes.
    In the port the dense decode path keeps ``bk=128`` and
    ``decode.default_splits``; on ``h100`` the tuner's plan at yi-9b's
    and gemma3-4b's decode shapes has the same split count at every
    bucket from 512 rows up, but this bound rounds to the tuner's block,
    which at some occupancies is 64 rows. Under ``tp`` > 1 (KV heads on
    TP) the kernel runs on a shard's local heads, ``Hkv / tp`` of them,
    and is tuned there: on ``h100`` its grid of thread blocks shrinks by
    ``tp``, so more splits fit in one wave.
    """
    from repro_torch.kernels import tuning

    occupancy = max(1, min(int(occupancy), max_len))
    plan = tuning.decode_tiles(
        get_machine(machine).name, skv=occupancy, dh=cfg.head_dim_eff,
        h=cfg.n_heads // tp, hkv=cfg.n_kv_heads // tp, batch=batch,
        dtype=cfg.param_dtype)
    bound = min(math.ceil(occupancy / plan.bk) * plan.bk, max_len)
    return plan, bound




def decode_kv_profiles(cfg: ModelConfig, batch: int,
                       max_len: int) -> dict:
    """Per-decode-step KV-store profiles: ``donated`` and ``copied``.

    Aggregated over all attention layers and both K and V: one
    (Hkv, Dh) row per slot, dynamic (offset-unaligned) sequence offset.
    The ``copied`` profile adds the whole-buffer copy a non-donated
    update would force. Returns the two StoreProfiles plus the total
    cache bytes (the working set gating SpecI2M saturation).
    """
    n_attn = attn_layer_count(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim_eff
    dtype = _JAX_DTYPE.get(cfg.param_dtype, "f32")
    eb = dtype_bytes(dtype)
    row = wa.store_profile((hkv, dh), dtype, offset_aligned=False,
                           donated=True, full_overwrite=False)
    n_stores = 2 * n_attn * batch            # K and V, per layer, per slot
    leaf_bytes = float(batch * max_len * hkv * dh * eb)
    cache_bytes = 2 * n_attn * leaf_bytes
    donated = wa.StoreProfile(row.stored_bytes * n_stores,
                              row.rmw_read_bytes * n_stores)
    copied = wa.StoreProfile(donated.stored_bytes, donated.rmw_read_bytes,
                             copy_bytes=cache_bytes)
    return {"donated": donated, "copied": copied,
            "cache_bytes": cache_bytes, "n_attn_layers": n_attn}


def decode_read_traffic(cfg: ModelConfig, batch: int, max_len: int,
                        occupancy: int, *, machines=None) -> list:
    """Per-machine dense-vs-split-KV decode *read* traffic, per step.

    The dense decode path streams every ``max_len`` cache row of every
    attention layer for every slot on every token; the split-KV kernel's
    block early-out streams only the occupied prefix, rounded up to the
    machine's autotuned KV block (:func:`bounded_decode_plan` — so the
    rounding itself is per-machine, and identical to what the executed
    kernel path uses). Rows carry both byte counts and their ratio
    (> 1 whenever the cache is not full): the serve-scale version of
    the paper's never-move-bytes-you-don't-need WA lesson, in read
    traffic instead of allocate traffic.
    """
    occupancy = max(1, min(int(occupancy), max_len))
    row_bytes = kv_row_bytes(cfg, batch)
    dense = row_bytes * max_len
    rows = []
    for name in (machines if machines is not None else registered_names()):
        m = get_machine(name)
        plan, bound = bounded_decode_plan(cfg, batch, max_len,
                                          occupancy, m.name)
        split = row_bytes * bound
        rows.append({
            "machine": m.name, "bk": plan.bk, "n_splits": plan.n_splits,
            "occupancy": occupancy, "max_len": max_len,
            "dense_read_bytes": dense, "split_read_bytes": split,
            "read_ratio": dense / split,
            "n_attn_layers": attn_layer_count(cfg),
        })
    if not all(math.isfinite(r["read_ratio"]) for r in rows):
        raise AssertionError("non-finite KV read-traffic pricing")
    return rows


def kv_update_traffic(cfg: ModelConfig, batch: int, max_len: int, *,
                      machines=None, nt_stores: bool = False,
                      flavor: str | None = None) -> list:
    """Per-machine donated-vs-copied KV-update traffic, one dict per row.

    Rows carry the machine's WA mode, the per-decode-step traffic of the
    donated (in-place) update and of the non-donated (copy-first) update,
    and their delta — what cache donation saves on that machine, priced
    through its Fig. 4 behavioural mode with the SpecI2M gate modeled on
    the full cache working set.

    ``flavor`` switches pricing to the store-flavor path
    (repro_torch.kernels.stores): ``"auto"`` resolves each machine's cheaper
    flavor against the cache working set, the residues come from the
    MemTier ladder, and every row records the ``store_flavor`` it was
    priced with. ``flavor=None`` keeps the legacy ``nt_stores``
    calibration-constant pricing (and records the flavor that implies).
    """
    from repro_torch.kernels.stores import resolve_flavor
    profs = decode_kv_profiles(cfg, batch, max_len)
    rows = []
    for name in (machines if machines is not None else registered_names()):
        m = get_machine(name)
        kw = dict(ws_bytes=profs["cache_bytes"], cores_active=m.cores)
        if flavor is not None:
            resolved = resolve_flavor(flavor, m, **kw)
            kw["flavor"] = resolved
        else:
            resolved = "nt" if nt_stores else "standard"
            kw["nt_stores"] = nt_stores
        donated = wa.priced_store_traffic(profs["donated"], m, **kw)
        copied = wa.priced_store_traffic(profs["copied"], m, **kw)
        rows.append({
            "machine": m.name, "wa_mode": m.wa_mode,
            "store_flavor": resolved,
            "stored_bytes": profs["donated"].stored_bytes,
            "donated_bytes": donated, "copied_bytes": copied,
            "delta_bytes": copied - donated,
            "cache_bytes": profs["cache_bytes"],
            "n_attn_layers": profs["n_attn_layers"],
        })
    if not math.isfinite(sum(r["delta_bytes"] for r in rows)):
        raise AssertionError("non-finite KV traffic pricing")
    return rows


# --- paged-KV traffic classes (repro_torch.serve.pages) -------------------------

def page_bytes(cfg: ModelConfig, page_size: int) -> float:
    """Bytes one physical page holds across the stack (K and V, every
    attention layer, one slot's worth of rows)."""
    return kv_row_bytes(cfg, 1) * page_size


def page_gather_traffic(cfg: ModelConfig, batch: int, max_len: int,
                        occupancy: int, page_size: int, *,
                        machines=None, flavor: str = "auto") -> list:
    """Per-machine decode traffic of the paged engine, per step.

    Read side: only the ``ceil(occupancy / page)`` *live* pages of each
    slot are gathered (the block-table clamp in
    ``ops.flash_decode_paged``), plus the table entries themselves —
    one int32 per live page per layer per K/V leaf, the dependent load
    the dense path never issues. The gather is pure loads, so it is
    machine-invariant in bytes; the machine ordering of the total rides
    on the store side — the step's KV row writes, WA-priced against the
    page-pool working set exactly like :func:`kv_update_traffic` prices
    the dense ones. ``read_ratio`` compares against the dense
    full-horizon stream (> 1 whenever slots are not full).

    Rows also carry ``gather_seconds``: the ladder-resolved time of the
    gather (``memtier.page_gather_time``) with the pool as working set.
    """
    from repro_torch.core import memtier
    from repro_torch.serve.pages import pages_per_slot

    occupancy = max(1, min(int(occupancy), max_len))
    ps = int(page_size)
    pps = pages_per_slot(max_len, ps)
    live = min(math.ceil(occupancy / ps), pps)
    row = kv_row_bytes(cfg, batch)
    gather = kv_row_bytes(cfg, 1) * live * ps * batch
    n_attn = attn_layer_count(cfg)
    table = 2.0 * n_attn * batch * live * 4.0      # int32 entries, K and V
    dense = row * max_len
    profs = decode_kv_profiles(cfg, batch, pps * ps)
    rows = []
    for name in (machines if machines is not None else registered_names()):
        m = get_machine(name)
        store = wa.priced_store_traffic(
            profs["donated"], m, ws_bytes=profs["cache_bytes"],
            cores_active=m.cores, flavor=flavor)
        res = memtier.page_gather_time(
            m, n_pages=live * batch, page_bytes=page_bytes(cfg, ps),
            table_bytes=table, ws_bytes=profs["cache_bytes"],
            cores_active=m.cores)
        rows.append({
            "machine": m.name, "page_size": ps, "live_pages": live,
            "occupancy": occupancy, "max_len": max_len,
            "gather_read_bytes": gather, "table_read_bytes": table,
            "store_bytes": store,
            "total_bytes": gather + table + store,
            "dense_read_bytes": dense,
            "read_ratio": dense / (gather + table),
            "gather_seconds": res.seconds,
            "n_attn_layers": n_attn,
        })
    if not all(math.isfinite(r["total_bytes"]) for r in rows):
        raise AssertionError("non-finite page-gather pricing")
    return rows


def cow_fork_traffic(cfg: ModelConfig, page_size: int, *,
                     n_copies: int = 1, machines=None,
                     flavor: str = "auto") -> list:
    """Per-machine cost of ``n_copies`` copy-on-write page copies.

    A CoW copy reads the shared page and stores a fresh one — the store
    is an allocating streaming write, so it carries each machine's WA
    ratio (Zen 4 pays the destination read, Grace's claim mode does
    not). Rows carry both the WA-priced bytes and the ladder-resolved
    seconds (``memtier.page_copy_time``).
    """
    from repro_torch.core import memtier

    pb = page_bytes(cfg, int(page_size))
    read = pb * n_copies
    prof = wa.StoreProfile(stored_bytes=pb * n_copies, rmw_read_bytes=0.0)
    rows = []
    for name in (machines if machines is not None else registered_names()):
        m = get_machine(name)
        store = wa.priced_store_traffic(prof, m, ws_bytes=2.0 * pb,
                                        cores_active=m.cores, flavor=flavor)
        res = memtier.page_copy_time(m, page_bytes=pb, n_pages=n_copies,
                                     cores_active=m.cores)
        rows.append({
            "machine": m.name, "page_size": int(page_size),
            "n_copies": int(n_copies), "page_bytes": pb,
            "read_bytes": read, "store_bytes": store,
            "total_bytes": read + store,
            "copy_seconds": res.seconds,
        })
    if not all(math.isfinite(r["total_bytes"]) for r in rows):
        raise AssertionError("non-finite CoW pricing")
    return rows


def page_admission_traffic(cfg: ModelConfig, prompt_len: int, max_len: int,
                           page_size: int, *, shared_pages: int = 0,
                           machines=None, flavor: str = "auto") -> list:
    """Per-machine admission stores: paged recycling vs dense zero-fill.

    A dense admission stores the *whole horizon*: prompt rows plus a
    zero-fill out to ``max_len`` (``make_prefill_step``'s in-graph
    ``pad_to_horizon``). A paged admission stores only the prompt's
    unshared pages — a recycled page is overwritten in place with no
    zero-fill at all (stale rows are masked by position), and a fresh
    page additionally pays its share of the pool's one-time zero init.
    All three are WA-priced as streaming stores against the same
    horizon-sized working set. ``recycled_bytes`` is strictly below
    ``zero_fill_bytes`` on every machine whenever the prompt's pages
    cover less than the horizon — the admission-side WA gate fig8
    asserts.
    """
    ps = int(page_size)
    npg = math.ceil(max(1, int(prompt_len)) / ps)
    shared = max(0, min(int(shared_pages), npg))
    row1 = kv_row_bytes(cfg, 1)
    ws = row1 * max_len
    prof_zero = wa.StoreProfile(stored_bytes=row1 * max_len,
                                rmw_read_bytes=0.0)
    payload = row1 * (npg - shared) * ps
    prof_recycled = wa.StoreProfile(stored_bytes=payload,
                                    rmw_read_bytes=0.0)
    prof_fresh = wa.StoreProfile(stored_bytes=2.0 * payload,
                                 rmw_read_bytes=0.0)
    rows = []
    for name in (machines if machines is not None else registered_names()):
        m = get_machine(name)
        kw = dict(ws_bytes=ws, cores_active=m.cores, flavor=flavor)
        zero = wa.priced_store_traffic(prof_zero, m, **kw)
        recycled = wa.priced_store_traffic(prof_recycled, m, **kw)
        fresh = wa.priced_store_traffic(prof_fresh, m, **kw)
        rows.append({
            "machine": m.name, "page_size": ps, "prompt_len": prompt_len,
            "max_len": max_len, "prompt_pages": npg,
            "shared_pages": shared,
            "zero_fill_bytes": zero, "recycled_bytes": recycled,
            "fresh_bytes": fresh,
            "savings_ratio": zero / max(recycled, 1e-30),
        })
    if not all(math.isfinite(r["savings_ratio"]) for r in rows):
        raise AssertionError("non-finite admission pricing")
    return rows


def rescue_traffic(cfg: ModelConfig, prompt_len: int, prefix_len: int,
                   max_len: int, *, page_size: int | None = None,
                   shared_pages: int = 0, machines=None,
                   flavor: str = "auto") -> list:
    """Per-machine cost of rescuing one stream by prompt+prefix replay.

    A rescue resubmits an ejected request as a fresh admission whose
    prompt is the original prompt plus the ``prefix_len`` tokens
    already emitted — the replay prefill rebuilds exactly the KV rows
    the dead replica held. The store side is the same WA-priced
    admission as any other (:func:`page_admission_traffic`): paged
    rescues pay only the replayed rows' unshared pages (prefix sharing
    makes a rescue onto a replica that served a sibling prompt nearly
    free), dense rescues pay the full horizon zero-fill. Returned rows
    add ``replay_tokens`` and ``rescue_bytes`` (the layout's admission
    store: ``recycled_bytes`` when paged, ``zero_fill_bytes`` when
    dense) so the health layer can log a priced rescue decision.
    """
    replay = int(prompt_len) + int(prefix_len)
    if replay > max_len:
        raise ValueError(
            f"rescue replay of {replay} tokens exceeds horizon {max_len}")
    ps = int(page_size) if page_size is not None else int(max_len)
    rows = page_admission_traffic(cfg, replay, max_len, ps,
                                  shared_pages=shared_pages,
                                  machines=machines, flavor=flavor)
    for r in rows:
        r["replay_tokens"] = replay
        r["rescue_bytes"] = r["recycled_bytes"] if page_size is not None \
            else r["zero_fill_bytes"]
    return rows
