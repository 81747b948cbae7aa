"""Fig. 11: the overlapped serving runtime on the port: pipelined decode
dispatch against serial rounds, the priced copy cost of the reference's
overlap, and the offline plan database.

The counterpart of ``benchmarks/fig11_overlap.py``, with its three
sections:

1. **Dispatch overlap.** With ``pipeline=2`` the engine enqueues round
   N+1 while round N is still on the device, so the host gap between
   consecutive decode enqueues shrinks and tokens/s rises. At the
   reference's cell (yi-9b's smoke configuration, 16 slots, chunk 8, 96
   new tokens, 12-token prompts), dense and paged, the modes interleaved
   over repeats. Gated: streams byte-identical; dense: a gap reduction
   over 1 and a median paired speedup of at least 1.0; paged: at least
   0.9. The timing gates hold on the card, where a round's kernels run
   while the host works. On the host (``--device cpu``) PyTorch's CPU
   ops run synchronously, so there is no overlap to measure: the rows
   print their timings and gate the streams alone. On the card one more
   row runs yi-9b at its published width (48 layers) at the same cell,
   printed without a gate.
2. **Priced copy cost.** The reference's pipelined mode cannot donate
   its cache, so it pays a copy-first cache update, whose WA-priced store
   traffic (``serve.kv_traffic.kv_update_traffic``, ``delta_bytes``) must
   keep the paper's order Grace <= SPR <= Zen 4. The port writes its
   cache in place in both modes and never pays this copy; the row prices
   the reference's cost, as the reference prints it.
3. **Plan database.** A sweep (both planner backends) installed makes
   planning for every registered machine a database hit with zero online
   plans, each plan equal to the online one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench._common import on_card, where
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.serve.kv_traffic import kv_update_traffic

ARCH = "yi-9b"                    # GQA: distinct n_heads / n_kv_heads
SLOTS, CHUNK, GEN, PROMPT = 16, 8, 96, 12
ORDER = ("neoverse_v2", "golden_cove", "zen4")   # Grace, SPR, Genoa
#: interleaved pairs of the full-width row on the card
CARD_FULL_REPEATS = 3


def _requests(cfg, seed: int) -> list:
    """One full batch of seeded random-prompt requests."""
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}",
                    prompt=tuple(int(t) for t in
                                 rng.integers(0, cfg.vocab_size, PROMPT)),
                    max_new_tokens=GEN)
            for i in range(SLOTS)]


def _run_once(eng, cfg, seed: int):
    """One timed serve of a full batch; returns (wall_s, gap_s, results).

    The gap counters are reset each run, so that each repeat measures its
    own mean enqueue-to-enqueue gap.
    """
    eng.dispatch_gap_s, eng.gap_rounds = 0.0, 0
    eng._t_enqueued = None
    reqs = _requests(cfg, seed)
    if on_card(eng.device):
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    return wall, eng.stats()["mean_dispatch_gap_s"], results


def _measure_pair(engs: dict, cfg, repeats: int, seed: int) -> dict:
    """Warm both engines, then ``repeats`` runs of each with the modes
    interleaved (serial, pipelined, serial, ...), so that slow drift of
    the host's load hits both. Returns {mode: (min wall, median gap,
    results)} and the sorted paired speedups."""
    for eng in engs.values():                # graphs captured, caches warm
        _run_once(eng, cfg, seed)
    walls = {m: [] for m in engs}
    gaps = {m: [] for m in engs}
    results = {}
    for _ in range(repeats):
        for mode, eng in engs.items():
            w, g, results[mode] = _run_once(eng, cfg, seed)
            walls[mode].append(w)
            gaps[mode].append(g)
    out = {m: (min(walls[m]), sorted(gaps[m])[repeats // 2], results[m])
           for m in engs}
    out["pair_speedups"] = sorted(
        ws / wp for ws, wp in zip(walls["serial"], walls["pipelined"]))
    return out


def _stream_key(results: dict) -> tuple:
    return tuple((rid, tuple(int(t) for t in results[rid]))
                 for rid in sorted(results))


def _engines(cfg, params, kind: str, device) -> dict:
    def mk(pipeline):
        kw = dict(max_slots=SLOTS, max_len=PROMPT + GEN, chunk=CHUNK,
                  pipeline=pipeline, device=device)
        if kind == "paged":
            return PagedServeEngine(cfg, params, page_size=8, **kw)
        return ServeEngine(cfg, params, **kw)
    return {"serial": mk(0), "pipelined": mk(2)}


def overlap_row(cfg, params, kind: str, repeats: int, device, *,
                gated: bool, tag: str = "") -> str:
    """Serial against pipelined on one engine kind; the streams always
    gated, the timings when ``gated``."""
    engs = _engines(cfg, params, kind, device)
    runs = _measure_pair(engs, cfg, repeats, seed=7)
    if gated and kind == "dense" \
            and runs["pair_speedups"][repeats // 2] < 1.0:
        # a transient load storm can bury the win in one block of pairs;
        # one independent measurement of twice the pairs must confirm
        # before the gate fails
        runs = _measure_pair(engs, cfg, 2 * repeats, seed=7)
    (w_s, g_s, r_s), (w_p, g_p, r_p) = runs["serial"], runs["pipelined"]
    pairs = runs["pair_speedups"]
    if _stream_key(r_s) != _stream_key(r_p):
        raise AssertionError(
            f"{kind}: pipelined token streams diverged from serial")
    d_s, d_p = (engs[m].decode_dispatches for m in ("serial", "pipelined"))
    if d_s != d_p:
        raise AssertionError(f"{kind}: {d_p} pipelined decode dispatches "
                             f"against {d_s} serial")
    tok_s, tok_p = SLOTS * GEN / w_s, SLOTS * GEN / w_p
    gap_red = g_s / max(g_p, 1e-12)
    # the median of the paired ratios: adjacent pairs cancel common-mode
    # host load, and the median tolerates a minority of polluted pairs
    speedup = pairs[len(pairs) // 2]
    line = (f"fig11,overlap.{kind}{tag},{w_p*1e6:.0f},"
            f"slots={SLOTS};chunk={CHUNK};gen={GEN};repeats={repeats};"
            f"layers={cfg.n_layers};d_model={cfg.d_model};"
            f"tok_s_serial={tok_s:.1f};tok_s_pipelined={tok_p:.1f};"
            f"speedup_median_paired={speedup:.3f};"
            f"gap_serial_ms={g_s*1e3:.3f};"
            f"gap_pipelined_ms={g_p*1e3:.3f};gap_reduction={gap_red:.2f};"
            f"streams=IDENTICAL;gates={'on' if gated else 'off'};"
            f"device={where(device)}")
    if gated and kind == "dense":
        if not gap_red > 1.0:
            raise AssertionError(
                f"dense: no dispatch-gap reduction ({gap_red:.2f}x)")
        if not speedup >= 1.0:
            raise AssertionError(
                f"dense: pipelined slower (median paired {speedup:.3f}x, "
                f"pairs {[round(p, 3) for p in pairs]})")
    elif gated and not speedup >= 0.9:
        # the paged round's host work (block tables) dilutes the win
        raise AssertionError(f"paged: pipelined regressed badly "
                             f"({speedup:.3f}x)")
    return line


def overlap_lines(device, repeats: int) -> list:
    """Section 1: the reference's cell, dense and paged, gated on the
    card; on the card also yi-9b at its published width, ungated."""
    card = on_card(device)
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    lines = [overlap_row(cfg, params, kind, repeats, device, gated=card)
             for kind in ("dense", "paged")]
    if card:
        del params
        cfg = get_config(ARCH)
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
        lines.append(overlap_row(cfg, params, "dense", CARD_FULL_REPEATS,
                                 device, gated=False, tag=".full_width"))
        del params
        torch.cuda.empty_cache()
    return lines


def priced_lines(cfg) -> list:
    """Section 2: the reference's per-machine copy cost of overlap, gated
    on the Grace <= SPR <= Zen 4 order."""
    rows = {r["machine"]: r for r in kv_update_traffic(
        cfg, SLOTS, PROMPT + GEN, flavor="auto", machines=ORDER)}
    tri = [rows[m]["delta_bytes"] for m in ORDER]
    ok = tri[0] <= tri[1] <= tri[2]
    line = ("fig11,priced_copy_cost,0,"
            + ";".join(f"{m}={rows[m]['delta_bytes']:.0f}"
                       f"({rows[m]['wa_mode']})" for m in ORDER)
            + f";grace_le_spr_le_zen4={'OK' if ok else 'VIOLATED'}"
            + ";port_pays=0(cache written in place in both modes)")
    if not ok:
        raise AssertionError(f"overlap copy-cost WA order violated: {tri}")
    return [line]


def plandb_lines(cfg) -> list:
    """Section 3: sweep -> install -> every machine's plan a DB hit with
    zero online plans, equal to the online plan."""
    from repro_torch.core.machine import registered_names
    from repro_torch.serve import plandb
    from repro_torch.serve.planner import (plan_chunk_size, plan_stats,
                                           reset_plan_stats)
    t0 = time.perf_counter()
    db = plandb.sweep(cfg, batches=(SLOTS,), max_lens=(PROMPT + GEN,),
                      tps=(1,))
    sweep_s = time.perf_counter() - t0
    machines = registered_names()
    prev = plandb.installed()
    try:
        plandb.install(None)
        ref = {m: plan_chunk_size(cfg, SLOTS, PROMPT + GEN, machine=m)
               for m in machines}
        plandb.install(db)
        reset_plan_stats()
        t0 = time.perf_counter()
        hits = {m: plan_chunk_size(cfg, SLOTS, PROMPT + GEN, machine=m)
                for m in machines}
        lookup_s = time.perf_counter() - t0
        stats = plan_stats()
    finally:
        plandb.install(prev)
    if stats["online_plans"] != 0:
        raise AssertionError(f"plan DB hit still planned online: {stats}")
    if stats["db_hits"] != len(machines):
        raise AssertionError(f"missed DB hits: {stats}")
    for m in machines:
        if hits[m] != ref[m]:
            raise AssertionError(f"{m}: DB plan differs from online plan")
    dis = plandb.backend_disagreements(db)
    return [
        f"fig11,plandb,{lookup_s*1e6:.0f},"
        f"entries={len(db)};machines={len(machines)};"
        f"sweep_ms={sweep_s*1e3:.0f};lookup_us={lookup_s*1e6:.0f};"
        f"online_plans={stats['online_plans']};db_hits={stats['db_hits']};"
        f"bit_identical=OK;backend_disagreements={len(dis)}"]


def main(quick: bool = False, device="cuda") -> list:
    """Emit the fig11 overlap table as benchmark CSV lines."""
    if on_card(device):
        repeats = 9 if quick else 15
    else:
        repeats = 2          # on the host only the streams are gated
    lines = overlap_lines(device, repeats)
    cfg = get_smoke_config(ARCH)
    lines.extend(priced_lines(cfg))
    lines.extend(plandb_lines(cfg))
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
