"""Fig. 9: traffic-scale serving — the replica router under seeded
arrival traces, measured tail latency and tokens/s/chip against the
planner, on the port.

The counterpart of ``benchmarks/fig9_load.py``. A closed-loop generator
replays a *seeded* arrival trace (Poisson or bursty, mixed prompt and
generation lengths) against a :class:`ReplicaRouter` over N engine
replicas, under each admission policy. Arrivals are indexed in router
rounds, deterministic under a seed, while latencies are measured on the
wall clock (each round ends in the engines' token readback, so a
round's device work is inside it): a request's latency spans from the
round it became due (queue wait and backpressure deferrals included) to
the round it retired.

The port has no device mesh yet (ROADMAP queue 1 item 7), so every
replica takes the single-device path (``tp = 1``): N replicas on one
card, one chip. They share one copy of the weights and each owns its
cache. The router steps them in turn on one CUDA stream, so the decode
kernels' per-device split counters (``kernels/attention/decode.py``,
``split_counters``) and the stream suite's scratch are never used by two
dispatches at once; two replicas in flight on two streams are the
pipelined-dispatch slice's problem (ROADMAP queue 1 item 6).

Reported per trace and policy: p50/p95/p99 latency, measured tokens/s a
chip, and the planner's predicted tokens/s a chip on the plan machine.
Gated: percentile ordering, token conservation across the router, and
the sharded pricing invariants (pure pricing, ``_sharding_gates``). On
the CPU the cell is the reference's (smoke gemma3-4b, 2 slots a
replica); on the card gemma3-4b at its published width and depth with
8 slots a replica.
"""

from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.bench._common import model, on_card, where
from repro_torch.serve import QueueFull, ReplicaRouter, Request, ServeEngine
from repro_torch.serve.kv_traffic import collective_traffic, kv_row_bytes
from repro_torch.serve.planner import plan_chunk_size

ARCH = "gemma3-4b"           # local+global attention: both cache kinds
SLOTS, MAX_LEN = 2, 48
CARD_SLOTS = 8
REPLICAS = 2
CHUNK = 2
POLICIES = ("round_robin", "least_loaded")


def make_trace(kind: str, n: int, seed: int, *, mean_gap_rounds: float = 1.5,
               burst: int = 4) -> list:
    """Seeded arrival trace: (arrive_round, prompt_len, gen_len) tuples.

    ``poisson`` draws exponential inter-arrival gaps (in router rounds);
    ``bursty`` releases ``burst`` back-to-back arrivals per gap —
    identical offered load, maximally different short-term queue
    pressure.
    Prompt and gen lengths are mixed per request (short/long prompts,
    1..12 token budgets) from the same seeded stream.
    """
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        gaps = rng.exponential(mean_gap_rounds, size=n)
        times = np.floor(np.cumsum(gaps)).astype(int)
    elif kind == "bursty":
        n_bursts = -(-n // burst)
        starts = np.floor(np.cumsum(
            rng.exponential(mean_gap_rounds * burst, size=n_bursts))
        ).astype(int)
        times = np.repeat(starts, burst)[:n]
    else:
        raise ValueError(f"unknown trace kind {kind!r}")
    out = []
    for t in times:
        plen = int(rng.choice([6, 10, 16]))
        glen = int(rng.integers(1, 13))
        out.append((int(t), plen, glen))
    return out


def _percentiles(xs: list) -> dict:
    v = np.asarray(sorted(xs), float)
    return {p: float(np.percentile(v, p)) for p in (50, 95, 99)}


def trace_requests(trace: list, vocab: int, seed: int) -> list:
    """The trace's (arrive_round, Request) pairs, prompts from ``seed``."""
    rng = np.random.default_rng(seed + 1)
    return [(t, Request(rid=f"t{i}",
                        prompt=tuple(int(x) for x in
                                     rng.integers(0, vocab, plen)),
                        max_new_tokens=glen))
            for i, (t, plen, glen) in enumerate(trace)]


def run_trace(router: ReplicaRouter, trace: list, vocab: int,
              seed: int) -> dict:
    """Drive one trace through the router on a round-indexed clock."""
    due = trace_requests(trace, vocab, seed)
    budgets = {r.rid: r.max_new_tokens for _, r in due}
    due.sort(key=lambda p: p[0])
    arrive_wall: dict = {}
    latencies, served_tokens = [], 0
    rnd, i = 0, 0
    t0 = time.perf_counter()
    deferred: list = []
    while i < len(due) or deferred or router.busy():
        now = time.perf_counter() - t0
        todo, deferred = deferred, []
        while i < len(due) and due[i][0] <= rnd:
            todo.append(due[i][1])
            i += 1
        for req in todo:
            arrive_wall.setdefault(req.rid, now)
            try:
                router.submit(req)
            except QueueFull:
                deferred.append(req)     # closed loop: retry next round
        for rid, toks in router.step():
            done = time.perf_counter() - t0
            latencies.append(done - arrive_wall[rid])
            if len(toks) != budgets[rid]:
                raise AssertionError(
                    f"{rid}: served {len(toks)} of {budgets[rid]} tokens")
            served_tokens += len(toks)
        rnd += 1
    wall = time.perf_counter() - t0
    if len(latencies) != len(trace):
        raise AssertionError("router lost requests")
    return {"wall_s": wall, "served_tokens": served_tokens,
            "rounds": rnd, "latency_s": _percentiles(latencies)}


def build_engines(cfg, params, *, slots: int, device) -> list:
    """``REPLICAS`` engines over one copy of ``params`` (single-device
    path, ``tp = 1``), each owning its cache."""
    return [ServeEngine(cfg, params, max_slots=slots, max_len=MAX_LEN,
                        chunk=CHUNK, device=device)
            for _ in range(REPLICAS)]


def _sharding_gates(cfg) -> list:
    """Pricing invariants the sharded planner must keep (CSV lines)."""
    lines = []
    # per-shard KV stream: strictly 1/tp of the unsharded row bytes
    row = kv_row_bytes(cfg, SLOTS)
    for tp in (2, 4):
        if not row / tp < row:
            raise AssertionError("per-shard KV stream must shrink with TP")
    # collective store traffic: WA residues keep the machine ordering
    rows = {r["machine"]: r for r in collective_traffic(cfg, SLOTS, 2)}
    triple = [rows[m]["coll_bytes"]
              for m in ("neoverse_v2", "golden_cove", "zen4")]
    ok = triple[0] <= triple[1] <= triple[2]
    lines.append(
        "fig9,collective_ordering,0,"
        f"grace={triple[0]:.0f};spr={triple[1]:.0f};zen4={triple[2]:.0f};"
        f"grace_le_spr_le_zen4={'OK' if ok else 'VIOLATED'}")
    if not ok:
        raise AssertionError(
            f"collective WA ordering violated: {triple}")
    return lines


def load_lines(cfg, engines: list, *, n_req: int, device) -> list:
    """Every trace kind under every policy through one fleet of
    ``engines`` (every trace drains them, so each starts empty); each
    line gated on percentile order and conservation (``run_trace``)."""
    chips = 1                            # tp = 1, every replica on one card
    slots = engines[0].max_slots
    # planner prediction for the plan machine: slots tokens per step,
    # every replica decoding in turn on the one card
    plan = plan_chunk_size(cfg, slots, MAX_LEN)
    pred_tok_s_chip = slots / max(plan.t_step_seconds, 1e-12) / chips
    lines = []
    for policy in POLICIES:
        for kind in ("poisson", "bursty"):
            router = ReplicaRouter(engines, policy=policy,
                                   max_queue=slots * 2)
            trace = make_trace(kind, n_req, seed=42)
            rec = run_trace(router, trace, cfg.vocab_size, seed=42)
            lat = rec["latency_s"]
            if not lat[50] <= lat[95] <= lat[99]:
                raise AssertionError("percentile ordering")
            tok_s_chip = rec["served_tokens"] / max(rec["wall_s"], 1e-9) \
                / chips
            ratio = tok_s_chip / pred_tok_s_chip
            if not (math.isfinite(ratio) and ratio > 0):
                raise AssertionError("degenerate ratio")
            st = router.stats()
            lines.append(
                f"fig9,load.{policy}.{kind},{rec['wall_s']*1e6:.0f},"
                f"n={n_req};replicas={REPLICAS};slots={slots};tp=1;"
                f"chips={chips};p50_ms={lat[50]*1e3:.1f};"
                f"p95_ms={lat[95]*1e3:.1f};p99_ms={lat[99]*1e3:.1f};"
                f"rounds={rec['rounds']};tokens={rec['served_tokens']};"
                f"tok_s_chip={tok_s_chip:.1f};"
                f"pred_tok_s_chip={pred_tok_s_chip:.0f};"
                f"pred_machine={plan.machine};ratio={ratio:.2e};"
                f"conserved=OK;device={where(device)};"
                + ";".join(f"r{s['replica']}={s['completed']}/"
                           f"{s['submitted']}" for s in st))
    return lines


def main(quick: bool = False, device="cuda") -> list:
    """Emit the fig9 load table as benchmark CSV lines."""
    cfg, params = model(ARCH, device)
    slots = CARD_SLOTS if on_card(device) else SLOTS
    n_req = 8 if quick and not on_card(device) else 16 if quick else 24
    engines = build_engines(cfg, params, slots=slots, device=device)
    lines = load_lines(cfg, engines, n_req=n_req, device=device)
    lines.extend(_sharding_gates(cfg))
    return lines


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="short traces")
    args = ap.parse_args()
    print("\n".join(main(quick=args.smoke)))
