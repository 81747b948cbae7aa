"""Fig. 10: chaos serving — fault-injected traces through the
fault-tolerant router, with rescue, conservation and degradation gates,
on the port.

The counterpart of ``benchmarks/fig10_chaos.py``. The fig9 arrival
traces (seeded Poisson and bursty) are replayed through identical
replica fleets on the virtual clock: once fault-free (the baseline) and
then with injected faults: a wedged replica that must be detected,
ejected and its in-flight requests rescued; a NaN-poisoned decode the
chunk's ``ok`` guard must quarantine (on the card the poison lands in
the recurrent state a CUDA graph replays over); a transient admission
error, and a saturated page pool the admission path must absorb through
a priced keep/replan/shed decision. Three properties are *gated*:

- **No silent loss**: every submitted request is accounted for,
  completed + shed + deadline-shed + deadline-cancelled == submitted.
- **Rescue identity**: every completed stream, every rescued one
  included, is byte-identical to the fault-free baseline (greedy
  decoding: replaying prompt + tokens so far reproduces the stream).
- **Budgeted degradation**: chaos p99 stays within the planner-derived
  budget for a 1-of-N replica outage, and every degraded-mode decision
  carries its priced comparison (``fig10,degrade`` lines).

Each run starts from the plan's chunk (``set_chunk``), on engines reused
across runs: every run drains them.

All latencies are virtual-clock seconds (the router advances ``now_s``
by the slowest stepped replica's reported round seconds), so the gates
are deterministic. On the CPU the cell is the reference's (smoke
xlstm-125m, 2 slots, planned on ``neoverse_v2``); on the card
xlstm-125m at its published width and depth in fp32, 8 slots a replica,
planned on ``h100``.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.bench._common import model, on_card
from repro_torch.bench.fig9_load import make_trace
from repro_torch.serve import (FaultSpec, FaultTolerantRouter, FaultyEngine,
                               HealthConfig, QueueFull, Request, ServeEngine,
                               deadline_for)
from repro_torch.serve.planner import planned_round_seconds

ARCH = "xlstm-125m"
SLOTS, MAX_LEN = 2, 64
CARD_SLOTS = 8
REPLICAS = 2
SEED = 7
# generous completion deadlines: the outage inflates every in-flight
# latency by the detection window, and fig10 gates rescue identity
DEADLINE_SLACK = 2000.0


def build_engines(cfg, params, *, slots: int, machine: str,
                  device) -> list:
    """The fleet's planned dense replicas (one copy of ``params``)."""
    return [ServeEngine(cfg, params, max_slots=slots, max_len=MAX_LEN,
                        machine=machine, device=device)
            for _ in range(REPLICAS)]


def build_fleet(engines: list, faults_per_replica) -> FaultTolerantRouter:
    """FT router over ``FaultyEngine``-wrapped ``engines``, each back at
    its plan's chunk."""
    wrapped = []
    for eng, fl in zip(engines, faults_per_replica):
        eng.set_chunk(eng.plan.chunk)
        wrapped.append(FaultyEngine(eng, fl))
    slots = engines[0].max_slots
    return FaultTolerantRouter(wrapped, policy="least_loaded",
                               max_queue=slots * 4, health=HealthConfig())


def trace_requests(trace, vocab: int, seed: int, plan) -> list:
    """(arrive_round, Request) pairs with planner-derived deadlines."""
    rng = np.random.default_rng(seed + 1)
    return [(t, Request(
        rid=f"t{i}",
        prompt=tuple(int(x) for x in rng.integers(0, vocab, plen)),
        max_new_tokens=glen,
        deadline_s=deadline_for(plan, glen, slack=DEADLINE_SLACK)))
        for i, (t, plen, glen) in enumerate(trace)]


def run_trace(router, due: list) -> dict:
    """Drive one arrival trace on the virtual clock; latencies in now_s."""
    due = sorted(due, key=lambda p: p[0])
    arrive_v: dict = {}
    results: dict = {}
    latencies: dict = {}
    rnd, i = 0, 0
    deferred: list = []
    while i < len(due) or deferred or router.busy():
        todo, deferred = deferred, []
        while i < len(due) and due[i][0] <= rnd:
            todo.append(due[i][1])
            i += 1
        for req in todo:
            arrive_v.setdefault(req.rid, router.now_s)
            try:
                router.submit(req)
            except QueueFull:
                deferred.append(req)     # closed loop: retry next round
        for rid, toks in router.step():
            results[rid] = np.asarray(toks)
            latencies[rid] = router.now_s - arrive_v[rid]
        rnd += 1
    return {"results": results, "latencies": latencies, "rounds": rnd,
            "events": router.drain_events()}


def _p99(latencies: dict) -> float:
    return float(np.percentile(sorted(latencies.values()), 99))


def _conservation(rec, router, n_req: int) -> None:
    """Gate (a): every submitted request is accounted for, exactly once."""
    completed = set(rec["results"])
    shed = set(router.shed_rids)
    deadline = {e["rid"] for e in rec["events"]
                if e["kind"] in ("deadline_shed", "deadline_cancel")}
    if router.quarantined:
        raise AssertionError(
            "FT router must rescue quarantined streams, not park them")
    if not completed.isdisjoint(shed):
        raise AssertionError("completed and shed overlap")
    missing = {f"t{i}" for i in range(n_req)} - (completed | shed | deadline)
    if missing:
        raise AssertionError(f"requests silently lost: {sorted(missing)}")
    if len(completed) + len(shed | deadline) != n_req:
        raise AssertionError("request accounting does not add up")


def chaos_faults(stuck_from: int) -> list:
    """Per-replica fault schedules for the 1-of-N outage scenario.

    Replica 0 wedges for a window long enough to strike through
    quarantine into ejection (rescue path), then recovers. Replica 1
    sees one NaN-poisoned decode (non-finite guard + rescue), one
    transient admission error, and one injected pool exhaustion
    (priced degradation decision).
    """
    return [
        [FaultSpec("stuck", frozenset(range(stuck_from, stuck_from + 8)))],
        [FaultSpec("nonfinite", frozenset({stuck_from + 1}), slot=0),
         FaultSpec("admit_error", frozenset({3})),
         FaultSpec("pool_exhausted", frozenset({5}))],
    ]


def chaos_record(engines: list, kind: str, n_req: int, vocab: int) -> dict:
    """The fault-free baseline and the chaos run of one trace kind on
    ``engines``."""
    plan = engines[0].plan
    trace = make_trace(kind, n_req, seed=SEED)
    due = trace_requests(trace, vocab, SEED, plan)
    base = run_trace(build_fleet(engines, [[] for _ in engines]), due)
    if len(base["results"]) != n_req:
        raise AssertionError("baseline lost requests")
    chaos_rt = build_fleet(engines, chaos_faults(stuck_from=4))
    rec = run_trace(chaos_rt, due)
    return {"trace": trace, "plan": plan, "base": base, "rec": rec,
            "router": chaos_rt}


def gate_lines(kind: str, n_req: int, out: dict) -> list:
    """Gates (a)-(c) on one chaos record, and its CSV lines."""
    base, rec, chaos_rt = out["base"], out["rec"], out["router"]
    plan, trace = out["plan"], out["trace"]
    _conservation(rec, chaos_rt, n_req)                         # gate (a)

    rescued = {e["rid"] for e in rec["events"]
               if e["kind"] == "rescued_complete"}
    if not rescued:
        raise AssertionError("chaos scenario must exercise the rescue path")
    mismatched = [rid for rid, toks in rec["results"].items()
                  if not np.array_equal(toks, base["results"][rid])]
    if mismatched:                                              # gate (b)
        raise AssertionError(
            f"streams diverged from fault-free baseline: {mismatched}")

    base_p99, chaos_p99 = _p99(base["latencies"]), _p99(rec["latencies"])
    hc = chaos_rt.health_cfg                                    # gate (c)
    round_s = planned_round_seconds(plan)
    detect_s = hc.eject_threshold * hc.latency_factor * round_s
    max_gen = max(g for _, _, g in trace)
    replay_s = (math.ceil(max_gen / plan.chunk) + hc.cooldown_rounds) \
        * round_s * REPLICAS / (REPLICAS - 1)
    budget_p99 = 1.5 * (base_p99 + detect_s + replay_s)
    if not chaos_p99 <= budget_p99:
        raise AssertionError(
            f"p99 degradation {chaos_p99:.4f}s exceeds planner budget "
            f"{budget_p99:.4f}s ({kind})")

    n_rescue = sum(e["kind"] == "rescue" for e in rec["events"])
    reasons = sorted({e["reason"] for e in rec["events"]
                      if e["kind"] == "rescue"})
    replans = [d for d in chaos_rt.degrade_log if d["choice"] == "replan"]
    lines = [
        f"fig10,chaos.{kind},{chaos_p99 * 1e6:.0f},"
        f"n={n_req};replicas={REPLICAS};chunk={plan.chunk};"
        f"plan={plan.machine};"
        f"base_p99_ms={base_p99 * 1e3:.2f};"
        f"chaos_p99_ms={chaos_p99 * 1e3:.2f};"
        f"budget_p99_ms={budget_p99 * 1e3:.2f};"
        f"rescues={n_rescue};rescue_reasons={'+'.join(reasons)};"
        f"rescued_done={len(rescued)};"
        f"shed={len(chaos_rt.shed_rids)};"
        f"deadline_shed={chaos_rt.deadline_shed};"
        f"deadline_cancelled={chaos_rt.deadline_cancelled};"
        f"replans={len(replans)};conserved=OK;"
        f"identical={'OK' if not mismatched else 'FAIL'}"]

    # every shed was a justified, priced decision, and every priced
    # decision is in the artifact
    shed_events = [e for e in rec["events"] if e["kind"] == "shed"]
    just = [d for d in chaos_rt.degrade_log if d["choice"] == "shed"]
    if len(shed_events) != len(just):
        raise AssertionError("unjustified shed: no priced comparison "
                             "recorded")
    if not chaos_rt.degrade_log:
        raise AssertionError("pool-exhaustion injection must leave a priced "
                             "decision")
    for d in chaos_rt.degrade_log:
        opts = ";".join(
            f"{name}_round_us={o['round_s'] * 1e6:.1f};"
            f"{name}_drain_us={o['drain_s'] * 1e6:.1f}"
            for name, o in sorted(d["options"].items()))
        lines.append(
            f"fig10,degrade.{kind},0,"
            f"trigger={d['trigger']};choice={d['choice']};"
            f"chunk={d['chunk']};backlog={d['backlog_tokens']};"
            f"up={d['replicas_up']};{opts}")
    states = ">".join(
        s for _, _, s in chaos_rt.health[0].transitions) or "healthy"
    lines.append(
        f"fig10,health.{kind},0,"
        f"replica0={states};"
        + ";".join(f"r{s['replica']}={s['health']}"
                   f"/f{s['failed']}" for s in chaos_rt.stats()))
    return lines


def main(quick: bool = False, device="cuda") -> list:
    """Emit the fig10 chaos table as gated benchmark CSV lines (fp32 on
    the card)."""
    card = on_card(device)
    cfg, params = model(ARCH, device, dtype="float32" if card else None)
    engines = build_engines(cfg, params, slots=CARD_SLOTS if card else SLOTS,
                            machine="h100" if card else "neoverse_v2",
                            device=device)
    n_req = 8 if quick else 16
    lines = []
    for kind in ("poisson", "bursty"):
        out = chaos_record(engines, kind, n_req, cfg.vocab_size)
        lines += gate_lines(kind, n_req, out)
    return lines


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="short traces")
    args = ap.parse_args()
    print("\n".join(main(quick=args.smoke)))
