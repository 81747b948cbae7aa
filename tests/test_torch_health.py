"""The port's health layer (``repro_torch.serve.health``) against the JAX
package's: the state machine, deadlines, priced degradation, and the
fault-tolerant router's rescue, deadline and degradation paths.

The mechanics run on a slot-surface stub whose k-th token *is* its
position, so a rescued replay continues the stream exactly; then fleets
of real engines (smoke configs in fp32, the same weights bridged through
numpy) run the same seeded fault schedules on both sides, with explicit
per-round budgets and equal ``ChunkPlan`` fields (the port's planner
prices an ATen trace, the JAX planner HLO, so their own plans differ;
equal plans test the router, not the lowering). Retired streams, the
event log, sheds, counters and the virtual-clock p99 must be equal.
Virtual clocks only: no wall-clock assert.
"""

import numpy as np
import pytest
import torch

import repro.serve as JS
import repro_torch.serve as TS
from repro.serve.planner import ChunkPlan as JChunkPlan
from repro_torch.configs import get_smoke_config
from repro_torch.serve.planner import ChunkPlan

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)

BUDGET = 1e-3


class VirtualEngine:
    """Slot engine without a model whose k-th emitted token *is* its
    position, so replaying prompt + prefix continues a stream exactly."""

    paged = False

    def __init__(self, n_slots=2, budget_s=BUDGET):
        self.slots = [None] * n_slots
        self.max_slots = n_slots
        self.budget_s = budget_s
        self.last_step_seconds = budget_s
        self.chunk = 1
        # rescue pricing reads the model geometry and horizon
        self.cfg = get_smoke_config("xlstm-125m")
        self.max_len = 64

    def free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def admit(self, req, slot=None):
        slot = self.free_slots()[0] if slot is None else slot

        class _S:
            pass

        s = _S()
        s.rid, s.remaining, s.out = req.rid, req.max_new_tokens, []
        s.pos = len(req.prompt)
        self.slots[slot] = s
        return slot

    def step(self):
        retired = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.out.append(s.pos)
            s.pos += 1
            s.remaining -= 1
            if s.remaining <= 0:
                retired.append((s.rid, np.asarray(s.out, np.int32)))
                self.slots[i] = None
        return retired

    def cancel(self, rid):
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                self.slots[i] = None
                return np.asarray(s.out, np.int32)
        return None


def _plans(chunk=4, t=1e-3):
    """Equal JAX and port ChunkPlans."""
    kw = dict(chunk=chunk, machine="neoverse_v2", t_step_seconds=t,
              per_machine={"neoverse_v2": t})
    return JChunkPlan(**kw), ChunkPlan(**kw)


# --- the state machine -----------------------------------------------------

OPS = [("strike", 1), ("success", 2), ("strike", 3), ("strike", 4),
       ("strike", 5), ("tick", 6), ("tick", 7), ("success", 8),
       ("strike", 9), ("tick", 10), ("tick", 11), ("success", 12),
       ("success", 13), ("strike", 14), ("success", 15)]


@pytest.mark.parametrize("cfg", [
    dict(fail_threshold=2, eject_threshold=3, cooldown_rounds=2,
         probe_successes=2),
    dict(fail_threshold=1, eject_threshold=9),
    dict()])
def test_state_machine_walks_as_jax(cfg):
    hj = JS.ReplicaHealth(JS.HealthConfig(**cfg))
    ht = TS.ReplicaHealth(TS.HealthConfig(**cfg))
    for op, rnd in OPS:
        rj, rt = getattr(hj, op)(rnd), getattr(ht, op)(rnd)
        assert rt == rj
        assert (ht.state, ht.strikes, ht.successes, ht.cooldown,
                ht.admissible(), ht.steppable()) == \
            (hj.state, hj.strikes, hj.successes, hj.cooldown,
             hj.admissible(), hj.steppable())
    assert ht.transitions == hj.transitions


# --- deadlines and priced degradation ---------------------------------------

@pytest.mark.parametrize("chunk,t", [(4, 1e-3), (1, 2.5e-4), (32, 7e-6)])
def test_deadline_for_equals_jax(chunk, t):
    pj, pt = _plans(chunk, t)
    for gen in (1, 7, 16, 33):
        for kw in ({}, {"chunk": 2, "slack": 2.0},
                   {"queue_rounds": 3, "dispatch_overhead_s": 1e-4}):
            want = JS.deadline_for(pj, gen, **kw)
            assert TS.deadline_for(pt, gen, **kw) == \
                pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("chunk,t", [(4, 1e-3), (1, 2.5e-4), (9, 7e-6)])
def test_priced_degradation_equals_jax(chunk, t):
    pj, pt = _plans(chunk, t)
    seen = set()
    for up in (1, 2):
        for backlog in (0, 5, 16, 300):
            for dl in (None, 1e-5, chunk * t * 0.75 + 2e-4, 3e-3, 1.0):
                want = JS.priced_degradation(pj, chunk, 2, up, backlog,
                                             deadline_s=dl)
                got = TS.priced_degradation(pt, chunk, 2, up, backlog,
                                            deadline_s=dl)
                assert got["choice"] == want["choice"]
                assert got["chunk"] == want["chunk"]
                assert set(got["options"]) == set(want["options"])
                for name, o in want["options"].items():
                    for k, v in o.items():
                        assert got["options"][name][k] == \
                            pytest.approx(v, rel=1e-12, abs=0.0)
                seen.add(got["choice"])
    assert seen == ({"keep", "shed"} if chunk == 1
                    else {"keep", "replan", "shed"})


# --- the fault-tolerant router on the stub -----------------------------------

def _virtual_scenario(S, scenario):
    """One scenario on side ``S`` over virtual engines; returns what it
    observed."""
    def req(rid, budget=4, plen=3, deadline_s=None):
        return S.Request(rid, tuple(range(1, 1 + plen)), budget,
                         deadline_s=deadline_s)

    done = {}
    if scenario == "deadline":
        rt = S.FaultTolerantRouter([VirtualEngine()], max_queue=4)
        rt.submit(req("slow", 10, deadline_s=3.5 * BUDGET))
        rt.submit(req("slow2", 10, deadline_s=3.5 * BUDGET))
        rt.submit(req("late", 2, deadline_s=0.5 * BUDGET))
        for _ in range(12):
            done.update(dict(rt.step()))
    else:
        cfg = S.HealthConfig(fail_threshold=2, eject_threshold=3,
                             latency_factor=10.0, cooldown_rounds=50)
        e0 = S.FaultyEngine(VirtualEngine(),
                            [S.FaultSpec("stuck", frozenset(range(1, 60)))],
                            budget_s=BUDGET)
        e1 = S.FaultyEngine(VirtualEngine(), [], budget_s=BUDGET)
        rt = S.FaultTolerantRouter([e0, e1], policy="round_robin",
                                   max_queue=8, health=cfg)
        rt.submit(req("a", 6, 3))
        rt.submit(req("b", 6, 5))
        for _ in range(40):
            done.update(dict(rt.step()))
            if len(done) == 2:
                break
    rescue = [{k: (v if k != "rows" else
                   [r for r in v if r["machine"] != "h100"])
               for k, v in r.items()} for r in rt.rescue_log]
    return ({r: t.tolist() for r, t in done.items()}, rt.drain_events(),
            rt.stats(), rt.now_s, rt.deadline_shed, rt.deadline_cancelled,
            rt.rescued, rescue, [h.transitions for h in rt.health])


@pytest.mark.parametrize("scenario", ["deadline", "eject"])
def test_router_scenarios_equal_jax(scenario):
    want = _virtual_scenario(JS, scenario)
    got = _virtual_scenario(TS, scenario)
    assert got == want
    if scenario == "eject":
        assert got[0]["a"] == list(range(3, 9))   # continued exactly
        assert got[6] == 1 and got[7][0]["rows"]


def test_no_admissible_replica_raises_queue_full_subclass():
    rt = TS.FaultTolerantRouter([VirtualEngine(), VirtualEngine()])
    for h in rt.health:
        h.state = "ejected"
    with pytest.raises(TS.NoHealthyReplica) as e:
        rt.submit(TS.Request("a", (1, 2), 2))
    assert isinstance(e.value, TS.QueueFull)


def test_replan_lands_through_set_chunk():
    """A pool exhaustion with less than a round of deadline left re-plans
    the replica's chunk through ``set_chunk`` (a stub records it)."""
    class Replannable(VirtualEngine):
        def __init__(self):
            super().__init__()
            _, self.plan = _plans(chunk=4, t=1e-3)
            self.chunk = 4
            self.chunks = []

        def set_chunk(self, chunk):
            self.chunks.append(chunk)

    inner = Replannable()
    eng = TS.FaultyEngine(
        inner, [TS.FaultSpec("pool_exhausted", frozenset({0}))],
        budget_s=BUDGET)
    rt = TS.FaultTolerantRouter([eng])
    # keep's round is 4.2 ms, replan's 2.2 ms: 3 ms left picks replan
    rt.submit(TS.Request("a", (1, 2), 3, deadline_s=3e-3))
    rt.step()
    assert [d["choice"] for d in rt.degrade_log] == ["replan"]
    assert inner.chunks == [2]


# --- fleets of real engines under seeded chaos -------------------------------

RATES = {"step_error": 0.06, "stuck": 0.08, "slow": 0.05,
         "nonfinite": 0.08, "admit_error": 0.08, "pool_exhausted": 0.1}
SLOTS, MAX_LEN, CHUNK = 2, 48, 2


@pytest.fixture(scope="module")
def fleets():
    """Two long-lived engines per side and layout (every run drains
    them): xlstm-125m dense and yi-9b paged, fp32 smoke configs."""
    out = {}
    for arch, layout in (("xlstm-125m", "dense"), ("yi-9b", "paged")):
        cj, ct = cfg_pair("float32", arch)
        pj, pt = bridged_params(cj, ct)
        kw = dict(max_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK, seed=0)
        if layout == "paged":
            mk_j = lambda: JS.PagedServeEngine(cj, pj, page_size=4, **kw)
            mk_t = lambda: TS.PagedServeEngine(ct, pt, page_size=4,
                                               device="cpu", **kw)
        else:
            mk_j = lambda: JS.ServeEngine(cj, pj, **kw)
            mk_t = lambda: TS.ServeEngine(ct, pt, device="cpu", **kw)
        plan_j, plan_t = _plans(chunk=CHUNK, t=4e-4)
        out[layout] = {"jax": [mk_j() for _ in range(2)],
                       "port": [mk_t() for _ in range(2)],
                       "plans": {"jax": plan_j, "port": plan_t}}
    return out


def _requests(S, plan, n=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen, gen = int(rng.integers(3, 9)), int(rng.integers(2, 9))
        out.append((int(rng.integers(0, 6)), S.Request(
            f"c{i}", tuple(int(t) for t in rng.integers(0, 512, plen)),
            gen, deadline_s=S.deadline_for(plan, gen, slack=6.0))))
    return sorted(out, key=lambda p: p[0])


def _chaos_fleet(S, engines, plan, seed):
    """A chaos run on side ``S``: every engine wrapped with a seeded
    schedule and an explicit budget, the plan set equal on both sides;
    arrivals by round, latencies on the virtual clock."""
    wrapped = []
    for k, eng in enumerate(engines):
        eng.plan = plan
        eng.set_chunk(CHUNK)
        wrapped.append(S.FaultyEngine(
            eng, S.chaos_schedule(seed + k, 24, RATES, slots=SLOTS),
            budget_s=BUDGET))
    rt = S.FaultTolerantRouter(
        wrapped, policy="least_loaded", max_queue=4,
        health=S.HealthConfig(fail_threshold=2, eject_threshold=3,
                              cooldown_rounds=2))
    due = _requests(S, plan, seed=seed)
    arrive, lat, results = {}, {}, {}
    rnd, i, deferred = 0, 0, []
    while i < len(due) or deferred or rt.busy():
        todo, deferred = deferred, []
        while i < len(due) and due[i][0] <= rnd:
            todo.append(due[i][1])
            i += 1
        for req in todo:
            arrive.setdefault(req.rid, rt.now_s)
            try:
                rt.submit(req)
            except S.QueueFull:
                deferred.append(req)
        for rid, toks in rt.step():
            results[rid] = np.asarray(toks).tolist()
            lat[rid] = rt.now_s - arrive[rid]
        rnd += 1
        assert rnd < 400, "chaos run did not drain"
    stats = [{k: v for k, v in r.items() if k != "mean_dispatch_gap_s"}
             for r in rt.stats()]
    p99 = float(np.percentile(sorted(lat.values()), 99)) if lat else None
    return {"results": results, "events": rt.drain_events(),
            "shed": rt.shed_rids, "stats": stats, "now_s": rt.now_s,
            "p99": p99, "quarantined": rt.quarantined,
            "decisions": [(d["trigger"], d["choice"], d["chunk"])
                          for d in rt.degrade_log],
            "injected": [dict(e.injected) for e in wrapped],
            "chunks": [e.chunk for e in engines]}


@pytest.mark.parametrize("layout,seed", [
    ("dense", 1), ("dense", 4), ("dense", 9), ("paged", 2)])
def test_chaos_fleet_equals_jax(fleets, layout, seed):
    f = fleets[layout]
    want = _chaos_fleet(JS, f["jax"], f["plans"]["jax"], seed)
    got = _chaos_fleet(TS, f["port"], f["plans"]["port"], seed)
    for key in ("results", "events", "shed", "stats", "quarantined",
                "decisions", "injected", "chunks"):
        assert got[key] == want[key], key
    assert got["now_s"] == pytest.approx(want["now_s"], rel=1e-12)
    assert got["p99"] == pytest.approx(want["p99"], rel=1e-12)
    assert got["quarantined"] == []              # rescued, never parked
    assert any(got["injected"])                  # the schedule fired
    for eng in f["port"]:
        assert all(s is None for s in eng.slots)
        if eng.paged:
            eng.check_pool()
