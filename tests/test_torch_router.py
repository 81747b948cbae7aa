"""The port's replica router (``repro_torch.serve.router``) against the
JAX package's.

Both routers drive the same slot-surface stub (the router never looks
past ``slots``/``admit``/``step``/``cancel``/``fork``), so policies,
queues, backpressure, cancel and fork forwarding, retries, sheds and the
stall guard are held call for call; then two port engines and two JAX
engines on the same smoke weights (fp32) serve one request list through
``run`` with the same retired streams and counters.
"""

import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServe
from repro.serve.router import QueueFull as JQueueFull
from repro.serve.router import ReplicaRouter as JRouter
from repro_torch.serve import (QueueFull, ReplicaRouter, Request,
                               ServeEngine)

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)


class _Slot:
    def __init__(self, rid, budget):
        self.rid, self.remaining, self.out = rid, budget, []


class FakeEngine:
    """Slot-surface stub: each step every active slot emits its slot
    index; ``wedged`` admits but never progresses."""

    paged = True          # so fork() is allowed on the stub

    def __init__(self, n_slots=2, wedged=False):
        self.slots = [None] * n_slots
        self.wedged = wedged

    def free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    def admit(self, req, slot=None):
        slot = self.free_slots()[0] if slot is None else slot
        self.slots[slot] = _Slot(req.rid, req.max_new_tokens)
        return slot

    def step(self):
        retired = []
        if self.wedged:
            return retired
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.out.append(i)
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

    def fork(self, rid, new_rid, max_new_tokens=None):
        src = next(s for s in self.slots if s is not None and s.rid == rid)
        slot = self.free_slots()[0]
        self.slots[slot] = _Slot(new_rid, src.remaining
                                 if max_new_tokens is None
                                 else max_new_tokens)
        return slot


SIDES = {"jax": (JRouter, JRequest, JQueueFull),
         "port": (ReplicaRouter, Request, QueueFull)}


def _drive(side, policy, script, n=3, **kw):
    """Run ``script`` (a list of ops) on one side's router over fresh
    stubs; returns everything observable, in order."""
    Router, Req, Full = SIDES[side]
    rt = Router([FakeEngine() for _ in range(n)], policy=policy, **kw)
    log = []
    for op, *args in script:
        if op == "submit":
            rid, budget = args
            try:
                log.append(("submit", rid, rt.submit(Req(rid, (1, 2, 3),
                                                         budget))))
            except Full as e:
                log.append(("full", rid, e.replica))
        elif op == "step":
            log.append(("step", [(r, t.tolist()) for r, t in rt.step()]))
        elif op == "cancel":
            out = rt.cancel(args[0])
            log.append(("cancel", None if out is None else out.tolist()))
        elif op == "fork":
            log.append(("fork", rt.fork(*args)))
    log.append(("stats", rt.stats(), [list(q) and [r.rid for r in q]
                                      for q in rt.queues]))
    return log


SCRIPT = ([("submit", f"r{i}", 1 + i % 4) for i in range(10)]
          + [("step",), ("step",), ("cancel", "r9"), ("cancel", "r1"),
             ("fork", "r3", "r3f"), ("step",)]
          + [("submit", f"s{i}", 2) for i in range(6)]
          + [("step",)] * 6)


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_router_mechanics_equal_jax(policy):
    """Placement, backpressure (QueueFull and its replica), cancel of a
    queued and an active request, fork onto the owner, per-replica
    counters and queues: call for call as JAX's router."""
    want = _drive("jax", policy, SCRIPT, max_queue=2)
    got = _drive("port", policy, SCRIPT, max_queue=2)
    assert got == want
    assert any(e[0] == "full" for e in got)


def test_duplicate_rid_and_bad_arguments_rejected():
    rt = ReplicaRouter([FakeEngine()])
    rt.submit(Request("a", (1,), 2))
    with pytest.raises(ValueError):
        rt.submit(Request("a", (1,), 2))
    with pytest.raises(ValueError):
        ReplicaRouter([])
    with pytest.raises(ValueError):
        ReplicaRouter([FakeEngine()], policy="random")
    with pytest.raises(KeyError):
        rt.fork("nope", "x")


@pytest.mark.parametrize("side", ["jax", "port"])
def test_run_sheds_after_retries_and_stops_when_wedged(side):
    Router, Req, _ = SIDES[side]
    rt = Router([FakeEngine(n_slots=1, wedged=True)], max_queue=1)
    with pytest.raises(RuntimeError, match="no progress"):
        rt.run([Req(f"r{i}", (1,), 2) for i in range(4)], max_retries=2,
               stall_rounds=16)
    st = rt.stats()
    assert sum(s["shed"] for s in st) == len(rt.shed_rids) >= 1
    assert sum(s["retries"] for s in st) >= 1
    assert "r0" not in rt.shed_rids


def test_run_sheds_and_retries_as_jax():
    def go(side):
        Router, Req, _ = SIDES[side]
        rt = Router([FakeEngine(n_slots=1), FakeEngine(n_slots=1)],
                    policy="least_loaded", max_queue=1)
        out = rt.run([Req(f"r{i}", (1,), 1 + i % 3) for i in range(12)],
                     max_retries=1, seed=3)
        return ({r: t.tolist() for r, t in out.items()}, rt.shed_rids,
                rt.stats())
    assert go("port") == go("jax")


@pytest.fixture(scope="module")
def models():
    cj, ct = cfg_pair("float32")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _no_gap(rows):
    """``stats()`` rows without the JAX engine's measured dispatch gap
    (a host wall time)."""
    return [{k: v for k, v in r.items() if k != "mean_dispatch_gap_s"}
            for r in rows]


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_router_over_engines_streams_as_jax(models, policy):
    """Two replicas each side, mixed prompts and budgets, backpressure
    retried through ``run``: identical streams and counters."""
    cj, ct, pj, pt = models
    rng = np.random.default_rng(1)
    specs = [(f"q{i}", tuple(int(t) for t in rng.integers(0, 512, n)), m)
             for i, (n, m) in enumerate([(5, 4), (8, 6), (3, 1), (6, 5),
                                         (9, 3), (4, 7), (7, 2)])]
    kw = dict(max_slots=2, max_len=24, chunk=2)
    jr = JRouter([JServe(cj, pj, **kw) for _ in range(2)], policy=policy,
                 max_queue=1)
    tr = ReplicaRouter([ServeEngine(ct, pt, device="cpu", **kw)
                        for _ in range(2)], policy=policy, max_queue=1)
    want = jr.run([JRequest(*s) for s in specs])
    got = tr.run([Request(*s) for s in specs])
    assert {r: t.tolist() for r, t in got.items()} == \
        {r: t.tolist() for r, t in want.items()}
    assert len(got) == len(specs) and tr.shed_rids == jr.shed_rids == []
    assert _no_gap(tr.stats()) == _no_gap(jr.stats())
    assert all(r["mean_dispatch_gap_s"] == 0.0 and r["pipeline"] == 0
               for r in tr.stats())
