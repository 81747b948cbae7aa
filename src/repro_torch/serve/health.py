"""Replica health, request rescue, and priced graceful degradation.

The counterpart of ``repro/serve/health.py``: plain host code on the
router's virtual clock, the same state machine, rescue, deadlines and
priced keep/replan/shed decisions.

The plain :class:`~repro_torch.serve.router.ReplicaRouter` treats replicas
as always-correct and always-on-time; the only failure signal is
``QueueFull``. This module adds the model-driven fault-tolerance
layer on top of it:

- :class:`ReplicaHealth` — a per-replica state machine scored on
  *consecutive failures* and *step latency vs. the planned budget*,
  where the budget is the port model's tier-resolved per-round
  seconds (:func:`repro_torch.serve.planner.planned_round_seconds`). "Slow"
  therefore always means slow *for this machine* — a Grace replica
  and a Genoa replica each get their own baseline, which is what the
  per-machine variability across the paper's three cores demands.

  ::

      healthy --strike x fail_threshold--> quarantined (drain)
      quarantined --success--> healthy          (re-admit)
      quarantined --strike x eject_threshold--> ejected (rescue)
      ejected --cooldown_rounds--> probing
      probing --probe_successes--> healthy
      probing --strike--> ejected               (re-eject)

- **Request rescue** — when a replica is ejected (or a stream is
  quarantined by the engines' non-finite guard), its in-flight
  requests are *not* lost: each is resubmitted to a healthy replica
  as a replay of ``prompt + tokens-so-far`` with the remaining token
  budget, and the completed stream is the emitted prefix plus the
  replayed continuation — byte-identical to the fault-free stream
  under greedy decoding. Every rescue is priced through
  :func:`repro_torch.serve.kv_traffic.rescue_traffic` (prefix sharing makes
  a paged rescue pay only the replayed rows' unshared pages).

- **Priced degradation** — under page-pool exhaustion or deadline
  pressure the router chooses between keeping the plan, re-planning a
  smaller chunk (``set_chunk``: lower per-round latency, more
  dispatch overhead), and shedding, via
  :func:`priced_degradation` — the same modeled-seconds comparison
  that picks chunk sizes and store flavors everywhere else in the
  repo. Every decision is logged with all its priced options so the
  fig10 chaos artifact can justify each one.

Everything runs on the router's virtual clock (``now_s`` advances by
the slowest stepped replica's reported seconds each round), so the
whole layer is deterministic under the fault injector
(``repro_torch.serve.faults``) and testable without wall-clock sleeps.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np

from repro_torch.serve.engine import Request
from repro_torch.serve.faults import TransientFault
from repro_torch.serve.kv_traffic import rescue_traffic
from repro_torch.serve.pages import PoolExhausted
from repro_torch.serve.planner import planned_round_seconds
from repro_torch.serve.router import QueueFull, ReplicaRouter

STATES = ("healthy", "quarantined", "ejected", "probing")


class NoHealthyReplica(QueueFull):
    """Raised by ``submit`` when no replica is admissible right now.

    Subclasses :class:`~repro_torch.serve.router.QueueFull` so the bounded
    retry/backoff policy in ``run()`` applies unchanged: back off and
    retry while cooldowns elapse, shed only after the budget.
    """


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds for the per-replica health state machine.

    ``fail_threshold`` consecutive strikes quarantine a replica
    (drain: no new admissions, existing work continues);
    ``eject_threshold`` strikes eject it (every in-flight request is
    rescued elsewhere). A strike is a failed round, a failed
    admission, or a round slower than ``latency_factor`` × the
    planned per-round budget. Ejected replicas re-enter as probing
    after ``cooldown_rounds`` and must put up ``probe_successes``
    clean rounds before counting as healthy again.
    """

    fail_threshold: int = 3
    eject_threshold: int = 5
    latency_factor: float = 20.0
    cooldown_rounds: int = 4
    probe_successes: int = 2


class ReplicaHealth:
    """One replica's health state machine (see module diagram).

    ``strike()`` and ``success()`` drive transitions; ``tick()``
    advances the ejection cooldown once per router round.
    ``transitions`` keeps every (round, from, to) edge for the chaos
    artifact.
    """

    def __init__(self, cfg: HealthConfig):
        self.cfg = cfg
        self.state = "healthy"
        self.strikes = 0
        self.successes = 0
        self.cooldown = 0
        self.transitions: list = []

    def admissible(self) -> bool:
        """May new work land here? (healthy or probing)"""
        return self.state in ("healthy", "probing")

    def steppable(self) -> bool:
        """Should the router still step this replica? (not ejected)"""
        return self.state != "ejected"

    def _to(self, state: str, round_idx: int) -> None:
        self.transitions.append((round_idx, self.state, state))
        self.state = state

    def strike(self, round_idx: int) -> bool:
        """Record one failure; returns True when this strike ejects.

        The caller must rescue the replica's in-flight work when True
        is returned (the state machine only tracks, never touches
        requests).
        """
        self.successes = 0
        self.strikes += 1
        if self.state == "probing":
            self._to("ejected", round_idx)
            self.cooldown = self.cfg.cooldown_rounds
            return True
        if (self.state == "healthy"
                and self.strikes >= self.cfg.fail_threshold):
            self._to("quarantined", round_idx)
        if (self.state == "quarantined"
                and self.strikes >= self.cfg.eject_threshold):
            self._to("ejected", round_idx)
            self.cooldown = self.cfg.cooldown_rounds
            return True
        return False

    def success(self, round_idx: int) -> None:
        """Record one clean round; may re-admit a draining replica."""
        if self.state == "quarantined":
            self._to("healthy", round_idx)
            self.strikes = 0
        elif self.state == "probing":
            self.successes += 1
            if self.successes >= self.cfg.probe_successes:
                self._to("healthy", round_idx)
                self.strikes = 0
        else:
            self.strikes = 0             # consecutive-failure scoring

    def tick(self, round_idx: int) -> None:
        """Advance the ejection cooldown; ejected -> probing at zero."""
        if self.state == "ejected":
            self.cooldown -= 1
            if self.cooldown <= 0:
                self._to("probing", round_idx)
                self.strikes = 0
                self.successes = 0


def deadline_for(plan, max_new_tokens: int, *, chunk: int | None = None,
                 slack: float = 3.0, queue_rounds: int = 0,
                 dispatch_overhead_s: float = 2e-4) -> float:
    """Planner-derived completion deadline for one request, in seconds.

    ``ceil(max_new_tokens / chunk)`` decode rounds at the plan's
    modeled per-round seconds, plus ``queue_rounds`` of expected
    queueing, stretched by ``slack``. Attach the result to
    ``Request.deadline_s`` so "late" is defined relative to what the
    port model promises on this machine, not an absolute constant.
    """
    c = plan.chunk if chunk is None else max(1, int(chunk))
    rounds = math.ceil(max(1, int(max_new_tokens)) / c) + int(queue_rounds)
    return slack * rounds * planned_round_seconds(
        plan, chunk=c, dispatch_overhead_s=dispatch_overhead_s)


def priced_degradation(plan, chunk: int, slots: int, replicas_up: int,
                       backlog_tokens: int, *,
                       deadline_s: float | None = None,
                       dispatch_overhead_s: float = 2e-4,
                       trigger: str = "overload") -> dict:
    """Price keep vs. re-planned smaller chunk vs. shed; pick one.

    Every option is costed in the plan's modeled seconds: one round
    takes ``chunk * t_step + overhead`` and draining the backlog takes
    ``rounds = ceil(backlog / (slots * replicas_up * chunk))`` of
    them. Halving the chunk halves the per-round latency (what a
    deadline cares about) but pays the dispatch overhead twice as
    often (what throughput cares about) — the same trade
    ``plan_chunk_size`` resolves at planning time, re-resolved here
    under degraded capacity. The choice is the cheapest-drain option
    whose *per-round* latency fits the deadline; when not even the
    smallest chunk fits, the verdict is ``"shed"``. Returns the
    decision with every priced option attached, so the fig10 artifact
    records the justification, not just the verdict.
    """
    t = plan.t_step_seconds
    up = max(1, int(replicas_up))
    backlog = max(0, int(backlog_tokens))
    candidates = {"keep": max(1, int(chunk))}
    half = max(1, int(chunk) // 2)
    if half != candidates["keep"]:
        candidates["replan"] = half
    options = {}
    for name, c in candidates.items():
        round_s = c * t + dispatch_overhead_s
        rounds = math.ceil(backlog / max(1, slots * up * c)) if backlog \
            else 0
        options[name] = {"chunk": c, "round_s": round_s,
                         "drain_s": round_s * rounds}
    feasible = {
        name: o for name, o in options.items()
        if deadline_s is None or o["round_s"] <= deadline_s}
    if feasible:
        choice = min(feasible, key=lambda n: (feasible[n]["drain_s"],
                                              n != "keep"))
    else:
        choice = "shed"
    return {"trigger": trigger, "choice": choice,
            "chunk": options.get(choice, {}).get("chunk"),
            "deadline_s": deadline_s, "backlog_tokens": backlog,
            "replicas_up": up, "options": options}


class FaultTolerantRouter(ReplicaRouter):
    """ReplicaRouter with health tracking, rescue, and degradation.

    Drop-in superset of the base router: same ``submit`` / ``step`` /
    ``run`` / ``stats`` surface, driven on a virtual clock. Per
    round, each non-ejected replica is deadline-checked, admitted
    into, and stepped; failures and latency breaches strike its
    :class:`ReplicaHealth`, ejection rescues its in-flight requests
    onto healthy replicas, and page-pool exhaustion triggers a priced
    keep/replan/shed decision (``degrade_log``). ``drain_events()``
    yields the event stream the chaos harness reconciles — nothing is
    ever silently dropped.
    """

    def __init__(self, replicas: list, *, policy: str = "round_robin",
                 max_queue: int = 8,
                 health: HealthConfig | None = None,
                 budget_s: float | None = None):
        super().__init__(replicas, policy=policy, max_queue=max_queue)
        self.health_cfg = health if health is not None else HealthConfig()
        self.health = [ReplicaHealth(self.health_cfg)
                       for _ in self.replicas]
        self._budget_override = budget_s
        self.now_s = 0.0
        self.round_idx = 0
        self._requests: dict = {}        # rid -> original Request
        self._prefix: dict = {}          # rid -> rescued tokens so far
        self._deadline_at: dict = {}     # rid -> absolute virtual deadline
        self._resubmit: deque = deque()  # rescued, awaiting resubmission
        self._pending_retire: list = []  # rescues already at full budget
        self.events: list = []
        self.degrade_log: list = []
        self.rescue_log: list = []
        self.rescued = 0
        self.deadline_shed = 0
        self.deadline_cancelled = 0

    # -- budgets ------------------------------------------------------------
    def budget(self, i: int) -> float:
        """Planned healthy per-round seconds for replica ``i``."""
        if self._budget_override is not None:
            return float(self._budget_override)
        eng = self.replicas[i]
        b = getattr(eng, "budget_s", None)
        if b is not None:
            return float(b)
        plan = getattr(eng, "plan", None)
        if plan is not None:
            return planned_round_seconds(plan, chunk=eng.chunk)
        return 1e-3

    # -- admission ----------------------------------------------------------
    def _pick(self) -> int:
        ok = [i for i, h in enumerate(self.health) if h.admissible()]
        if not ok:
            err = NoHealthyReplica(
                "no admissible replica (all quarantined/ejected)")
            err.replica = 0
            raise err
        if self.policy == "round_robin":
            for k in range(len(self.replicas)):
                i = (self._rr + k) % len(self.replicas)
                if i in ok:
                    self._rr = (i + 1) % len(self.replicas)
                    return i
        return min(ok, key=self._active_tokens)

    def submit(self, req) -> int:
        """Submit with deadline registration (relative -> absolute)."""
        i = super().submit(req)
        self._requests.setdefault(req.rid, req)
        if req.deadline_s is not None and req.rid not in self._deadline_at:
            self._deadline_at[req.rid] = self.now_s + float(req.deadline_s)
        return i

    # -- rescue -------------------------------------------------------------
    def _rescue(self, i: int, rid: str, toks, reason: str) -> None:
        """Resubmit one interrupted stream as a prompt+prefix replay."""
        orig = self._requests.get(rid)
        prefix = list(self._prefix.get(rid, []))
        prefix += [int(t) for t in np.asarray(toks).tolist()]
        if orig is None:                 # unknown rid: keep, don't lose
            self.quarantined.append((rid, np.asarray(prefix, np.int32)))
            return
        remaining = orig.max_new_tokens - len(prefix)
        self._prefix[rid] = prefix
        if remaining <= 0:               # already owed nothing: retire
            self._pending_retire.append(rid)
            return
        eng = self.replicas[i]
        self.rescue_log.append({
            "rid": rid, "replica": i, "reason": reason,
            "prefix": len(prefix),
            "rows": rescue_traffic(
                eng.cfg, len(orig.prompt), len(prefix), eng.max_len,
                page_size=getattr(eng, "page_size", None)
                if getattr(eng, "paged", False) else None)})
        self._resubmit.append(Request(
            rid, prompt=tuple(orig.prompt) + tuple(prefix),
            max_new_tokens=remaining, deadline_s=orig.deadline_s))
        self.rescued += 1
        self.events.append({"kind": "rescue", "rid": rid, "replica": i,
                            "reason": reason, "round": self.round_idx,
                            "prefix": len(prefix)})

    def _eject(self, i: int) -> None:
        """Evacuate replica ``i``: requeue its queue, rescue its slots."""
        eng = self.replicas[i]
        q = self.queues[i]
        while q:
            r = q.popleft()
            self._owner.pop(r.rid, None)
            self._resubmit.append(r)
            self.events.append({"kind": "requeue", "rid": r.rid,
                                "replica": i, "round": self.round_idx})
        for st in [s for s in eng.slots if s is not None]:
            out = eng.cancel(st.rid)
            self._owner.pop(st.rid, None)
            self._rescue(i, st.rid, out, reason="eject")

    def _on_quarantined(self, i: int, rid: str, toks) -> None:
        """Non-finite stream: strike the replica, rescue the stream."""
        self.failed[i] += 1
        if self.health[i].strike(self.round_idx):
            self._eject(i)
        self._rescue(i, rid, toks, reason="nonfinite")

    def _merge_prefix(self, rid: str, toks):
        """Prepend any rescued prefix to a retiring stream's tokens."""
        prefix = self._prefix.pop(rid, None)
        if not prefix:
            return toks
        self.events.append({"kind": "rescued_complete", "rid": rid,
                            "round": self.round_idx,
                            "prefix": len(prefix)})
        return np.concatenate(
            [np.asarray(prefix, np.int32), np.asarray(toks, np.int32)])

    # -- degradation --------------------------------------------------------
    def _degrade(self, i: int, eng, req) -> None:
        """Pool exhausted on admit: priced keep/replan/shed decision."""
        plan = getattr(eng, "plan", None)
        q = self.queues[i]
        if plan is None:                 # explicit-chunk engine: keep
            return                       # queued, retry next round
        up = sum(1 for h in self.health if h.admissible())
        backlog = self._active_tokens(i)
        dl = self._deadline_at.get(req.rid)
        decision = priced_degradation(
            plan, eng.chunk, eng.max_slots, up, backlog,
            deadline_s=None if dl is None else dl - self.now_s,
            trigger="pool_exhausted")
        decision["replica"] = i
        decision["round"] = self.round_idx
        decision["rid"] = req.rid
        self.degrade_log.append(decision)
        if decision["choice"] == "shed":
            q.remove(req)
            self._owner.pop(req.rid, None)
            self.shed[i] += 1
            self.shed_rids.append(req.rid)
            self.events.append({"kind": "shed", "rid": req.rid,
                                "replica": i, "round": self.round_idx,
                                "reason": "pool_exhausted"})
        elif decision["choice"] == "replan" and hasattr(eng, "set_chunk"):
            eng.set_chunk(decision["chunk"])

    def _shed(self, req, replica: int, reason: str) -> None:
        """Retry budget spent: justify the shed with a priced comparison."""
        super()._shed(req, replica, reason)
        eng = self.replicas[replica]
        plan = getattr(eng, "plan", None)
        if plan is not None:
            up = sum(1 for h in self.health if h.admissible())
            decision = priced_degradation(
                plan, eng.chunk, eng.max_slots, up,
                self._active_tokens(replica), trigger="retry_exhausted")
            decision["choice"] = "shed"  # the retry budget already chose
            decision["replica"] = replica
            decision["rid"] = req.rid
            self.degrade_log.append(decision)
        self.events.append({"kind": "shed", "rid": req.rid,
                            "replica": replica, "round": self.round_idx,
                            "reason": reason})

    # -- rounds -------------------------------------------------------------
    def _deadline_sweep(self, i: int, eng) -> None:
        """Shed queued / cancel active requests past their deadline."""
        q = self.queues[i]
        for r in list(q):
            dl = self._deadline_at.get(r.rid)
            if dl is not None and self.now_s > dl:
                q.remove(r)
                self._owner.pop(r.rid, None)
                self.deadline_shed += 1
                self.events.append({"kind": "deadline_shed", "rid": r.rid,
                                    "replica": i,
                                    "round": self.round_idx})
        for st in [s for s in eng.slots if s is not None]:
            dl = self._deadline_at.get(st.rid)
            if dl is not None and self.now_s > dl:
                out = eng.cancel(st.rid)
                self._owner.pop(st.rid, None)
                self.deadline_cancelled += 1
                merged = self._merge_prefix(st.rid, out)
                self.events.append({"kind": "deadline_cancel",
                                    "rid": st.rid, "replica": i,
                                    "round": self.round_idx,
                                    "tokens": int(len(merged))})

    def step(self) -> list:
        """One fault-aware round; advances the virtual clock.

        Order per replica: health tick, deadline sweep, admissions
        (admissible states only — quarantined replicas drain), one
        decode round with failure/latency scoring, quarantine drain.
        Rescued requests are resubmitted before admissions so they
        re-enter service with minimum added latency. The clock
        advances by the slowest stepped replica's reported seconds
        (replicas step concurrently in a real deployment).
        """
        self.round_idx += 1
        retired = []
        for rid in self._pending_retire:
            toks = np.asarray(self._prefix.pop(rid, []), np.int32)
            retired.append((rid, toks))
        self._pending_retire = []
        keep = deque()
        while self._resubmit:
            req = self._resubmit.popleft()
            try:
                self.submit(req)
            except QueueFull:
                keep.append(req)
        self._resubmit = keep
        step_secs = []
        for i, eng in enumerate(self.replicas):
            h = self.health[i]
            h.tick(self.round_idx)
            if not h.steppable():
                continue
            self._deadline_sweep(i, eng)
            q = self.queues[i]
            if h.admissible():
                while q and eng.free_slots():
                    req = q[0]
                    try:
                        eng.admit(req)
                    except TransientFault:
                        self.failed[i] += 1
                        if h.strike(self.round_idx):
                            self._eject(i)
                        break
                    except PoolExhausted:
                        self.failed[i] += 1
                        self._degrade(i, eng, req)
                        break
                    q.popleft()
            if h.state == "ejected":     # struck out during admission
                continue
            done = []
            if any(s is not None for s in eng.slots):
                try:
                    done = eng.step()
                except TransientFault:
                    self.failed[i] += 1
                    if h.strike(self.round_idx):
                        self._eject(i)
                else:
                    dt = float(getattr(eng, "last_step_seconds",
                                       self.budget(i)))
                    step_secs.append(min(
                        dt, self.health_cfg.latency_factor
                        * self.budget(i)))
                    if dt > self.health_cfg.latency_factor \
                            * self.budget(i):
                        if h.strike(self.round_idx):
                            self._eject(i)
                    else:
                        h.success(self.round_idx)
            elif h.state in ("probing", "quarantined"):
                # idle probe: with no slots to step there is nothing
                # left to drain and nothing to strike on — without
                # this, a replica quarantined by admission faults
                # would stay quarantined forever and starve its queue
                h.success(self.round_idx)
            for rid, toks in done:
                self._owner.pop(rid, None)
                self.completed[i] += 1
                retired.append((rid, self._merge_prefix(rid, toks)))
            for rid, toks in self._drain_quarantined(i, eng):
                self._owner.pop(rid, None)
                self._on_quarantined(i, rid, toks)
        self.now_s += max(step_secs) if step_secs else max(
            self.budget(i) for i in range(len(self.replicas)))
        return retired

    def busy(self) -> bool:
        """True while anything is queued, active, or awaiting rescue."""
        return (bool(self._resubmit) or bool(self._pending_retire)
                or super().busy())

    def drain_events(self) -> list:
        """Return and clear the event log (shed/rescue/deadline/...)."""
        out, self.events = self.events, []
        return out

    def stats(self) -> list:
        """Base counters plus each replica's health state and strikes."""
        rows = super().stats()
        for i, row in enumerate(rows):
            row["health"] = self.health[i].state
            row["strikes"] = self.health[i].strikes
        return rows
