"""Replica router: admission control over N serve-engine replicas.

The counterpart of ``repro/serve/router.py``: plain host code, the same
policies, queues, counters and rounds.

One :class:`ServeEngine` (or :class:`PagedServeEngine`) is a single
continuous-batching domain: every active request shares its slot cache,
its chunk clock, and — when mesh-sharded — its device mesh. Scaling
*traffic* rather than model size means running N such engines
side-by-side and deciding, per request, which replica admits it. That
admission decision is this module.

The router is deliberately engine-shaped rather than wall-clock-shaped:
it owns per-replica *pending queues* and a ``step()`` that advances
every replica one decode round, so the closed-loop load harness
(``repro_torch.bench.fig9_load``) can drive it on a virtual clock and a
serving loop can drive it in real time with the same code.

Admission policies:

- ``round_robin`` — strict rotation over replicas; queue depth is
  ignored. Predictable, and optimal when requests are i.i.d.
- ``least_loaded`` — each submit goes to the replica with the fewest
  committed tokens (active decode work + queued requests); ties break
  toward the lowest index. This is the policy that absorbs bursty
  arrival traces without head-of-line blocking one replica.

Backpressure: each replica queue holds at most ``max_queue`` waiting
requests. A submit that finds its chosen replica full raises
:class:`QueueFull` — the caller (generator, launch loop) decides
whether to retry after a ``step()`` or to shed the request. Nothing is
silently dropped.

Cancel/fork forwarding: the router remembers which replica owns each
request id, so ``cancel`` reaches into the owning replica (or silently
removes a still-queued request) and ``fork`` lands the clone on the
parent's replica — pages can only be shared inside one engine's pool.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the chosen replica's queue is full."""


class ReplicaRouter:
    """Route requests across serve-engine replicas; drive them in rounds.

    ``replicas`` is a non-empty list of already-constructed engines
    (mixing dense and paged replicas is allowed — ``fork`` simply only
    works on requests owned by a paged replica). All replicas are
    assumed to serve the same model; the router never inspects params.
    """

    POLICIES = ("round_robin", "least_loaded")

    def __init__(self, replicas: list, *, policy: str = "round_robin",
                 max_queue: int = 8):
        if not replicas:
            raise ValueError("need at least one replica")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"known: {self.POLICIES}")
        self.replicas = list(replicas)
        self.policy = policy
        self.max_queue = int(max_queue)
        self.queues = [deque() for _ in self.replicas]
        self._rr = 0                     # next round-robin replica
        self._owner: dict = {}           # rid -> replica index
        self.submitted = [0] * len(self.replicas)
        self.completed = [0] * len(self.replicas)
        # robustness counters (surfaced by stats()): per-replica decode
        # failures, ``run()`` retry attempts, and requests shed after
        # the retry budget — attributed to the replica that refused the
        # final attempt. ``shed_rids`` names every shed request so a
        # drop is never silent; ``quarantined`` collects streams the
        # engines' non-finite guard pulled out of their batches.
        self.failed = [0] * len(self.replicas)
        self.retries = [0] * len(self.replicas)
        self.shed = [0] * len(self.replicas)
        self.shed_rids: list = []
        self.quarantined: list = []      # (rid, tokens-so-far) pairs

    # -- admission ----------------------------------------------------------
    def _active_tokens(self, i: int) -> int:
        """Committed decode work on replica ``i``: tokens still owed by
        its active slots plus everything waiting in its queue."""
        eng = self.replicas[i]
        owed = sum(s.remaining for s in eng.slots if s is not None)
        queued = sum(r.max_new_tokens for r in self.queues[i])
        return owed + queued

    def _pick(self) -> int:
        if self.policy == "round_robin":
            i = self._rr
            self._rr = (self._rr + 1) % len(self.replicas)
            return i
        return min(range(len(self.replicas)), key=self._active_tokens)

    def submit(self, req) -> int:
        """Enqueue one request; returns the replica index it landed on.

        Raises :class:`QueueFull` when the chosen replica's queue is at
        ``max_queue`` (round-robin does *not* hunt for a free queue —
        backpressure is the signal the load generator keys off).
        """
        if req.rid in self._owner:
            raise ValueError(f"duplicate request id {req.rid!r}")
        i = self._pick()
        if len(self.queues[i]) >= self.max_queue:
            err = QueueFull(
                f"replica {i} queue full ({self.max_queue} waiting)")
            err.replica = i              # lets run() attribute the shed
            raise err
        self.queues[i].append(req)
        self._owner[req.rid] = i
        self.submitted[i] += 1
        # prefetch the prompt to the chosen replica's device while the
        # request waits in queue (``serve.staging``). Rescue replays
        # resubmit through here, so rescued prompt+prefix streams are
        # staged for free.
        stage = getattr(self.replicas[i], "stage", None)
        if stage is not None:
            stage(req)
        return i

    def cancel(self, rid: str):
        """Abort a request wherever it lives; tokens so far or None.

        A still-queued request is removed before it ever touches a
        slot (returns an empty token array); an active one forwards to
        its replica's ``cancel`` (paged replicas recycle its pages).
        """
        i = self._owner.pop(rid, None)
        if i is None:
            return None
        for r in list(self.queues[i]):
            if r.rid == rid:
                self.queues[i].remove(r)
                self.completed[i] += 1
                return np.zeros((0,), np.int32)
        out = self.replicas[i].cancel(rid)
        if out is not None:
            self.completed[i] += 1
        return out

    def fork(self, rid: str, new_rid: str,
             max_new_tokens: int | None = None) -> int:
        """Fork an *active* request on its owning (paged) replica.

        Returns the replica index the clone runs on (always the
        parent's — CoW pages cannot cross page pools). Raises
        ``KeyError`` for unknown/queued rids and ``AttributeError``
        when the owning replica is dense.
        """
        i = self._owner.get(rid)
        if i is None:
            raise KeyError(f"no such request {rid!r}")
        self.replicas[i].fork(rid, new_rid, max_new_tokens)
        self._owner[new_rid] = i
        self.submitted[i] += 1
        return i

    # -- rounds -------------------------------------------------------------
    def step(self) -> list:
        """One router round: admit what fits, decode every busy replica.

        Per replica: pop queued requests into free slots (prefill +
        insert), then run one chunked decode round. Returns all
        requests retired this round as (rid, tokens) pairs, across
        replicas.
        """
        retired = []
        for i, eng in enumerate(self.replicas):
            q = self.queues[i]
            while q and eng.free_slots():
                eng.admit(q.popleft())
            if any(s is not None for s in eng.slots):
                done = eng.step()
            else:
                done = []
            for rid, toks in done:
                self._owner.pop(rid, None)
                self.completed[i] += 1
            retired.extend(done)
            for rid, toks in self._drain_quarantined(i, eng):
                self._owner.pop(rid, None)
                self._on_quarantined(i, rid, toks)
        return retired

    @staticmethod
    def _drain_quarantined(i: int, eng) -> list:
        """Pull the engine's non-finite-guard quarantine list, if any."""
        drain = getattr(eng, "drain_quarantined", None)
        return drain() if drain is not None else []

    def _on_quarantined(self, i: int, rid: str, toks) -> None:
        """A stream the guard pulled from replica ``i``'s batch.

        The base router records it as failed (tokens-so-far kept on
        ``self.quarantined`` — never silently lost); the
        fault-tolerant router overrides this to rescue the stream on a
        healthy replica instead.
        """
        self.failed[i] += 1
        self.quarantined.append((rid, toks))

    def busy(self) -> bool:
        """True while any replica has queued or active work."""
        return any(self.queues) or any(
            s is not None for eng in self.replicas for s in eng.slots)

    def _shed(self, req, replica: int, reason: str) -> None:
        """Drop one request after its retry budget is spent.

        Recorded, never silent: the rid lands on ``shed_rids`` and the
        per-replica ``shed`` counter (attributed to the replica that
        refused the final attempt) feeds ``stats()``.
        """
        self.shed[replica] += 1
        self.shed_rids.append(req.rid)

    def run(self, requests: list, *, max_retries: int = 8,
            backoff_base: int = 1, seed: int = 0,
            stall_rounds: int = 256) -> dict:
        """Serve a request list to completion: {rid: (n_tokens,) int32}.

        Submits as backpressure allows, then drains. ``QueueFull`` is
        retried at most ``max_retries`` times per request with
        exponential backoff in *rounds* (``backoff_base * 2**attempt``
        plus seeded jitter — rounds, not wall seconds, so the policy is
        identical on the virtual clock); a request that exhausts its
        budget is shed via :meth:`_shed` and reported in ``stats()``
        rather than retried forever. If ``stall_rounds`` consecutive
        rounds pass with no completion, no queue movement, no slot
        progress, and no retry pending, the router raises
        ``RuntimeError`` instead of spinning — the every-replica-wedged
        case is loud, not an infinite loop. This is the offline-batch
        path; the load harness drives ``submit``/``step`` itself to
        model arrival processes.
        """
        rng = np.random.default_rng(seed)
        pending = deque(requests)
        results: dict = {}
        attempts: dict = {}              # rid -> failed submit attempts
        not_before: dict = {}            # rid -> earliest retry round
        round_idx = 0
        stalled = 0
        last_sig = None
        while pending or self.busy():
            waiting = deque()
            while pending:
                req = pending.popleft()
                if not_before.get(req.rid, 0) > round_idx:
                    waiting.append(req)
                    continue
                try:
                    self.submit(req)
                except QueueFull as e:
                    n = attempts.get(req.rid, 0) + 1
                    attempts[req.rid] = n
                    replica = getattr(e, "replica",
                                      len(self.replicas) - 1)
                    if n > max_retries:
                        self._shed(req, replica, str(e))
                        continue
                    self.retries[replica] += 1
                    delay = backoff_base * (2 ** (n - 1))
                    delay += int(rng.integers(0, delay + 1))  # jitter
                    not_before[req.rid] = round_idx + delay
                    waiting.append(req)
            pending = waiting
            for rid, toks in self.step():
                results[rid] = toks
            round_idx += 1
            sig = (len(results), sum(self.completed), sum(self.shed),
                   tuple(len(q) for q in self.queues),
                   sum(s.remaining for eng in self.replicas
                       for s in eng.slots if s is not None))
            backing_off = any(r > round_idx for r in not_before.values())
            if sig == last_sig and not backing_off:
                stalled += 1
                if stalled >= stall_rounds:
                    raise RuntimeError(
                        f"router made no progress for {stalled} rounds "
                        f"({len(pending)} pending, "
                        f"{sum(len(q) for q in self.queues)} queued)")
            else:
                stalled = 0
            last_sig = sig
        return results

    def stats(self) -> list:
        """Per-replica counters: queue/progress plus robustness tallies.

        ``failed`` counts decode-round faults, ``retries`` the
        backoff-retried submits this replica refused, ``shed`` the
        requests dropped after the retry budget — all per replica, so
        a sick replica is visible in one row. ``pipeline`` and
        ``mean_dispatch_gap_s`` surface each replica's overlapped-
        runtime state: the in-flight round bound (0 = serial) and the
        measured mean host gap between decode-dispatch enqueues, as the
        JAX router's rows do.
        """
        return [{"replica": i,
                 "queued": len(self.queues[i]),
                 "active": sum(s is not None for s in eng.slots),
                 "submitted": self.submitted[i],
                 "completed": self.completed[i],
                 "failed": self.failed[i],
                 "retries": self.retries[i],
                 "shed": self.shed[i],
                 "pipeline": getattr(eng, "pipeline", 0),
                 "mean_dispatch_gap_s": (
                     eng.stats().get("mean_dispatch_gap_s", 0.0)
                     if hasattr(eng, "stats") else 0.0)}
                for i, eng in enumerate(self.replicas)]
