"""Fault tolerance & straggler mitigation for thousand-node runs
(counterpart of ``repro/launch/faults.py``; pure Python, copied as it is).

Pieces (wired together by repro_torch.launch.train):
 * StragglerDetector — EWMA + z-score over per-step wall times; flags a
   step (and by extension the slowest host when per-host times are fed)
   as a straggler. Mitigation hook: raise the checkpoint cadence and/or
   trigger elastic re-mesh when the same host trips K times.
 * HeartbeatRegistry — host liveness bookkeeping with a miss budget
   (stands in for a cluster runtime's health service).
 * elastic_mesh_shape — largest (data, model)-factorable mesh from the
   surviving chip count; model-parallel width is preserved when possible
   (weights reshard along data only — cheap restart from checkpoint).
 * RestartManager — crash-recovery loop: run step fn, checkpoint every
   N steps, on failure restore latest commit and resume (used by the
   fault-injection integration test).
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1
    z_thresh: float = 3.0
    warmup: int = 8

    def __post_init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.flags = 0

    def observe(self, dt: float) -> bool:
        """Feed one step time; returns True if it is a straggler step."""
        self.n += 1
        if self.n <= self.warmup:
            # prime the EWMA
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        z = (dt - self.mean) / max(math.sqrt(self.var), 1e-9)
        is_straggler = z > self.z_thresh
        if is_straggler:
            self.flags += 1
        else:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + \
                self.alpha * (dt - self.mean) ** 2
        return is_straggler


@dataclasses.dataclass
class HeartbeatRegistry:
    n_hosts: int
    miss_budget: int = 3

    def __post_init__(self):
        self.last_seen = {h: 0.0 for h in range(self.n_hosts)}
        self.misses = {h: 0 for h in range(self.n_hosts)}

    def beat(self, host: int, t: float | None = None):
        self.last_seen[host] = t if t is not None else time.time()
        self.misses[host] = 0

    def sweep(self, timeout: float, now: float | None = None) -> list:
        """Returns hosts considered dead (miss budget exhausted)."""
        now = now if now is not None else time.time()
        dead = []
        for h, t in self.last_seen.items():
            if now - t > timeout:
                self.misses[h] += 1
                if self.misses[h] >= self.miss_budget:
                    dead.append(h)
        return dead


def elastic_mesh_shape(n_chips: int, *, model_pref: int = 16,
                       pod_size: int = 256) -> tuple:
    """Pick (pod, data, model) for a degraded chip count.

    Keeps the model axis at `model_pref` if n_chips allows (weights then
    reshard only along data); shrinks pods first.
    """
    pods = max(1, n_chips // pod_size)
    per_pod = n_chips // pods if pods > 1 else n_chips
    model = model_pref
    while model > 1 and per_pod % model:
        model //= 2
    data = per_pod // model
    if pods > 1:
        return (pods, data, model)
    return (data, model)


class RestartManager:
    """Checkpoint-every-N, restore-on-failure step loop."""

    def __init__(self, checkpointer, ckpt_every: int = 50):
        self.ckpt = checkpointer
        self.every = ckpt_every
        self.restarts = 0

    def run(self, state, step_fn, n_steps: int, *, start_step: int = 0,
            inject_failure_at: int | None = None):
        """Runs step_fn(state, step)->state; simulated failures raise
        RuntimeError once at `inject_failure_at` (integration tests)."""
        step = start_step
        failed_once = False
        while step < n_steps:
            try:
                if inject_failure_at is not None and not failed_once \
                        and step == inject_failure_at:
                    failed_once = True
                    raise RuntimeError("injected node failure")
                state = step_fn(state, step)
                step += 1
                if step % self.every == 0:
                    self.ckpt.save(step, state)
            except RuntimeError:
                self.restarts += 1
                self.ckpt.wait()
                got = self.ckpt.restore_latest(state)
                if got[0] is None:
                    step = start_step     # no checkpoint yet: restart fresh
                else:
                    step, state = got
        self.ckpt.wait()
        return state, step
