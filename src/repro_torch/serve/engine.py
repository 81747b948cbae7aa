"""Continuous-batching serve engine: fixed KV slots, admit/evict per
decode round, chunked decode.

The counterpart of the dense ``ServeEngine`` in ``repro/serve/engine.py``.
A request waits until a slot frees, is prefilled (batch 1, cache built
at the full horizon) and copied into its slot in place, then decodes
with every other active slot, each at its own position, ``chunk`` tokens
a dispatch. When its budget is spent it retires and the slot is free
for the next admission; the slot cache is never reallocated.

Each dispatch reads back the chunk's tokens once. Inside the chunk
nothing leaves the device; the attention occupancy bound ``kv_len`` is
worked out on the host from the slots' known positions, so the kernels
read only rows some active slot can see.

Sampled streams (``temperature > 0``) draw from one ``torch.Generator``
per request, seeded from the engine seed and the request id, so a
request's stream does not depend on its slot, its admission order or its
batchmates. They cannot match ``jax.random``'s streams.

Pipelined dispatch, prompt staging, the chunk planner, meshes, snapshots
and fault injection of the JAX engine are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.decode import make_chunked_decode_step, sample
from repro_torch.serve.slots import insert
from repro_torch.models import model as M
from repro_torch.train import serve as serve_lib


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt token ids and a token budget."""

    rid: str
    prompt: tuple                 # prompt token ids
    max_new_tokens: int


@dataclasses.dataclass
class _Slot:
    rid: str
    remaining: int                # tokens still owed to this request
    out: list                     # tokens emitted so far
    generator: torch.Generator | None


class ServeEngine:
    """Continuous-batching engine over ``max_slots`` preallocated KV slots.

    ``chunk`` tokens are decoded per dispatch, each request may reach
    ``max_len`` rows, and the kernels are routed by ``impl="auto"`` (the
    hand-written kernels on a CUDA device). ``device`` is where the cache
    lives and must hold ``params``. ``run(requests)`` drives admit ->
    decode-chunk -> retire rounds until every request has its tokens.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, max_slots: int,
                 max_len: int, chunk: int, temperature: float = 0.0,
                 seed: int = 0, device="cuda"):
        if not cfg.embed_inputs:
            raise ValueError("serve engine needs a token-id model")
        self.device = torch.device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(f"params live on {params['final_norm'].device},"
                             f" the engine on {self.device}")
        self.cfg, self.params = cfg, params
        self.max_slots, self.max_len = max_slots, max_len
        self.chunk = max(1, int(chunk))
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.cache = M.init_cache(cfg, max_slots, max_len, self.device)
        self._decode = make_chunked_decode_step(cfg, self.chunk,
                                                self.temperature)
        self._prefill = serve_lib.make_prefill_step(cfg, cache_len=max_len)
        # feeds the rows of free slots when sampling (their tokens are
        # discarded)
        self._idle_gen = self._generator(f"\0idle:{self.seed}")
        self.slots: list = [None] * max_slots
        self._tok = np.zeros((max_slots, 1), np.int64)
        self._pos = np.zeros((max_slots,), np.int32)
        self.quarantined: list = []   # (rid, tokens-so-far) pairs
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.decode_tokens = 0        # decode forward passes (per slot)
        # host wall time in prefill (admission) and decode dispatches; each
        # ends in a token readback, so device work is included
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # -- helpers ------------------------------------------------------------
    def _generator(self, rid: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(zlib.crc32(f"{self.seed}:{rid}".encode()))
        return g

    def free_slots(self) -> list:
        """Indices of slots with no active request."""
        return [i for i, s in enumerate(self.slots) if s is None]

    def _check_request(self, req: Request, prompt_len: int) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 "
                f"(got {req.max_new_tokens})")
        if prompt_len < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if prompt_len + req.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {prompt_len} + "
                f"{req.max_new_tokens} new tokens exceeds the slot "
                f"horizon {self.max_len}")
        # an out-of-vocab id raises in the CPU embedding lookup and
        # device-asserts on CUDA (JAX fills NaN); reject it here, where
        # the rid is still attached to the cause
        if min(req.prompt) < 0 or max(req.prompt) >= self.cfg.vocab_size:
            raise ValueError(
                f"request {req.rid}: prompt ids must be in "
                f"[0, {self.cfg.vocab_size})")

    def _first_tokens(self, logits, gens) -> np.ndarray:
        """First output token per row from the last-prompt-token logits."""
        return sample(logits, self.temperature, gens).cpu().numpy()

    # -- admission ----------------------------------------------------------
    def admit(self, req: Request, slot: int | None = None) -> int:
        """Prefill one request and copy it into a free slot, in place."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slot")
            slot = free[0]
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} busy")
        s = len(req.prompt)
        self._check_request(req, s)
        t0 = time.perf_counter()
        tokens = torch.tensor([req.prompt], dtype=torch.int64,
                              device=self.device)
        logits, one = self._prefill(self.params, {"tokens": tokens})
        self.prefill_dispatches += 1
        gen = self._generator(req.rid) if self.temperature > 0 else None
        tok0 = int(self._first_tokens(logits[:, -1], [gen])[0])
        insert(self.cache, one, slot)
        self.prefill_s += time.perf_counter() - t0
        self.slots[slot] = _Slot(req.rid, req.max_new_tokens - 1, [tok0],
                                 gen)
        self._tok[slot, 0] = tok0
        self._pos[slot] = s
        return slot

    def admit_batch(self, reqs: list) -> None:
        """Admit a full batch at once (all slots free, equal prompt lens).

        One batched prefill builds the whole slot cache; any other batch
        is admitted request by request.
        """
        lens = {len(r.prompt) for r in reqs}
        if (len(reqs) != self.max_slots or len(lens) != 1
                or any(s is not None for s in self.slots)):
            for r in reqs:
                self.admit(r)
            return
        s = lens.pop()
        for r in reqs:
            self._check_request(r, s)
        t0 = time.perf_counter()
        tokens = torch.tensor([list(r.prompt) for r in reqs],
                              dtype=torch.int64, device=self.device)
        logits, self.cache = self._prefill(self.params, {"tokens": tokens})
        self.prefill_dispatches += 1
        gens = [self._generator(r.rid) if self.temperature > 0 else None
                for r in reqs]
        tok0 = self._first_tokens(logits[:, -1], gens)
        self.prefill_s += time.perf_counter() - t0
        for i, r in enumerate(reqs):
            self.slots[i] = _Slot(r.rid, r.max_new_tokens - 1,
                                  [int(tok0[i])], gens[i])
            self._tok[i, 0] = tok0[i]
            self._pos[i] = s

    def cancel(self, rid: str):
        """Abort an active request; returns its tokens so far, or None."""
        for i, st in enumerate(self.slots):
            if st is not None and st.rid == rid:
                self.slots[i] = None
                return np.asarray(st.out, np.int32)
        return None

    # -- decode -------------------------------------------------------------
    def step(self) -> list:
        """One decode round: a single chunked dispatch over all slots.

        Returns the requests retired this round as (rid, tokens) pairs.
        """
        retired = []
        for i, st in enumerate(self.slots):
            if st is not None and st.remaining <= 0:   # 1-token budgets:
                # the prefill already yielded their only token
                retired.append((st.rid, np.asarray(st.out, np.int32)))
                self.slots[i] = None
        active = [i for i, st in enumerate(self.slots) if st is not None]
        if not active:
            return retired
        # rows any kept token can reach this chunk: pos + chunk at most
        kv_len = min(self.max_len,
                     int(self._pos[active].max()) + self.chunk)
        gens = None
        if self.temperature > 0:
            gens = [st.generator if st is not None else self._idle_gen
                    for st in self.slots]
        t0 = time.perf_counter()
        out = self._decode(self.params, self.cache,
                           torch.from_numpy(self._tok).to(self.device),
                           torch.from_numpy(self._pos).to(self.device),
                           gens, kv_len)
        self.decode_dispatches += 1
        self.decode_tokens += self.chunk
        toks = out[0].cpu().numpy()
        ok = out[3].cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        for i in active:
            st = self.slots[i]
            if not ok[i]:
                # non-finite logits this chunk: quarantine the request
                # with its pre-chunk tokens instead of self-feeding NaNs
                self.quarantined.append((st.rid, np.asarray(st.out,
                                                            np.int32)))
                self.slots[i] = None
                continue
            take = min(self.chunk, st.remaining)
            st.out.extend(int(t) for t in toks[i, :take])
            st.remaining -= take
            self._tok[i, 0] = toks[i, self.chunk - 1]
            self._pos[i] += self.chunk
            if st.remaining <= 0:
                retired.append((st.rid, np.asarray(st.out, np.int32)))
                self.slots[i] = None
        return retired

    def stats(self) -> dict:
        """Dispatch and token counters and wall times."""
        return {"decode_dispatches": self.decode_dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "decode_tokens": self.decode_tokens,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "quarantined": len(self.quarantined)}

    def run(self, requests: list) -> dict:
        """Serve a request list to completion: {rid: (n_tokens,) int32}."""
        pending = deque(requests)
        results: dict = {}
        first = True
        while pending or any(s is not None for s in self.slots):
            if pending and self.free_slots():
                if first and len(pending) >= self.max_slots:
                    self.admit_batch([pending.popleft()
                                      for _ in range(self.max_slots)])
                else:
                    for slot in self.free_slots():
                        if not pending:
                            break
                        self.admit(pending.popleft(), slot)
            first = False
            for rid, toks in self.step():
                results[rid] = toks
        return results
