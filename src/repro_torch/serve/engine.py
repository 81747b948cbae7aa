"""Continuous-batching serve engines: fixed KV slots, admit/evict per
decode round, chunked decode.

The counterpart of ``ServeEngine`` and ``PagedServeEngine`` in
``repro/serve/engine.py``. A request waits until a slot frees, is
prefilled (batch 1) and landed in its slot in place, then decodes with
every other active slot, each at its own position, ``chunk`` tokens a
dispatch. When its budget is spent it retires and the slot is free for
the next admission; the cache is never reallocated. Two cache layouts
share the engine skeleton:

- :class:`ServeEngine`: dense per-slot KV, every slot owning a
  ``max_len`` stripe, built at the full horizon at admission;
- :class:`PagedServeEngine`: paged KV (``serve.pages``), attention KV in
  fixed-size physical pages mapped through per-slot block tables,
  allocated lazily as positions advance, shared by refcount between
  identical prompt prefixes (copy on write at the first divergent
  write), and returned at retirement without a zero-fill.

Each dispatch reads back the chunk's tokens once. Inside the chunk
nothing leaves the device; the attention occupancy bound ``kv_len`` is
worked out on the host from the slots' known positions and rounded up to
a bucket of ``KV_BUCKET`` rows (:func:`kv_bucket`), so the kernels read
only rows some active slot can see, at one of a few fixed bounds.

On a CUDA device a chunk is one replay of a CUDA graph, captured once per
bucket (``serve.decode.ChunkGraphs``): the counterpart of the JAX step's
one compilation per static ``kv_len``. A capture or replay that fails
raises; ``cuda_graphs=False`` runs the same chunk eagerly on the card,
the graphs' parity reference. A CPU engine runs the chunk eagerly.

Sampled streams (``temperature > 0``) draw from one ``torch.Generator``
per request, seeded from the engine seed and the request id, so a
request's stream does not depend on its slot, its admission order or its
batchmates. They cannot match ``jax.random``'s streams.

Slots are independent streams for every per-row mixer (attention,
Mamba, xLSTM). MoE blocks with finite capacity couple them, as in the
JAX engine: every slot's token, a free slot's included, goes through the
router and takes expert capacity, so one slot's stream depends on its
batchmates' tokens (serve MoE configs with a generous
``capacity_factor`` where bit-exact per-request streams matter; prefix
sharing, which reuses KV made in another prefill batch, assumes dense
FFNs for the same reason). A free slot feeds the token and position its
last request left, as the JAX engine's host rows do.

A model without attention (xlstm-125m) reads no KV rows: its chunks
run with no occupancy bound, one graph for every chunk.

With ``chunk=None`` the chunk size is planned from the port model's
per-step cost of the decode step (``serve.planner.plan_chunk_size``, on
``machine``: ``h100`` on a CUDA host), as the JAX engine plans it.

Two hooks serve the fault-tolerant router (``serve.health``):
:meth:`ServeEngine.drain_quarantined` hands over the streams the chunk's
non-finite guard pulled out of the batch, and :meth:`ServeEngine.set_chunk`
re-plans the chunk mid-flight. Pipelined dispatch (dense and paged),
prompt staging, meshes and snapshots of the JAX engine are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import pages as pages_lib
from repro_torch.serve.decode import (ChunkGraphs, draw_noise,
                                     make_chunk_body, sample)
from repro_torch.serve.planner import plan_chunk_size
from repro_torch.serve.slots import assign, insert
from repro_torch.train import serve as serve_lib

#: rows of a ``kv_len`` bucket: the dense kernel's block, 16 buckets (16
#: graphs) to a 2048-row horizon
KV_BUCKET = 128


def kv_bucket(rows: int, max_len: int) -> int:
    """The occupancy bound a chunk runs at: ``rows`` rounded up to a
    multiple of :data:`KV_BUCKET`, at most ``max_len``. The kernels visit
    only rows at or below each slot's position, so a wider bound reads
    no more rows; it only moves split boundaries."""
    return min(max_len, -(-rows // KV_BUCKET) * KV_BUCKET)


def kv_buckets(cfg: ModelConfig, max_len: int) -> list:
    """Every occupancy bound a chunk of ``cfg`` can run at: the buckets to
    ``max_len``, or ``[None]`` for a model that reads no KV rows."""
    if not M.has_attention(cfg):
        return [None]
    return sorted({kv_bucket(r, max_len) for r in
                   range(KV_BUCKET, max_len + KV_BUCKET, KV_BUCKET)})


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt token ids and a token budget.

    ``deadline_s`` is an optional completion budget in seconds relative
    to submission (virtual-clock seconds under the load harness). The
    engines ignore it; the fault-tolerant router (``serve.health``) sheds
    queued requests and cancels active ones once it is spent. ``None``
    means no deadline.
    """

    rid: str
    prompt: tuple                 # prompt token ids
    max_new_tokens: int
    deadline_s: float | None = None


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
    hand-written kernels on a CUDA device). With ``chunk=None`` the chunk
    is planned (``plan``, a ``serve.planner.ChunkPlan``; ``None`` for an
    explicit chunk) for ``machine``, the decode kernels' split-KV path
    bounded by ``max_len`` rows. ``device`` is where the cache
    lives and must hold ``params``. ``run(requests)`` drives admit ->
    decode-chunk -> retire rounds until every request has its tokens.
    On a CUDA device each chunk replays a CUDA graph (``graphs``, one per
    ``kv_len`` bucket, captured at its first use or by
    :meth:`capture_graphs`) unless ``cuda_graphs=False``.

    Subclass hooks (:class:`PagedServeEngine` overrides all six):
    ``_make_plan`` prices the chunk, ``_build_state`` allocates the cache
    and builds the steps,
    ``_insert_prefilled`` lands one prefilled request in a slot,
    ``_release_slot`` retires a slot, ``_pre_dispatch`` runs host-side
    bookkeeping before each chunk, ``_step_inputs`` gives the chunk's
    host inputs.
    """

    paged = False

    def __init__(self, cfg: ModelConfig, params: dict, *, max_slots: int,
                 max_len: int, chunk: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 machine: str | None = None, device="cuda", cuda_graphs: bool = True):
        if not cfg.embed_inputs:
            raise ValueError("serve engine needs a token-id model")
        self.device = torch.device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(f"params live on {params['final_norm'].device},"
                             f" the engine on {self.device}")
        self.cfg, self.params = cfg, params
        self.max_slots, self.max_len = max_slots, max_len
        self.temperature = float(temperature)
        self.seed = int(seed)
        if chunk is None:
            self.plan = self._make_plan(machine)
            chunk = self.plan.chunk
        else:
            self.plan = None     # explicit chunk: no analytic plan made
        self._attends = M.has_attention(cfg)
        self._build_state()
        self._cuda_graphs = self.device.type == "cuda" and cuda_graphs
        # chunk length -> (body, graphs): the chunk's device work, run
        # eagerly or captured by its graphs; kept across set_chunk so a
        # length seen before replays without a new capture
        self._chunks: dict = {}
        self.set_chunk(chunk)
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

    # -- layout hooks -------------------------------------------------------
    def _make_plan(self, machine):
        """Analytic chunk plan for this cache layout: the split-KV decode
        kernels read at most ``max_len`` rows a slot."""
        return plan_chunk_size(self.cfg, self.max_slots, self.max_len,
                               machine=machine, occupancy=self.max_len)

    def _build_state(self) -> None:
        """Allocate the cache and build the prefill step."""
        self.cache = M.init_cache(self.cfg, self.max_slots, self.max_len,
                                  self.device)
        self._prefill = serve_lib.make_prefill_step(self.cfg,
                                                    cache_len=self.max_len)

    def _insert_prefilled(self, slot: int, one: dict, prompt: tuple) -> None:
        """Land one prefilled (batch-1) request cache in ``slot``."""
        insert(self.cache, one, slot)

    def _release_slot(self, i: int) -> None:
        """Retire slot ``i`` and free whatever it held."""
        self.slots[i] = None

    def _pre_dispatch(self) -> None:
        """Host-side bookkeeping before a chunk (none for dense slots)."""

    def _step_inputs(self) -> dict:
        """A chunk's per-dispatch inputs as host arrays, by the step's
        argument names."""
        return {"tokens": self._tok, "pos": self._pos}

    def set_chunk(self, chunk: int) -> None:
        """Re-plan the decode chunk mid-flight (degraded mode).

        The cache, the slots and every in-flight stream stay as they are;
        the next :meth:`step` decodes ``chunk`` tokens a dispatch. A chunk
        length's body and graphs are built at its first use and kept: a
        length seen before takes them back, the counterpart of the JAX
        engine's hits in jit's compilation cache. Every length's graphs
        capture the same cache tensors and draw on one memory pool
        through one capture stream (they replay one at a time on one
        stream). Used by the fault-tolerant router's priced degradation
        (``serve.health``): a smaller chunk shortens each round at the
        cost of more dispatches a token.
        """
        chunk = max(1, int(chunk))
        if chunk not in self._chunks:
            body = make_chunk_body(self.cfg, chunk, self.temperature)
            graphs = None
            if self._cuda_graphs:
                graphs = ChunkGraphs(
                    body, self.cfg, self.params, self.cache,
                    batch=self.max_slots, n_tokens=chunk,
                    sampled=self.temperature > 0, device=self.device,
                    table_cols=self.pages_per_slot if self.paged else None,
                    share=next((g for _, g in self._chunks.values()), None))
            self._chunks[chunk] = (body, graphs)
        self.chunk = chunk
        self._body, self.graphs = self._chunks[chunk]

    @property
    def chunk_lengths(self) -> list:
        """The chunk lengths set so far, each with its body and graphs."""
        return sorted(self._chunks)

    def captured_graphs(self) -> int:
        """CUDA graphs captured so far, over every chunk length."""
        return sum(len(g.graphs) for _, g in self._chunks.values()
                   if g is not None)

    def drain_quarantined(self) -> list:
        """Return and clear the (rid, tokens-so-far) quarantine list.

        :meth:`step` fills it when the chunk's non-finite guard trips; the
        router drains it every round to rescue the streams on a healthy
        replica by replaying prompt + prefix.
        """
        out, self.quarantined = self.quarantined, []
        return out

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
        self._insert_prefilled(slot, one, tuple(int(t) for t in req.prompt))
        self.prefill_s += time.perf_counter() - t0
        self.slots[slot] = _Slot(req.rid, req.max_new_tokens - 1, [tok0],
                                 gen)
        self._tok[slot, 0] = tok0
        self._pos[slot] = s
        return slot

    def admit_batch(self, reqs: list) -> None:
        """Admit a full batch at once (all slots free, equal prompt lens).

        One batched prefill builds the whole slot cache; any other batch
        is admitted request by request, as is every batch of a paged
        engine (admission is where prefix matching happens).
        """
        lens = {len(r.prompt) for r in reqs}
        if (self.paged or len(reqs) != self.max_slots or len(lens) != 1
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
        logits, cache = self._prefill(self.params, {"tokens": tokens})
        assign(self.cache, cache)      # in place: the graphs hold the cache
        del cache
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
        """Abort an active request; returns its tokens so far, or None.

        On the paged engine the request's pages go straight back to the
        pool, with no zero-fill, and the next admission may recycle them.
        """
        for i, st in enumerate(self.slots):
            if st is not None and st.rid == rid:
                self._release_slot(i)
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
                self._release_slot(i)
        active = [i for i, st in enumerate(self.slots) if st is not None]
        if not active:
            return retired
        self._pre_dispatch()
        # rows any kept token can reach this chunk: pos + chunk at most
        kv_len = kv_bucket(int(self._pos[active].max()) + self.chunk,
                           self.max_len) if self._attends else None
        gens = None
        if self.temperature > 0:
            gens = [st.generator if st is not None else self._idle_gen
                    for st in self.slots]
        t0 = time.perf_counter()
        inputs = {k: torch.from_numpy(v)
                  for k, v in self._step_inputs().items()}
        if self.graphs is not None:
            toks, _, ok = self.graphs.run(kv_len, generators=gens, **inputs)
        else:
            noise = None if gens is None else draw_noise(
                gens, self.chunk, self.cfg.vocab_size, self.device)
            toks, _, ok = self._body(
                self.params, self.cache, noise=noise, kv_len=kv_len,
                **{k: v.to(self.device) for k, v in inputs.items()})
        self.decode_dispatches += 1
        self.decode_tokens += self.chunk
        toks = toks.cpu().numpy()
        ok = ok.cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        for i in active:
            st = self.slots[i]
            if not ok[i]:
                # non-finite logits this chunk: quarantine the request
                # with its pre-chunk tokens instead of self-feeding NaNs
                self.quarantined.append((st.rid, np.asarray(st.out,
                                                            np.int32)))
                self._release_slot(i)
                continue
            take = min(self.chunk, st.remaining)
            st.out.extend(int(t) for t in toks[i, :take])
            st.remaining -= take
            self._tok[i, 0] = toks[i, self.chunk - 1]
            self._pos[i] += self.chunk
            if st.remaining <= 0:
                retired.append((st.rid, np.asarray(st.out, np.int32)))
                self._release_slot(i)
        return retired

    def capture_graphs(self) -> int:
        """Capture the chunk's graph of every ``kv_len`` bucket up to the
        horizon not captured yet (:func:`kv_buckets`: one graph for a
        model without attention), so that no later dispatch captures one;
        returns how many were captured.

        The captures are made on the chunk inputs the next dispatch
        would load, bar its noise. The eager warm-up before the first one
        writes the KV rows a chunk from the slots' current positions
        writes, rows the next chunk writes again before any token reads
        them (a free slot's rows are replaced at admission; a free paged
        slot writes the scratch page), and leaves the recurrent state as
        it found it (``ChunkGraphs.capture``).
        """
        if self.graphs is None:
            raise RuntimeError("this engine runs no CUDA graphs")
        self.graphs.load(**{k: torch.from_numpy(v)
                            for k, v in self._step_inputs().items()})
        todo = [kv for kv in kv_buckets(self.cfg, self.max_len)
                if kv not in self.graphs.graphs]
        for kv in todo:
            self.graphs.capture(kv)
        return len(todo)

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


class PagedServeEngine(ServeEngine):
    """Paged-KV serve engine: block tables, prefix sharing, CoW forks.

    Attention KV leaves are physical page pools of ``n_pages + 1`` pages
    of ``page_size`` rows. The extra page is a write-off scratch page:
    unmapped table entries point at it, so the rows free slots write and
    the overshoot writes of retiring slots land somewhere harmless and
    position-masked. Per-slot block tables live on the host
    (``block_tables``, -1 = unmapped) and are shipped each dispatch, a
    few KiB against the KV traffic they steer.

    What the dense engine builds eagerly, this engine allocates lazily:
    pages appear only when a slot's position advances into them
    (``_pre_dispatch``), admissions map shared prompt prefixes instead
    of copying them (``share_prefixes``), :meth:`fork` clones a stream
    for the cost of refcounts, and retirement returns pages with their
    stale contents: recycling skips the zero-fill a dense admission
    pays. ``gather_pages`` sums the live pages each dispatch reads.
    """

    paged = True

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 page_size: int = 8, n_pages: int | None = None,
                 share_prefixes: bool = True, **kw):
        self.page_size = int(page_size)
        self.pages_per_slot = pages_lib.pages_per_slot(kw["max_len"],
                                                       self.page_size)
        # dense-equivalent capacity by default: sharing and laziness can
        # only ever need fewer pages than one stripe per slot
        self.n_pages = int(n_pages) if n_pages is not None \
            else kw["max_slots"] * self.pages_per_slot
        self.share_prefixes = bool(share_prefixes)
        super().__init__(cfg, params, **kw)

    # -- layout hooks -------------------------------------------------------
    def _make_plan(self, machine):
        return plan_chunk_size(self.cfg, self.max_slots, self.max_len,
                               machine=machine, occupancy=self.max_len,
                               page_size=self.page_size)

    def _build_state(self) -> None:
        ps = self.page_size
        self.pool = pages_lib.PagePool(self.n_pages, ps)
        self._scratch = self.n_pages          # physical index of scratch
        self.cache = pages_lib.init_paged_cache(self.cfg, self.max_slots,
                                                self.n_pages + 1, ps,
                                                self.device)
        self.block_tables = np.full((self.max_slots, self.pages_per_slot),
                                    -1, np.int32)
        # prefill at exactly the prompt length: no horizon zero-fill;
        # fresh pages get real rows, recycled pages keep stale ones
        self._prefill = serve_lib.make_prefill_step(self.cfg, cache_len=None)
        self.gather_pages = 0                 # live pages read, summed
                                              # over dispatches

    def _insert_prefilled(self, slot: int, one: dict, prompt: tuple) -> None:
        ps = self.page_size
        s = len(prompt)
        npg = -(-s // ps)
        shared = self.pool.match_prefix(prompt) if self.share_prefixes \
            else []
        fresh = self.pool.allocate(npg - len(shared))
        held = list(shared) + list(fresh)
        if self.share_prefixes:
            # full prompt pages become matchable by later admissions
            self.pool.register_prefix(prompt, held[:s // ps])
        self.block_tables[slot, :] = -1
        self.block_tables[slot, :npg] = held
        # also when every page is shared: the recurrent leaves need the
        # slot row
        pages_lib.paged_insert(
            self.cfg, self.cache, one, slot,
            torch.tensor(fresh, dtype=torch.int64, device=self.device),
            torch.arange(len(shared), npg, device=self.device))

    def _release_slot(self, i: int) -> None:
        self.pool.release([int(p) for p in self.block_tables[i] if p >= 0])
        self.block_tables[i, :] = -1
        self.slots[i] = None

    def _pre_dispatch(self) -> None:
        """Make every page the coming chunk writes exist and be ours.

        For each active slot: allocate the pages its next ``min(chunk,
        remaining)`` positions touch, and copy on write any that are
        shared (prefix index, forks). After this the chunk's in-place
        row writes never land on a page another holder can see.
        Overshoot writes past ``remaining`` hit either an exclusively
        held page (rows masked after retirement) or the scratch page.
        """
        ps, pps = self.page_size, self.pages_per_slot
        for i, st in enumerate(self.slots):
            if st is None:
                continue
            p0 = int(self._pos[i])
            take = min(self.chunk, st.remaining)
            l_lo = min(p0 // ps, pps - 1)
            l_hi = min((p0 + take - 1) // ps, pps - 1)
            for lg in range(l_lo, l_hi + 1):
                phys = int(self.block_tables[i, lg])
                if phys < 0:
                    self.block_tables[i, lg] = self.pool.allocate(1)[0]
                    continue
                page, copied = self.pool.prepare_write(phys)
                if copied:
                    pages_lib.page_copy(self.cfg, self.cache, phys, page)
                self.block_tables[i, lg] = page
        live = self.block_tables[[i for i, st in enumerate(self.slots)
                                  if st is not None]]
        self.gather_pages += int((live >= 0).sum())

    def _step_inputs(self) -> dict:
        bt = np.where(self.block_tables < 0, self._scratch,
                      self.block_tables).astype(np.int32)
        return dict(super()._step_inputs(), block_tables=bt)

    # -- paged-only surface -------------------------------------------------
    def fork(self, rid: str, new_rid: str,
             max_new_tokens: int | None = None) -> int:
        """Clone an active stream into a free slot, copy-on-write.

        The clone maps the same physical pages (refcounted); divergent
        writes copy per page at the next ``_pre_dispatch``. Its recurrent
        state (Mamba, xLSTM) is copied into its slot row on the device.
        Sampled clones draw from their own generator. Returns the clone's
        slot.
        """
        src = next((i for i, st in enumerate(self.slots)
                    if st is not None and st.rid == rid), None)
        if src is None:
            raise KeyError(f"no active request {rid!r}")
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        dst = free[0]
        self.pool.fork([int(p) for p in self.block_tables[src] if p >= 0])
        self.block_tables[dst] = self.block_tables[src]
        pages_lib.slot_copy(self.cfg, self.cache, src, dst)
        st = self.slots[src]
        self.slots[dst] = _Slot(
            new_rid,
            st.remaining if max_new_tokens is None else max_new_tokens,
            list(st.out),
            self._generator(new_rid) if self.temperature > 0 else None)
        self._tok[dst] = self._tok[src]
        self._pos[dst] = self._pos[src]
        return dst

    def check_pool(self) -> None:
        """Assert page-conservation invariants over the live block tables."""
        self.pool.check_conservation(
            [[int(p) for p in self.block_tables[i] if p >= 0]
             for i, st in enumerate(self.slots) if st is not None])
