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
re-plans the chunk mid-flight.

Pipelined dispatch (``pipeline=2``, dense and paged) enqueues round N+1
while round N is still on the device, as the JAX engine's pipelined mode
does; the host blocks only when a stream retires, at the in-flight
bound, and in :meth:`~ServeEngine.cancel`, :meth:`PagedServeEngine.fork`
and :meth:`~ServeEngine.sync`. Token streams and dispatch counts are the
serial mode's (for MoE configs with finite capacity, the JAX engine's
pipelined streams: a free slot's fed token differs between the modes).
The rules that keep it so on the card:

- each in-flight round ships its positions, block tables and (after a
  sync) its host token feed from pinned host buffers of its own, with
  ``non_blocking=True`` (the counterpart of the JAX engine's
  ``_host_dev`` snapshot copies): the host advances ``_pos`` right after
  the enqueue, while the copy may still read the old buffer, and reuses a
  round's buffers only after consuming it;
- a graph's outputs are static buffers, so each round copies its tokens
  and guard flags into its pinned buffers (``non_blocking=True``) and
  records an event before the next round is enqueued; consuming a round
  waits on that event alone;
- a chained round feeds the previous round's last token column by a copy
  on the device (``_tok_dev``, one tensor of the engine's, so a
  :meth:`~ServeEngine.set_chunk` between rounds needs no move), and an
  admission patches its slot's row there;
- the ``kv_len`` bucket comes from the host's eagerly advanced ``_pos``,
  so it needs no readback.

The JAX engine's pipelined mode gives up cache donation (a donated
still-pending input would block the enqueue) and pays a copy-first cache
update. The port writes the cache in place in both modes, so it has no
counterpart of that trade, nor of the reference's
``test_serial_keeps_donation_pipelined_does_not``.

Prompts are staged ahead of admission (``serve.staging.PromptStager``:
:meth:`~ServeEngine.stage`, the router's ``submit``, :meth:`run`'s
look-ahead), and :meth:`~ServeEngine.snapshot` hands the params to a
``checkpoint.Checkpointer`` whose device-to-host copy runs on a side
stream, behind nothing the decode rounds enqueue.

Under a mesh (``mesh=``, a ``DeviceMesh`` from ``launch/mesh.py``; every
rank of it runs the same engine calls) the params are distributed by
``M.param_pspecs`` and the cache built shard by shard by
``M.cache_pspecs`` (``pages.paged_cache_pspecs``) under
``SERVE_ENGINE_RULES`` (KV heads on ``"model"``, slots on ``"data"``,
rows resident), and the steps run with the mesh and rules
installed (``utils.sharding.use_mesh_rules``): DTensor's propagation
places the collectives and the decode kernels run on each rank's local
head shard (``models.model``). The logits come back whole on every rank
and every rank samples from generators seeded alike, so all ranks pick
the same tokens and their caches stay one cache. Every config runs under
a mesh (the recurrent mixers and the MoE experts on each rank's shards,
``models.model``); pipelined dispatch runs there as it does unsharded,
every rank enqueueing the same rounds and deferring the same readbacks,
so the ranks' collectives meet in the same order; a paged cache with
its slots over the data axis runs the paged decode kernel on each data
shard's slots against one pool (``models.model._decode_paged_on_slots``);
a snapshot writes the params whole. A sharded engine stages no prompts.
A chunk on the card is one CUDA graph over NCCL; a gloo group cannot be
captured, so a gloo mesh on the card needs ``cuda_graphs=False``.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention.ops import validate_tp_heads
from repro_torch.models import model as M
from repro_torch.serve import pages as pages_lib
from repro_torch.serve.decode import (ChunkGraphs, draw_noise,
                                     make_chunk_body, sample)
from repro_torch.serve.planner import plan_chunk_size
from repro_torch.serve.slots import assign, insert
from repro_torch.serve.staging import PromptStager
from repro_torch.train import serve as serve_lib
from repro_torch.utils import sharding as shd

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


@dataclasses.dataclass
class _RoundBuffers:
    """The host side of one pipelined round, pinned on a CUDA engine: the
    inputs it ships (positions, the host token feed, block tables) and
    the outputs it copies back (tokens, guard flags), with the event
    recorded after its copies out."""

    pos: torch.Tensor             # (B,) int32
    tok: torch.Tensor             # (B, 1) int64
    tables: torch.Tensor | None   # (B, pages a slot) int32, paged only
    toks: torch.Tensor            # (B, chunk) int64
    ok: torch.Tensor              # (B,) bool
    done: object                  # torch.cuda.Event, None on the CPU


@dataclasses.dataclass
class _InFlight:
    """One dispatched round not yet consumed (pipelined mode).

    ``entries`` snapshots which slot objects the round decoded and how
    many of its tokens each keeps (``take``): the identity of the
    ``_Slot`` is what lets a later consume skip the rounds of a stream
    quarantined in an earlier round.
    """

    bufs: _RoundBuffers
    entries: list                 # [(slot index, _Slot, take)]
    chunk: int                    # chunk length the round decoded


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
    :meth:`capture_graphs`) unless ``cuda_graphs=False``. ``pipeline``
    bounds the decode rounds in flight (``True`` is 2; 0 dispatches
    serially, the default), ``stage_depth`` the prompts staged ahead of
    admission. ``mesh`` shards the engine over a ``DeviceMesh`` under
    ``SERVE_ENGINE_RULES`` (``tp`` is read off the mesh through them);
    ``mesh=None`` is the single-device path.

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
                 machine: str | None = None, device="cuda",
                 cuda_graphs: bool = True, pipeline: bool | int = 0,
                 stage_depth: int = 8, mesh=None):
        if not cfg.embed_inputs:
            raise ValueError("serve engine needs a token-id model")
        self.device = torch.device(device)
        if params["final_norm"].device.type != self.device.type:
            raise ValueError(f"params live on {params['final_norm'].device},"
                             f" the engine on {self.device}")
        self.cfg, self.params = cfg, params
        self.mesh = mesh
        self.rules = shd.SERVE_ENGINE_RULES if mesh is not None else None
        self._mesh_sizes = shd.mesh_axis_sizes(mesh) if mesh is not None \
            else {}
        self.tp = shd.tp_degree(self._mesh_sizes, self.rules)
        if mesh is not None:
            self._check_mesh(cuda_graphs)
            self.params = shd.distribute(
                params, mesh, M.param_pspecs(cfg, self.rules,
                                             self._mesh_sizes))
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
        # pipelined dispatch: True -> 2 rounds in flight, an int sets the
        # bound, 0 keeps the serial step
        self.pipeline = 2 if pipeline is True else max(0, int(pipeline))
        self._inflight: deque = deque()   # _InFlight records, oldest first
        self._spare: dict = {}            # chunk -> free _RoundBuffers
        # the chained token feed: the last round's last token column, on
        # the device; valid while rounds chain (not after a sync)
        self._tok_dev = torch.zeros((max_slots, 1), dtype=torch.int64,
                                    device=self.device)
        self._feed_on_device = False
        # host seconds between consecutive decode enqueues: serial rounds
        # wait for the token readback inside that window, pipelined ones
        # only do bookkeeping there (fig11 measures the difference)
        self.dispatch_gap_s = 0.0
        self.gap_rounds = 0
        self._t_enqueued: float | None = None
        self.stager = PromptStager(depth=stage_depth, device=self.device)
        # the params are written before this point and never after, so a
        # snapshot's copies wait for this event and nothing later
        self._params_ready = None
        if self.device.type == "cuda":
            self._params_ready = torch.cuda.Event()
            self._params_ready.record()
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.decode_tokens = 0        # decode forward passes (per slot)
        # host wall time in prefill (admission) and decode dispatches; each
        # ends in a token readback, so device work is included
        self.prefill_s = 0.0
        self.decode_s = 0.0

    # -- mesh ---------------------------------------------------------------
    def _check_mesh(self, cuda_graphs: bool):
        """Refuse what does not run under a mesh, before anything is
        placed: heads that do not divide the TP degree and CUDA graphs
        over a gloo group (``ValueError``)."""
        import torch.distributed as dist
        cfg, mesh = self.cfg, self.mesh
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, the engine on "
                             f"{self.device}")
        validate_tp_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff,
                          self.tp, page_size=getattr(self, "page_size", None))
        gloo = any(dist.get_backend(mesh.get_group(i)) == "gloo"
                   for i in range(mesh.ndim))
        if self.device.type == "cuda" and cuda_graphs and gloo:
            raise ValueError("a gloo group cannot be captured in a CUDA "
                             "graph: pass cuda_graphs=False")

    def _meshed(self, fn):
        """``fn`` run with the engine's mesh and rules installed (``fn``
        itself when there is no mesh)."""
        if self.mesh is None:
            return fn
        mesh, rules = self.mesh, self.rules

        def wrapped(*a, **kw):
            with shd.use_mesh_rules(mesh, rules):
                return fn(*a, **kw)
        return wrapped

    # -- layout hooks -------------------------------------------------------
    def _make_plan(self, machine):
        """Analytic chunk plan for this cache layout: the split-KV decode
        kernels read at most ``max_len`` rows a slot."""
        return plan_chunk_size(self.cfg, self.max_slots, self.max_len,
                               machine=machine, occupancy=self.max_len,
                               mesh=self.mesh)

    def _build_state(self) -> None:
        """Allocate the cache and build the prefill step."""
        specs = None if self.mesh is None else M.cache_pspecs(
            self.cfg, self.rules, self._mesh_sizes, self.max_slots,
            self.max_len)
        self.cache = M.init_cache(self.cfg, self.max_slots, self.max_len,
                                  self.device, mesh=self.mesh, specs=specs)
        self._prefill = self._meshed(serve_lib.make_prefill_step(
            self.cfg, cache_len=self.max_len))

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
            body = self._meshed(make_chunk_body(self.cfg, chunk,
                                                self.temperature))
            graphs = None
            if self._cuda_graphs:
                graphs = ChunkGraphs(
                    body, self.cfg, self.params, self.cache,
                    batch=self.max_slots, n_tokens=chunk,
                    sampled=self.temperature > 0, device=self.device,
                    tp=self.tp,
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
    def stage(self, req: Request) -> bool:
        """Prefetch one pending request's prompt to the device.

        Called ahead of admission (``run``'s look-ahead, the router's
        ``submit``, a rescue replay), so that :meth:`admit` finds the
        prompt on the device. The prefill reads the same bits either way.
        Returns True iff a new copy was issued; a sharded engine declines
        (its prefill takes the prompt from the host), as the reference's
        does.
        """
        if self.mesh is not None:
            return False
        return self.stager.stage(req.rid, tuple(int(t) for t in req.prompt))

    def admit(self, req: Request, slot: int | None = None) -> int:
        """Prefill one request and copy it into a free slot, in place.

        With rounds in flight the prefill and the insert run behind them
        on the stream, so their writes to this slot's retired rows or
        pages land first and the insert wins; the chained token feed is
        patched on the device.
        """
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
        prompt = tuple(int(t) for t in req.prompt)
        tokens = self.stager.take(req.rid, prompt) if self.mesh is None \
            else torch.tensor([prompt], dtype=torch.int64, device=self.device)
        logits, one = self._prefill(self.params, {"tokens": tokens})
        self.prefill_dispatches += 1
        gen = self._generator(req.rid) if self.temperature > 0 else None
        tok0 = int(self._first_tokens(logits[:, -1], [gen])[0])
        self._insert_prefilled(slot, one, prompt)
        self.prefill_s += time.perf_counter() - t0
        self.slots[slot] = _Slot(req.rid, req.max_new_tokens - 1, [tok0],
                                 gen)
        self._tok[slot, 0] = tok0
        if self._feed_on_device:
            self._tok_dev[slot, 0].fill_(tok0)
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
        Rounds in flight are consumed first, so the tokens returned are
        the serial step's.
        """
        if self._inflight:
            self.sync()
        self.stager.discard(rid)
        for i, st in enumerate(self.slots):
            if st is not None and st.rid == rid:
                self._release_slot(i)
                return np.asarray(st.out, np.int32)
        return None

    # -- decode -------------------------------------------------------------
    def step(self) -> list:
        """One decode round: a single chunked dispatch over all slots.

        Returns the requests retired this round as (rid, tokens) pairs.
        With ``pipeline`` set the round is enqueued while earlier rounds
        are still on the device, and the host reads tokens back only when
        a stream retires or the in-flight bound is passed; retirement and
        admission timing, and so the streams, are the serial step's.
        """
        if self.pipeline:
            return self._step_pipelined()
        return self._step_serial()

    def _round_args(self, active: list) -> tuple:
        """The coming chunk's ``(kv_len, generators)``: the occupancy
        bucket from the host's positions (rows any kept token can reach:
        pos + chunk at most), and one generator a slot when sampling (a
        free slot's feeds rows whose tokens are discarded)."""
        kv_len = kv_bucket(int(self._pos[active].max()) + self.chunk,
                           self.max_len) if self._attends else None
        gens = None
        if self.temperature > 0:
            gens = [st.generator if st is not None else self._idle_gen
                    for st in self.slots]
        return kv_len, gens

    def _mark_gap(self) -> None:
        """Add the host gap since the previous dispatch's enqueue."""
        now = time.perf_counter()
        if self._t_enqueued is not None:
            self.dispatch_gap_s += now - self._t_enqueued
            self.gap_rounds += 1

    def _step_serial(self) -> list:
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
        kv_len, gens = self._round_args(active)
        self._mark_gap()
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
        self._t_enqueued = time.perf_counter()
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

    def _step_pipelined(self) -> list:
        """One pipelined round: enqueue now, read back later.

        What needs no token value runs at once: ``remaining`` and the
        positions advance at dispatch, so the next round's page
        allocation and retirement decisions never wait on the device.
        Two things sync: a stream finishing (its tokens must be on the
        host to be returned) and the in-flight bound (the oldest round is
        consumed; by then it has run behind the newer dispatches).
        Syncing at the retirement round keeps slot-free timing, and so
        admission order and sampling, as in the serial step.
        """
        retired = []
        for i, st in enumerate(self.slots):
            if st is not None and st.remaining <= 0:   # 1-token budgets
                self.sync()
                st = self.slots[i]      # the sync may have quarantined it
                if st is not None and st.remaining <= 0:
                    retired.append((st.rid, np.asarray(st.out, np.int32)))
                    self._release_slot(i)
        active = [i for i, st in enumerate(self.slots) if st is not None]
        if not active:
            self.sync()
            return retired
        self._pre_dispatch()
        kv_len, gens = self._round_args(active)
        t0 = time.perf_counter()
        bufs = self._dispatch_async(kv_len, gens)
        self.decode_dispatches += 1
        self.decode_tokens += self.chunk
        entries, will_retire = [], False
        for i in active:
            st = self.slots[i]
            take = min(self.chunk, st.remaining)
            entries.append((i, st, take))
            st.remaining -= take
            self._pos[i] += self.chunk
            will_retire = will_retire or st.remaining <= 0
        self._inflight.append(_InFlight(bufs, entries, self.chunk))
        self.decode_s += time.perf_counter() - t0
        if will_retire:
            self.sync()
            for i, st in enumerate(self.slots):
                if st is not None and st.remaining <= 0:
                    retired.append((st.rid, np.asarray(st.out, np.int32)))
                    self._release_slot(i)
        else:
            while len(self._inflight) > self.pipeline:
                self._consume_oldest()
        return retired

    def _round_buffers(self) -> _RoundBuffers:
        """A free set of host buffers for a round of the current chunk
        length (pinned on a CUDA engine), made at its first use."""
        spare = self._spare.setdefault(self.chunk, [])
        if spare:
            return spare.pop()
        pin = self.device.type == "cuda"
        b = self.max_slots

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        return _RoundBuffers(
            pos=host((b,), torch.int32), tok=host((b, 1), torch.int64),
            tables=host((b, self.pages_per_slot), torch.int32)
            if self.paged else None,
            toks=host((b, self.chunk), torch.int64),
            ok=host((b,), torch.bool),
            done=torch.cuda.Event() if pin else None)

    def _dispatch_async(self, kv_len, gens) -> _RoundBuffers:
        """Enqueue one chunk with no host sync; returns its buffers.

        The round's inputs are snapshots in its own buffers, shipped with
        ``non_blocking=True``; its tokens and guard flags are copied back
        the same way and an event recorded after them, before any later
        replay can overwrite a graph's static outputs. The last token
        column becomes the next round's feed on the device.
        """
        self._mark_gap()
        bufs = self._round_buffers()
        host = self._step_inputs()
        bufs.pos.numpy()[:] = host["pos"]
        inputs = {"pos": bufs.pos}
        if bufs.tables is not None:
            bufs.tables.numpy()[:] = host["block_tables"]
            inputs["block_tables"] = bufs.tables
        if self._feed_on_device:
            inputs["tokens"] = self._tok_dev
        else:
            bufs.tok.numpy()[:] = self._tok
            inputs["tokens"] = bufs.tok
        if self.graphs is not None:
            toks, _, ok = self.graphs.run(kv_len, generators=gens,
                                          non_blocking=True, **inputs)
        else:
            noise = None if gens is None else draw_noise(
                gens, self.chunk, self.cfg.vocab_size, self.device)
            toks, _, ok = self._body(
                self.params, self.cache, noise=noise, kv_len=kv_len,
                **{k: v.to(self.device, non_blocking=True)
                   for k, v in inputs.items()})
        bufs.toks.copy_(toks, non_blocking=True)
        bufs.ok.copy_(ok, non_blocking=True)
        self._tok_dev.copy_(toks[:, self.chunk - 1:self.chunk])
        if bufs.done is not None:
            bufs.done.record()
        self._t_enqueued = time.perf_counter()
        self._feed_on_device = True
        return bufs

    def _consume_oldest(self) -> None:
        """Read back the oldest in-flight round and apply its bookkeeping.

        The one place pipelined mode touches a round's results: it waits
        on the round's event alone. Tokens land on each stream's ``out``
        and the host token feed catches up; a guard trip quarantines the
        stream as the serial step would, and the rounds dispatched after
        a poisoned one are skipped for that stream (their output fed on
        token 0 is garbage by construction).
        """
        rec = self._inflight.popleft()
        t0 = time.perf_counter()
        bufs = rec.bufs
        if bufs.done is not None:
            bufs.done.synchronize()
        toks, oks = bufs.toks.numpy(), bufs.ok.numpy()
        for i, st, take in rec.entries:
            if self.slots[i] is not st:
                continue            # quarantined in an earlier round
            if not oks[i]:
                self.quarantined.append((st.rid, np.asarray(st.out,
                                                            np.int32)))
                self._release_slot(i)
                continue
            st.out.extend(int(t) for t in toks[i, :take])
            self._tok[i, 0] = toks[i, rec.chunk - 1]
        self._spare.setdefault(rec.chunk, []).append(bufs)
        self.decode_s += time.perf_counter() - t0

    def sync(self) -> None:
        """Consume every in-flight round.

        After a sync the engine is where the serial step would be: every
        emitted token is on the host, the next dispatch ships its token
        feed from ``_tok``, and the quarantine list is complete. Cheap
        when nothing is in flight.
        """
        while self._inflight:
            self._consume_oldest()
        self._feed_on_device = False

    def snapshot(self, checkpointer, step: int) -> bool:
        """Snapshot the served params without stalling the stream.

        Hands ``{"params": ...}`` to ``checkpointer.save`` with
        ``skip_if_busy=True``: while the previous background write runs
        the snapshot is skipped (returns False). On a CUDA engine the
        device-to-host copies run on the checkpointer's side stream and
        wait only for the params' own writes, never for the decode rounds
        in flight. A sharded engine's params are written whole, as the
        reference writes them, by the mesh's first rank; every rank calls
        this, agrees on the skip before any gather and returns the same
        answer (``Checkpointer.save``).
        """
        return checkpointer.save(step, {"params": self.params},
                                 skip_if_busy=True, after=self._params_ready)

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
        self.sync()
        self.graphs.load(**{k: torch.from_numpy(v)
                            for k, v in self._step_inputs().items()})
        todo = [kv for kv in kv_buckets(self.cfg, self.max_len)
                if kv not in self.graphs.graphs]
        for kv in todo:
            self.graphs.capture(kv)
        return len(todo)

    def stats(self) -> dict:
        """Dispatch and token counters, wall times, the pipeline's state
        and the staging counters.

        ``decode_s`` is the host time in decode dispatches: serial rounds
        include their token readback, pipelined ones their enqueue and
        the waits of consuming rounds. ``mean_dispatch_gap_s`` is the mean
        host time between consecutive decode enqueues.
        """
        gap = self.dispatch_gap_s / self.gap_rounds if self.gap_rounds \
            else 0.0
        return {"decode_dispatches": self.decode_dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "decode_tokens": self.decode_tokens,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "quarantined": len(self.quarantined),
                "pipeline": self.pipeline,
                "in_flight": len(self._inflight),
                "dispatch_gap_s": self.dispatch_gap_s,
                "gap_rounds": self.gap_rounds,
                "mean_dispatch_gap_s": gap,
                "staging": self.stager.stats()}

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
            # look-ahead staging: the next pending prompts start their
            # copies now, behind nothing the decode rounds enqueue
            for r in list(pending)[:self.stager.depth]:
                self.stage(r)
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
                               page_size=self.page_size, mesh=self.mesh)

    def _build_state(self) -> None:
        ps = self.page_size
        self.pool = pages_lib.PagePool(self.n_pages, ps)
        self._scratch = self.n_pages          # physical index of scratch
        specs = None if self.mesh is None else pages_lib.paged_cache_pspecs(
            self.cfg, self.rules, self._mesh_sizes, self.max_slots,
            self.n_pages + 1, ps)
        self.cache = pages_lib.init_paged_cache(
            self.cfg, self.max_slots, self.n_pages + 1, ps, self.device,
            mesh=self.mesh, specs=specs)
        self.block_tables = np.full((self.max_slots, self.pages_per_slot),
                                    -1, np.int32)
        # prefill at exactly the prompt length: no horizon zero-fill;
        # fresh pages get real rows, recycled pages keep stale ones
        self._prefill = self._meshed(serve_lib.make_prefill_step(
            self.cfg, cache_len=None))
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
        Sampled clones draw from their own generator. Rounds in flight are
        consumed first, so the clone starts from the host's state. Returns
        the clone's slot.
        """
        if self._inflight:
            self.sync()
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
