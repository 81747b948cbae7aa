"""Chunked decode: ``n`` tokens a call, per-slot positions, greedy or
temperature sampling, and a per-slot non-finite guard.

The counterpart of ``repro/serve/decode.py``. The JAX step runs its
``n`` tokens as one jitted scan, compiled once per static ``kv_len``.
Here the chunk is an eager loop (:func:`make_chunk_body`), which the
CPU runs as it is, and which :class:`ChunkGraphs` captures on a CUDA
device as one CUDA graph per ``kv_len`` and replays: one graph launch a
chunk. Sampling noise is drawn before the chunk (:func:`draw_noise`),
so the loop holds no RNG. Tokens, positions and guard flags stay device
tensors throughout, so a chunk makes no host sync: the caller reads the
tokens back once, after the chunk.

Every step updates the cache's own tensors in place: the decode kernels
write the KV rows, and each recurrent mixer's new state (Mamba, xLSTM)
is copied into its fp32 cache tensors (``models.model``), the
counterpart of the JAX step's pin of its scan carry to the cache
contract's dtypes. So a captured graph reads and writes the same
storage at every replay.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.attention.decode import (counters_needed,
                                                  split_counters)
from repro_torch.models import model as M


def draw_noise(generators: list, n_tokens: int, vocab: int, device,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """A chunk's sampling noise: (n_tokens, B, V) fp32, uniform in [0, 1).

    Row ``[t, i]`` is ``V`` numbers from ``generators[i]``, drawn token by
    token and slot by slot, so each generator (one may feed several
    rows) gives the numbers it would give drawing ``V`` of them a token
    inside the chunk. ``out``, when given, is filled in place and
    returned.
    """
    if out is None:
        out = torch.empty((n_tokens, len(generators), vocab),
                          dtype=torch.float32, device=device)
    for t in range(n_tokens):
        for i, g in enumerate(generators):
            out[t, i].uniform_(generator=g)
    return out


def gumbel_argmax(logits: torch.Tensor, noise: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Gumbel-max: the sampled token of each row of ``logits`` (B, V)
    under uniform ``noise`` (B, V)."""
    gumbel = -torch.log(-torch.log(noise))
    return (logits.float() / temperature + gumbel).argmax(-1)


def sample(logits: torch.Tensor, temperature: float,
           generators: list | None) -> torch.Tensor:
    """Next token per row of ``logits`` (B, V): greedy or Gumbel-max.

    With ``temperature > 0`` row ``i`` draws its noise from
    ``generators[i]`` alone, so a row's samples depend only on its own
    generator and logits, never on its batchmates.
    """
    if temperature <= 0.0:
        return logits.argmax(-1)
    noise = draw_noise(generators, 1, logits.shape[-1], logits.device)
    return gumbel_argmax(logits, noise[0], temperature)


def make_chunk_body(cfg: ModelConfig, n_tokens: int,
                    temperature: float = 0.0, impl: str = "auto",
                    store_flavor: str | None = None):
    """The chunk's device work on given noise.

    Returns ``body(params, cache, tokens, pos, noise=None, kv_len=None,
    block_tables=None) -> (toks, pos, ok)``, the arguments as in
    :func:`make_chunked_decode_step`, ``noise`` the chunk's
    :func:`draw_noise` (used only when ``temperature > 0``). It makes no
    host sync, no host-to-device copy and no random draw, so a CUDA graph
    captures it as it is.
    """
    if not cfg.embed_inputs:
        raise ValueError("chunked decode needs a token embedding")
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")

    @torch.no_grad()
    def body(params, cache, tokens, pos, noise=None, kv_len=None,
             block_tables=None):
        ok = torch.ones(tokens.shape[0], dtype=torch.bool,
                        device=tokens.device)
        out = []
        tok = tokens
        for t in range(n_tokens):
            logits, _, cache = M.forward(
                cfg, params, {"tokens": tok}, mode="decode", cache=cache,
                pos=pos, impl=impl, kv_len=kv_len, store_flavor=store_flavor,
                block_tables=block_tables)
            lg = logits[:, 0]
            nxt = gumbel_argmax(lg, noise[t], temperature) \
                if temperature > 0.0 else lg.argmax(-1)
            ok &= torch.isfinite(lg).all(-1)
            nxt = torch.where(ok, nxt, 0)
            out.append(nxt)
            tok = nxt[:, None]
            pos = pos + 1
        return torch.stack(out, dim=1), pos, ok

    return body


def make_chunked_decode_step(cfg: ModelConfig, n_tokens: int,
                             temperature: float = 0.0, impl: str = "auto",
                             store_flavor: str | None = None):
    """Build the n-token decode chunk, run eagerly.

    Returns ``step(params, cache, tokens, pos, generators=None,
    kv_len=None, block_tables=None) -> (toks, cache, pos, ok)`` with
    ``tokens`` (B, 1)
    int64 (each slot's last emitted token), ``pos`` (B,) int32 (each
    slot's write position) and ``generators`` one ``torch.Generator``
    per slot, used only when ``temperature > 0``: the chunk's noise is
    drawn from them first (:func:`draw_noise`), then the chunk runs on it
    (:func:`make_chunk_body`). ``toks`` is (B, n_tokens). ``kv_len``
    bounds the cache rows attention reads for the whole chunk, so it must
    cover ``max(pos) + n_tokens`` of every slot whose tokens are kept.
    The cache is updated in place.

    ``ok`` (B,) bool is False for a slot whose logits went non-finite at
    any token of the chunk; such a slot feeds token 0 for the rest of the
    chunk so the next embedding lookup stays in range.

    ``block_tables`` (B, NB) int32 on the cache's device runs the chunk
    over a paged cache (``serve.pages``), the table passed to every token
    of the chunk (``kv_len`` then bounds the table columns read).
    """
    body = make_chunk_body(cfg, n_tokens, temperature, impl, store_flavor)

    def step(params, cache, tokens, pos, generators=None, kv_len=None,
             block_tables=None):
        noise = None
        if temperature > 0.0:
            noise = draw_noise(generators, n_tokens, cfg.vocab_size,
                               tokens.device)
        toks, pos, ok = body(params, cache, tokens, pos, noise, kv_len,
                             block_tables)
        return toks, cache, pos, ok

    return step


class ChunkGraphs:
    """A chunk body captured as one CUDA graph per ``kv_len``, replayed.

    The counterpart of the JAX step's one compilation per static
    ``kv_len`` (``None`` for a model that reads no KV rows: one graph). ``body`` (from :func:`make_chunk_body` on ``cfg``) runs
    over fixed ``params`` and ``cache`` and over static device buffers:
    ``tok`` (B, 1), ``pos`` (B,), ``tables`` (B, ``table_cols``) for a
    paged cache and ``noise`` (n_tokens, B, V) when ``sampled``.
    :meth:`run` copies a chunk's inputs into them, draws its noise into
    ``noise``, and replays the graph of its ``kv_len``, capturing it
    first at its first use (:meth:`capture`). Every graph draws on one
    memory pool: they replay one at a time on one stream, so their
    intermediates may share it; ``share``, another ``ChunkGraphs`` whose
    graphs replay on the same stream one at a time (another chunk length
    of one engine), lends its pool and capture stream, so the two sets
    reuse each other's intermediates.

    ``LAUNCHES`` counts a replay as the eager body counts its calls: the
    counts a capture records (which launch nothing) are taken back and
    added at every replay.
    """

    def __init__(self, body, cfg: ModelConfig, params: dict, cache: dict,
                 *, batch: int, n_tokens: int, sampled: bool, device,
                 table_cols: int | None = None, share=None):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {dev}")
        self.body, self.cfg = body, cfg
        self.params, self.cache = params, cache
        self.device = dev
        self.tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.tables = None if table_cols is None else torch.zeros(
            (batch, table_cols), dtype=torch.int32, device=dev)
        # 0.5 until a chunk draws: a capture before any draw samples from
        # finite numbers
        self.noise = torch.full((n_tokens, batch, cfg.vocab_size), 0.5,
                                dtype=torch.float32, device=dev) \
            if sampled else None
        # the decode launches' split counters, made here, outside every
        # graph: their number depends on the batch and heads, not kv_len
        split_counters(dev, counters_needed(batch, 1, cfg.n_heads,
                                            cfg.n_kv_heads))
        self.graphs: dict = {}     # kv_len -> (graph, outputs, launches)
        if share is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
        else:
            self.pool, self.stream = share.pool, share.stream
        self.capture_s = 0.0       # host seconds in the warm-up and captures

    def load(self, tokens, pos, block_tables=None, generators=None) -> None:
        """Copy a chunk's inputs into the static buffers; draw its noise
        from ``generators`` (a sampled chunk's) into ``noise``."""
        self.tok.copy_(tokens)
        self.pos.copy_(pos)
        if self.tables is not None:
            self.tables.copy_(block_tables)
        if generators is not None and self.noise is not None:
            n, _, vocab = self.noise.shape
            draw_noise(generators, n, vocab, self.device, out=self.noise)

    def _body(self, kv_len: int | None):
        return self.body(self.params, self.cache, self.tok, self.pos,
                         self.noise, kv_len, self.tables)

    def capture(self, kv_len: int | None) -> None:
        """Capture the graph of ``kv_len`` over the buffers' contents.

        Before the first capture the body runs once eagerly on the
        capture's side stream (PyTorch's warm-up: cuBLAS workspaces and
        kernel modules made outside the graph's pool; which kernels run
        does not depend on ``kv_len``, so one warm-up serves every
        bucket). The warm-up writes the KV rows a chunk on the loaded
        inputs writes, which the chunk then writes again; it also steps
        the recurrent state (Mamba, xLSTM) a chunk ahead, so that state
        is copied before it and put back after it. A capture records the
        chunk and runs nothing.
        """
        if kv_len in self.graphs:
            raise RuntimeError(f"kv_len {kv_len} is captured already")
        t0 = time.perf_counter()
        side = self.stream
        if not self.graphs:
            state = M.state_leaves(self.cfg, self.cache)
            saved = [t.clone() for t in state]
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._body(kv_len)
            torch.cuda.current_stream(self.device).wait_stream(side)
            for t, s in zip(state, saved):
                t.copy_(s)
            del saved
        counts = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            out = self._body(kv_len)
        launches = {n: LAUNCHES[n] - c for n, c in counts.items()
                    if LAUNCHES[n] != c}
        LAUNCHES.update(counts)
        self.graphs[kv_len] = (graph, out, launches)
        self.capture_s += time.perf_counter() - t0

    def run(self, kv_len: int | None, tokens, pos, block_tables=None,
            generators=None) -> tuple:
        """One chunk: :meth:`load`, then one replay of ``kv_len``'s graph
        on the current stream. Returns its ``(toks, pos, ok)``: static
        buffers, valid until the next replay."""
        self.load(tokens, pos, block_tables, generators)
        if kv_len not in self.graphs:
            self.capture(kv_len)
        graph, out, launches = self.graphs[kv_len]
        graph.replay()
        for name, n in launches.items():
            LAUNCHES[name] += n
        return out
