"""Serving steps: prefill (build the cache, emit last-token logits only),
single-token decode, and the multi-token greedy decode loop.

The counterpart of ``repro/train/serve.py``. The chunked decode step the
loop wraps lives in ``repro_torch.serve.decode``.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import pos_vector
from repro_torch.models import model as M
from repro_torch.models.model import count_params


def serve_uses_fsdp(cfg: ModelConfig, tp: int = 16,
                    hbm_budget: float = 10e9) -> bool:
    """Pure-TP weights only when they fit a chip's HBM with headroom (the
    reference's rule, copied with its budget: 10 GB is a TPU v5e's 16 GB
    less headroom, not an H100's 80 GB; the dry run's records keep the
    reference's rules tables by it)."""
    return count_params(cfg) * 2 / tp > hbm_budget


def make_prefill_step(cfg: ModelConfig, cache_len: int | None = None,
                      store_flavor: str | None = None):
    """Prefill step: ``(params, batch) -> (last-token logits, cache)``.

    ``cache_len`` preallocates the KV buffers at the full decode horizon,
    so the serve engine's slot caches are built once here. ``batch`` is
    ``{"tokens": (B, S) integer tensor}``.
    """
    def prefill(params, batch):
        logits, _, cache = M.forward(cfg, params, batch, mode="prefill",
                                     cache_len=cache_len,
                                     store_flavor=store_flavor)
        return logits, cache
    return prefill


def make_decode_step(cfg: ModelConfig):
    """Single-token decode step: ``(params, cache, batch, pos) -> (logits,
    cache)``, logits (B, V).

    ``pos`` may be a scalar (whole batch at one position) or a (B,) vector
    (per-slot positions, continuous batching). The step's KV rows are
    written into ``cache``'s tensors in place; the cache returned holds
    the same tensors.
    """
    def decode(params, cache, batch, pos):
        logits, _, cache = M.forward(cfg, params, batch, mode="decode",
                                     cache=cache, pos=pos)
        return logits[:, 0], cache
    return decode


def _leaves(tree: dict):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def _tensors_key(*trees) -> tuple:
    """What a captured graph holds of ``trees``: each tensor's address,
    shape and strides."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride())
                 for tree in trees for t in _leaves(tree))


class _DecodeLoop:
    """The loop :func:`make_decode_loop_step` returns. ``graphs`` is the
    one ``ChunkGraphs`` it holds on the card (None before the first CUDA
    call), over the parameter and cache tensors of its last call."""

    def __init__(self, cfg: ModelConfig, n_tokens: int):
        from repro_torch.serve.decode import make_chunk_body
        self.cfg, self.n_tokens = cfg, n_tokens
        self.body = make_chunk_body(cfg, n_tokens)
        self.graphs = None
        self._key = None

    def __call__(self, params, cache, batch, pos):
        from repro_torch.serve.decode import ChunkGraphs
        tokens = batch["tokens"]
        if tokens.device.type != "cuda":
            toks, _, _ = self.body(params, cache, tokens, pos)
            return toks, cache
        b = tokens.shape[0]
        key = (b, _tensors_key(params, cache))
        if key != self._key:
            # drop the old graph (and its hold on the old tensors) first
            self.graphs = self._key = None
            self.graphs = ChunkGraphs(self.body, self.cfg, params, cache,
                                      batch=b, n_tokens=self.n_tokens,
                                      sampled=False, device=tokens.device)
            self._key = key
        toks, _, _ = self.graphs.run(
            None, tokens, pos_vector(pos, b, tokens.device))
        return toks.clone(), cache


def make_decode_loop_step(cfg: ModelConfig, n_tokens: int):
    """Multi-token greedy decode: ``(params, cache, batch, pos) -> (toks,
    cache)``, toks (B, n_tokens). Token-id models only.

    Thin greedy wrapper over the chunked decode step
    (``repro_torch.serve.decode``) at the full horizon. On a CPU tensor
    the chunk runs eagerly; on a CUDA tensor it is one CUDA-graph replay
    (``serve.decode.ChunkGraphs``). The loop holds one graph, over the
    parameter and cache tensors of the call that captured it: a call on
    other tensors (or another batch size) drops it and captures anew, so
    a loop kept over one cache replays and a loop handed a fresh cache
    each time captures each time. ``toks`` is the loop's own tensor; the
    cache is updated in place.
    """
    return _DecodeLoop(cfg, n_tokens)
