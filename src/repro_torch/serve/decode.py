"""Chunked decode: ``n`` tokens a call, per-slot positions, greedy or
temperature sampling, and a per-slot non-finite guard.

The counterpart of ``repro/serve/decode.py``. The JAX step runs its
``n`` tokens as one jitted scan; here they are an eager loop whose
tokens, positions and guard flags stay device tensors throughout, so a
chunk makes no host sync: the caller reads the tokens back once, after
the chunk.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def sample(logits: torch.Tensor, temperature: float,
           generators: list | None) -> torch.Tensor:
    """Next token per row of ``logits`` (B, V): greedy or Gumbel-max.

    With ``temperature > 0`` row ``i`` draws its noise from
    ``generators[i]`` alone, so a row's samples depend only on its own
    generator and logits, never on its batchmates.
    """
    if temperature <= 0.0:
        return logits.argmax(-1)
    noise = torch.stack([
        torch.rand(logits.shape[-1], generator=g, device=logits.device)
        for g in generators])
    gumbel = -torch.log(-torch.log(noise))
    return (logits.float() / temperature + gumbel).argmax(-1)


def make_chunked_decode_step(cfg: ModelConfig, n_tokens: int,
                             temperature: float = 0.0, impl: str = "auto",
                             store_flavor: str | None = None,
                             paged: bool = False):
    """Build the n-token decode chunk.

    Returns ``step(params, cache, tokens, pos, generators=None,
    kv_len=None) -> (toks, cache, pos, ok)`` with ``tokens`` (B, 1)
    int64 (each slot's last emitted token), ``pos`` (B,) int32 (each
    slot's write position) and ``generators`` one ``torch.Generator``
    per slot, used only when ``temperature > 0``. ``toks`` is
    (B, n_tokens). ``kv_len`` bounds the cache rows attention reads for
    the whole chunk, so it must cover ``max(pos) + n_tokens`` of every
    slot whose tokens are kept. The cache is updated in place.

    ``ok`` (B,) bool is False for a slot whose logits went non-finite at
    any token of the chunk; such a slot feeds token 0 for the rest of the
    chunk so the next embedding lookup stays in range.

    ``paged=True`` builds the step over a paged cache (``serve.pages``):
    ``step(params, cache, block_tables, tokens, pos, generators=None,
    kv_len=None)``, with ``block_tables`` (B, NB) int32 on the cache's
    device passed to every token of the chunk (``kv_len`` then bounds
    the table columns read).
    """
    if not cfg.embed_inputs:
        raise ValueError("chunked decode needs a token embedding")
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")

    @torch.no_grad()
    def step(params, cache, tokens, pos, generators=None, kv_len=None,
             block_tables=None):
        ok = torch.ones(tokens.shape[0], dtype=torch.bool,
                        device=tokens.device)
        out = []
        tok = tokens
        for _ in range(n_tokens):
            logits, _, cache = M.forward(
                cfg, params, {"tokens": tok}, mode="decode", cache=cache,
                pos=pos, impl=impl, kv_len=kv_len, store_flavor=store_flavor,
                block_tables=block_tables)
            lg = logits[:, 0]
            nxt = sample(lg, temperature, generators)
            ok &= torch.isfinite(lg).all(-1)
            nxt = torch.where(ok, nxt, 0)
            out.append(nxt)
            tok = nxt[:, None]
            pos = pos + 1
        return torch.stack(out, dim=1), cache, pos, ok

    if not paged:
        return step

    def paged_step(params, cache, block_tables, tokens, pos,
                   generators=None, kv_len=None):
        return step(params, cache, tokens, pos, generators, kv_len,
                    block_tables=block_tables)

    return paged_step
