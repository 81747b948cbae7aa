"""Serving steps: prefill (build the cache, emit last-token logits only).

The counterpart of ``repro/train/serve.py``. The chunked decode step
lives in ``repro_torch.serve.decode``.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


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
