"""Slot-batched KV cache: preallocated once, updated in place per slot.

The engine's cache is the model cache (``models.model.init_cache``) with
the batch dimension read as **slots**. Leaves under ``"scan"`` are
layer-stacked, their slot axis is 1; ``"tail"`` leaves carry it at 0.
Admitting a request copies one prefilled slot row into every leaf in
place, so the slot cache is never reallocated as the batch changes.
"""

from __future__ import annotations

#: slot (batch) axis of cache leaves per top-level cache part
SLOT_AXIS = {"scan": 1, "tail": 0}


def _pairs(big, small):
    if isinstance(big, dict):
        for key in big:
            yield from _pairs(big[key], small[key])
    else:
        yield big, small


def insert(cache: dict, one: dict, slot: int) -> None:
    """Copy a batch-1 cache ``one`` (same horizon) into slot ``slot``."""
    for part, axis in SLOT_AXIS.items():
        if part in cache:
            for big, small in _pairs(cache[part], one[part]):
                big.narrow(axis, slot, 1).copy_(small)
