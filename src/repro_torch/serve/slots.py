"""Slot-batched KV cache: preallocated once, updated in place per slot.

The engine's cache is the model cache (``models.model.init_cache``) with
the batch dimension read as **slots**. Leaves under ``"scan"`` are
layer-stacked, their slot axis is 1; ``"tail"`` leaves carry it at 0.
Admitting a request copies one prefilled slot row into every leaf in
place, so the slot cache is never reallocated as the batch changes.
"""

from __future__ import annotations

from repro_torch.utils.sharding import is_dtensor, shard_owner

#: slot (batch) axis of cache leaves per top-level cache part
SLOT_AXIS = {"scan": 1, "tail": 0}


def _pairs(big, small):
    if isinstance(big, dict):
        for key in big:
            yield from _pairs(big[key], small[key])
    else:
        yield big, small


def _shards(big, small, axis: int):
    """Under a mesh, this rank's shards of a cache leaf and of the leaf
    landing in it, which must agree on every dim but the slot axis (the
    prefill makes its cache on the engine's layout)."""
    from torch.distributed.tensor import Replicate
    norm = [Replicate() if p.is_shard() and p.dim == axis else p
            for p in big.placements]
    if [Replicate() if p.is_shard() and p.dim == axis else p
            for p in small.placements] != norm:
        raise ValueError(f"cache leaf on {big.placements}, the prefill's "
                         f"on {small.placements}")
    return big.to_local(), small.to_local()


def insert(cache: dict, one: dict, slot: int) -> None:
    """Copy a batch-1 cache ``one`` (same horizon) into slot ``slot``.

    Under a mesh (DTensor leaves) each rank writes its own shard in
    place, and only the ranks whose shard holds the slot write."""
    for part, axis in SLOT_AXIS.items():
        if part in cache:
            for big, small in _pairs(cache[part], one[part]):
                insert_leaf(big, small, axis, slot)


def insert_leaf(big, small, axis: int, slot: int) -> None:
    """Copy ``small`` (one slot on ``axis``) into slot ``slot`` of the
    cache leaf ``big``, in place; under a mesh only the ranks whose
    shard holds the slot write."""
    at = slot
    if is_dtensor(big):
        at = shard_owner(big.device_mesh, big.placements, axis,
                         big.shape[axis], slot)
        if at is None:
            return
        big, small = _shards(big, small, axis)
    big.narrow(axis, at, 1).copy_(small)


def copy_slot(big, axis: int, src: int, dst: int) -> None:
    """Copy slot ``src`` of a cache leaf to slot ``dst``, in place. Under
    a mesh whose ranks shard the slots the leaf is gathered over the slot
    shards (``sharding.relayout``, every rank takes part) and the rank
    holding ``dst`` writes it."""
    if not is_dtensor(big):
        big.select(axis, dst).copy_(big.select(axis, src))
        return
    from torch.distributed.tensor import Replicate
    from repro_torch.utils.sharding import relayout
    pl = tuple(big.placements)
    whole = tuple(Replicate() if p.is_shard() and p.dim == axis else p
                  for p in pl)
    row = relayout(big, whole).to_local().select(axis, src)
    at = shard_owner(big.device_mesh, pl, axis, big.shape[axis], dst)
    if at is not None:
        big.to_local().select(axis, at).copy_(row)


def assign(cache: dict, new: dict) -> None:
    """Copy a whole cache ``new`` of the same shapes into ``cache``, in
    place (a batched prefill lands here, so the cache tensors that a
    captured decode graph reads stay the same). Under a mesh each rank
    copies its shard."""
    for big, small in _pairs(cache, new):
        if is_dtensor(big):
            if tuple(small.placements) != tuple(big.placements):
                small = small.redistribute(big.device_mesh, big.placements)
            big, small = big.to_local(), small.to_local()
        big.copy_(small)
