"""Losses: token cross-entropy in fp32 (counterpart of
``repro/train/losses.py``)."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.utils.sharding import (as_replicated, reduce_partials,
                                        shard_offset, sum_over)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token CE. logits (B, S, V) of any float dtype; targets (B, S)
    integers. The logsumexp and the target gather run in fp32; with a
    mask, the masked mean with its denominator clamped at 1. Logits that
    are a DTensor sharded on the vocab are not gathered
    (:func:`_vocab_sharded`)."""
    lg = logits.float()
    if _vocab_dims(lg):
        lse, tgt = _vocab_sharded(lg, targets)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    # a DTensor's sums over sharded rows come back whole, their gradient
    # too (``sharding.reduce_partials``); anything else passes through
    if mask is not None:
        m = mask.float()
        return reduce_partials((nll * m).sum()) \
            / reduce_partials(m.sum()).clamp_min(1.0)
    return reduce_partials(nll.mean())


def _vocab_dims(lg) -> list:
    """The mesh dims that shard a DTensor's last (vocab) dim."""
    if not isinstance(lg, DTensor):
        return []
    last = lg.ndim - 1
    return [m for m, p in enumerate(lg.placements)
            if p.is_shard() and p.dim in (last, -1)]


def _vocab_sharded(lg, targets) -> tuple:
    """``(logsumexp, target logit)`` of vocab-sharded fp32 logits, the
    vocab-parallel way: the max and the sum of exponentials are reduced
    over the vocab shards (an all-reduce each), and each rank picks the
    targets its shard holds, zero elsewhere, summed over the shards by a
    third (``sharding.sum_over``: the gradient comes back whole)."""
    mesh, pl = lg.device_mesh, tuple(lg.placements)
    m = lg.detach().amax(-1, keepdim=True)
    lse = (lg - m).exp().sum(-1).log() + m[..., 0]
    off, n = shard_offset(mesh, pl, lg.ndim - 1, lg.shape[-1])
    vocab = _vocab_dims(lg)
    groups = [mesh.get_group(i) for i in vocab]

    def pick(lg, t):
        t = t.long() - off
        ok = (t >= 0) & (t < n)
        got = torch.gather(lg, -1, t.clamp(0, n - 1)[..., None])[..., 0]
        got = torch.where(ok, got, torch.zeros((), dtype=lg.dtype,
                                               device=lg.device))
        return sum_over(got, groups)
    tgt_pl = tuple(Replicate() if i in vocab else p
                   for i, p in enumerate(pl))
    tgt = as_replicated(targets, mesh).redistribute(mesh, tgt_pl)
    return lse, local_map(pick, out_placements=list(tgt_pl),
                          in_placements=(pl, tgt_pl),
                          device_mesh=mesh)(lg, tgt)
