"""Losses: token cross-entropy in fp32 (counterpart of
``repro/train/losses.py``)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token CE. logits (B, S, V) of any float dtype; targets (B, S)
    integers. The logsumexp and the target gather run in fp32; with a
    mask, the masked mean with its denominator clamped at 1."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
