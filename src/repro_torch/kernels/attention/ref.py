"""Plain PyTorch oracle of the flash-attention kernel: exact masked softmax
attention in (B, H, S, Dh) layout, dense (it materializes the (S, S)
scores). The counterpart of ``repro/kernels/attention/ref.py``."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """q: (B, H, S, Dh); k, v: (B, Hkv, S, Dh) -> (B, H, S, Dh).

    Scores, softmax and the value product are fp32; the output is cast
    to q's dtype once, as in the JAX oracle.
    """
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, s, dh) * (1.0 / math.sqrt(dh))
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float())
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, s, dh).to(q.dtype)
