"""Public attention-kernel wrappers: impl routing and the occupancy bound.

The counterpart of ``repro/kernels/attention/ops.py``. Tiles are explicit
arguments with documented defaults (``bk=128``, ``n_splits`` from
``decode.default_splits``); the MemTier autotuner that picks them in the
JAX package is not ported yet. ``impl`` follows ``repro_torch.kernels``:
``"ref"`` runs the kernel's plain PyTorch version, ``"cuda"`` the
kernel, ``"auto"`` the kernel on a CUDA tensor and the plain version on
a CPU tensor. The dense oracle ``decode.ref_decode`` (the JAX package's
``ref_decode``) is what tests hold both against.
"""

from __future__ import annotations

import math

from repro_torch.kernels.attention import decode as D


def validate_tp_heads(h: int, hkv: int, dh: int, tp: int, *,
                      page_size: int | None = None) -> int:
    """Check the decode kernels shard cleanly over ``tp`` TP shards.

    Each shard must own a whole number of KV heads, the query heads must
    follow their KV groups, and the per-shard head tile must be
    non-empty. ``page_size`` only names the paged kernel in the message.
    Returns the per-shard KV head count; raises ``ValueError`` otherwise.
    """
    tp = max(1, int(tp))
    what = "paged " if page_size is not None else ""
    if hkv % tp != 0:
        raise ValueError(
            f"{what}decode cannot shard {hkv} KV heads over TP={tp}: "
            "kvheads must divide the TP degree (pad heads or shrink "
            "the model mesh axis)")
    if h % tp != 0:
        raise ValueError(
            f"{what}decode cannot shard {h} query heads over TP={tp}: "
            "GQA groups must stay whole per shard")
    hkv_shard = hkv // tp
    g = h // hkv
    if hkv_shard * g < 1 or dh < 1:
        raise ValueError(
            f"{what}decode: empty per-shard head tile "
            f"(hkv/tp={hkv_shard}, G={g}, Dh={dh})")
    return hkv_shard


def flash_decode(q, k, v, pos, *, window=None, impl: str = "auto",
                 bk: int = 128, n_splits: int | None = None,
                 kv_len: int | None = None):
    """Split-KV decode against a fixed-horizon KV cache, impl-routed.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh); ``pos`` scalar or (B,).
    ``kv_len`` is the occupancy bound, the highest cache row any slot can
    touch this step (``max(pos) + Sq``); it is rounded up to the ``bk``
    block grid and clamped to ``Skv``, and rows past it are never read.
    Unlike the JAX router, the cache is not sliced to the bound: the
    kernel takes the bound as an integer, so no copy is made.
    """
    skv = k.shape[1]
    bound = skv if kv_len is None else max(1, min(int(kv_len), skv))
    bk = max(1, min(bk, skv))
    if kv_len is not None:
        bound = min(math.ceil(bound / bk) * bk, skv)
    return D.flash_decode(q, k, v, pos, window=window, bk=bk,
                          n_splits=n_splits, kv_len=bound, impl=impl)
