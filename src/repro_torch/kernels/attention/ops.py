"""Public attention-kernel wrappers: impl routing and the occupancy bound.

The counterpart of ``repro/kernels/attention/ops.py``. Tiles are explicit
arguments with documented defaults (``bk=128``, ``n_splits`` from
``decode.default_splits``; the paged kernel's block is the page; flash
attention's ``bq``/``bk`` from ``flash``). The JAX package's MemTier
tile tuner, which picks them there, is ported (``kernels/tuning.py``)
and prices these kernels for the planner, but the path keeps the
defaults: on the card the tuner's split count read up to 1.33x slower
than ``default_splits``' (``PERF.md`` §6, PR 24; ROADMAP queue 3).
Each decode router is one kernel launch, and a ``core.trace`` lowering
records it as one (``core.trace.kernel``). ``impl`` follows
``repro_torch.kernels``: ``"ref"`` runs the kernel's plain PyTorch
version, ``"cuda"`` the kernel, ``"auto"`` the kernel on a CUDA tensor
and the plain version on a CPU tensor. The dense oracle
``decode.ref_decode`` (the JAX package's ``ref_decode``) is what tests
hold both against.
"""

from __future__ import annotations

import math

from repro_torch.core.trace import kernel
from repro_torch.kernels.attention import decode as D
from repro_torch.kernels.attention import flash as F


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


@kernel
def flash_decode(q, k, v, pos, *, window=None, impl: str = "auto",
                 bk: int = 128, n_splits: int | None = None,
                 kv_len: int | None = None, k_new=None, v_new=None,
                 store_flavor: str | None = None):
    """Split-KV decode against a fixed-horizon KV cache, impl-routed.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh); ``pos`` scalar or (B,).
    ``kv_len`` is the occupancy bound, the highest cache row any slot can
    touch this step (``max(pos) + Sq``); it is rounded up to the ``bk``
    block grid and clamped to ``Skv``, and rows past it are never read.
    Unlike the JAX router, the cache is not sliced to the bound: the
    kernel takes the bound as an integer, so no copy is made. On a CUDA
    tensor the finished (B, Sq, H, Dh) output in q's dtype comes from one
    kernel launch: the kernel merges its splits itself, where the plain
    version runs ``decode.combine_splits`` after the partials.

    ``k_new``/``v_new`` (B, Sq, Hkv, Dh), the decode step's new rows, are
    written into ``k``/``v`` in place before the attention reads them:
    rows ``pos .. pos + Sq - 1`` of each slot, the start clamped into
    ``[0, Skv - Sq]`` as ``stores.kv_row_update`` clamps it, with
    ``store_flavor``'s stores. On a CUDA tensor the same launch writes
    them; the plain version is ``stores.ref_kv_row_update`` and then the
    plain decode. Without them nothing is written.
    """
    skv = k.shape[1]
    bound = skv if kv_len is None else max(1, min(int(kv_len), skv))
    bk = max(1, min(bk, skv))
    if kv_len is not None:
        bound = min(math.ceil(bound / bk) * bk, skv)
    return D.flash_decode(q, k, v, pos, window=window, bk=bk,
                          n_splits=n_splits, kv_len=bound, impl=impl,
                          k_new=k_new, v_new=v_new, store_flavor=store_flavor)


@kernel
def flash_decode_paged(q, k_pages, v_pages, block_tables, pos, *,
                       window=None, impl: str = "auto",
                       n_splits: int | None = None,
                       kv_len: int | None = None, k_new=None, v_new=None,
                       store_flavor: str | None = None):
    """Paged split-KV decode against a shared page pool, impl-routed.

    q: (B, Sq, H, Dh); ``k_pages``/``v_pages``: (P, page, Hkv, Dh);
    ``block_tables``: (B, NB) int32 (see ``decode.flash_decode_paged``).
    ``kv_len`` bounds occupancy at page granularity: only the first
    ``ceil(kv_len / page)`` table columns are ever read, the paged
    analogue of the dense router's block rounding. It reaches the kernel
    as an integer; the table is not sliced. One kernel launch on a CUDA
    tensor, as :func:`flash_decode`.

    ``k_new``/``v_new`` (B, Sq, Hkv, Dh): row 0 of each slot's new rows is
    written first, in place, to row ``pos % page`` of the page
    ``block_tables[b, min(pos // page, NB - 1)]`` names, ``NB`` the
    table's full width (not the ``kv_len`` cut), as the reference model's
    scatter writes it; on a CUDA tensor in the same launch.
    """
    ps, nb = k_pages.shape[1], block_tables.shape[1]
    if kv_len is not None:
        nb = max(1, min(math.ceil(int(kv_len) / ps), nb))
    return D.flash_decode_paged(q, k_pages, v_pages, block_tables, pos,
                                window=window, n_splits=n_splits,
                                n_blocks=nb, impl=impl, k_new=k_new,
                                v_new=v_new, store_flavor=store_flavor)


#: flash attention forward, impl-routed: q (B, H, S, Dh); k, v (B, Hkv,
#: S, Dh) -> (B, H, S, Dh); ``bq``/``bk`` are the kernel's tiles and any
#: ``S`` works (see ``flash.flash_attention``)
flash_attention = F.flash_attention


def flash_attention_bshd(q, k, v, **kw):
    """(B, S, H, Dh) adapter of :func:`flash_attention`: the kernel reads
    the transposed views through their strides, so nothing is copied."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw)
    return o.transpose(1, 2)
