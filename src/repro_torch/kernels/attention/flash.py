"""Causal (optionally windowed) GQA flash attention forward: the CUDA
kernel's wrapper.

The counterpart of ``repro/kernels/attention/flash.py``. The kernel
(``csrc/flash.cu``) replaces the Pallas TPU kernel
``flash.py:flash_attention`` (body ``_flash_kernel``): one thread block
per (query tile, KV head, batch row) packs the ``G = H / Hkv`` query
heads of its KV head, so each K/V tile is read once for all of them,
keeps the online-softmax state and the accumulator in fp32, and visits
only the key tiles the causal mask and the window leave live. Its plain
version is ``ref.attention``. On the H100 the kernel is bound by
operations (989 TFLOP/s in bf16: 34.76 us at yi-9b's heads, B=1,
S=2048, causal). The bf16 body is warp-specialised for Hopper: a
producer warpgroup keeps K and V tiles in flight by TMA into two stages
each, completing on mbarriers, and two consumer warpgroups of 64 packed
rows run both products as ``wgmma`` (S = Q K^T from shared memory, O +=
P V with P, in bf16, as the register operand), fp32 accumulators, the
softmax of one tile overlapping the value products of the one before.
The wrapper plans the blocks (:func:`block_plan`): the longest query
tiles run as two blocks of half their keys, merged by log-sum-exp, and
blocks go out longest first. fp32 inputs keep a scalar fp32 body, since
the tensor cores would round them to TF32 (see the source).

Unlike the TPU kernel, any ``S`` works: the kernel masks its ragged
query and key tiles itself, where the TPU wrapper asserts
``S % bq == 0``. The tiles are explicit arguments: ``bq`` query
positions per block (``bq * G`` packed rows, at most 128; by default as
many as fit) and ``bk`` keys per tile: 32 or 64 in fp32 (64 by default,
32 at Dh=256, whose 64-key tile does not fit shared memory), 32, 64 or
128 in bf16 (128 by default, 64 at Dh=256). Head dims 32, 64, 128 and
256. The MemTier autotuner that picks
the tiles in the JAX package is not ported.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math

import torch

from repro_torch.kernels import LAUNCHES, build, use_kernel
from repro_torch.kernels.attention import ref as R

#: head dims, key tiles and packed query rows the kernel is built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
KERNEL_KEY_TILES = (32, 64, 128)
KERNEL_MAX_ROWS = 128
#: dynamic shared memory a block may use on the H100
SHARED_MEMORY_LIMIT = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                            _I, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P,
                            _P],
    "flash_split_floats": [_I],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the split tiles' flags, one zeroed int32 tensor per device, grown as
#: needed; the kernel leaves them zero (see :func:`split_flags`)
_FLAGS: dict = {}
#: streaming multiprocessors of each device
_SMS: dict = {}


def default_bq(h: int, hkv: int) -> int:
    """Query positions per block: as many as fill 128 packed rows."""
    return max(1, KERNEL_MAX_ROWS // (h // hkv))


def default_bk(dtype, dh: int) -> int:
    """Keys per tile, the largest the body is built for: fp32 64 (32 at
    Dh=256, where its 64-key tile does not fit shared memory); bf16 128
    (64 at Dh=256, where four 128-key tiles do not fit)."""
    if dtype == torch.float32:
        return 32 if dh > 128 else 64
    return 64 if dh > 128 else 128


def shared_memory_bytes(dtype, dh: int, bk: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/flash.cu`` sizes it.

    fp32 (``smem_floats``): 128 query rows and a K tile of Dh + 4 floats,
    a V tile of Dh, 128 score rows of bk + 4, and m, l, alpha. bf16
    (``Bf16Geom``): 128 query rows and two K and two V stages of bk rows,
    Dh bf16 each, 128 bytes of barriers and 1024 of alignment slack.
    """
    rows = KERNEL_MAX_ROWS
    if dtype == torch.float32:
        return 4 * (rows * (dh + 4) + bk * (dh + 4) + bk * dh
                    + rows * (bk + 4) + 3 * rows)
    return 2 * rows * dh + 4 * 2 * bk * dh + 128 + 1024


def key_tiles(s: int, bq: int, bk: int, causal: bool,
              window: int | None) -> list:
    """Key tiles of ``bk`` keys that each query tile of ``bq`` positions
    visits, as ``csrc/flash.cu`` counts them: keys from ``max(0, q0 -
    window + 1)`` to the tile's last position (causal) or to ``S``."""
    out = []
    for q0 in range(0, s, bq):
        k_end = min(q0 + bq, s) if causal else s
        k_first = max(0, q0 - window + 1) if window else 0
        out.append(-(-(k_end - k_first) // bk))
    return out


#: a block's cost beyond its key tiles, in key tiles: the query rows'
#: load, the first scores, the epilogue; a split half's merge on top (its
#: partial's round trip through L2 and the wait for the other half: 2.0
#: puts the split point where a sweep of it on the H100 reads fastest at
#: gemma3-4b's heads, and splits none of yi-9b's)
BLOCK_OVERHEAD_TILES = 1.0
MERGE_OVERHEAD_TILES = 2.0


def _makespan(costs, per: int, sms: int) -> float:
    """When the last SM finishes, each block of ``costs`` (``per`` blocks
    a cost, in launch order) going to the SM that frees first."""
    free = [0.0] * sms
    for c in costs:
        for _ in range(per):
            heapq.heapreplace(free, free[0] + c)
    return max(free)


@functools.lru_cache(maxsize=256)
def block_plan(s: int, bq: int, bk: int, causal: bool, window: int | None,
               per: int, sms: int) -> tuple:
    """``(qs, order)`` of the bf16 body's blocks.

    The query tiles from ``qs`` on run as two blocks of half their key
    tiles each (merged by log-sum-exp), the others as one block. ``order``
    lists the launch groups, each ``per`` blocks (the KV heads and batch
    rows of one query tile or half), as ``qt * 3 + half + 1`` (half -1 for
    a whole tile), longest first: the block scheduler hands blocks to the
    SMs that free first in that order. ``qs`` is the split point whose
    order finishes first when so handed out (modelled: a block costs its
    key tiles plus ``BLOCK_OVERHEAD_TILES``, a half ``MERGE_OVERHEAD_TILES``
    more) by more than 3 %, among those whose split tiles all have at
    least 4 key tiles and more than half an SM's share of the call's;
    ``ceil(S / bq)`` splits none.
    """
    tiles = key_tiles(s, bq, bk, causal, window)
    share = per * sum(tiles) / sms

    def groups(qs):
        g = [(t + BLOCK_OVERHEAD_TILES, qt, -1)
             for qt, t in enumerate(tiles[:qs])]
        for qt, t in enumerate(tiles[qs:], qs):
            g += [(t // 2 + BLOCK_OVERHEAD_TILES + MERGE_OVERHEAD_TILES, qt, 0),
                  (t - t // 2 + BLOCK_OVERHEAD_TILES + MERGE_OVERHEAD_TILES,
                   qt, 1)]
        return sorted(g, key=lambda x: (-x[0], -x[1], x[2]))

    n_qt = len(tiles)
    best = n_qt
    best_time = _makespan([c for c, _, _ in groups(n_qt)], per, sms)
    qs = n_qt
    while qs > 0 and tiles[qs - 1] >= 4 and tiles[qs - 1] > share / 2 \
            and min(tiles[qs - 1:]) >= 4:
        qs -= 1
        t = _makespan([c for c, _, _ in groups(qs)], per, sms)
        if t < 0.97 * best_time:
            best, best_time = qs, t
    return best, tuple(qt * 3 + half + 1 for _, qt, half in groups(best))


@functools.lru_cache(maxsize=256)
def block_order(device, s: int, bq: int, bk: int, causal: bool,
                window: int | None, per: int) -> tuple:
    """``(qs, order)`` of :func:`block_plan` for ``device``'s SMs, the
    order as an int32 tensor on the device, made once a shape."""
    qs, order = block_plan(s, bq, bk, causal, window, per, sm_count(device))
    return qs, torch.tensor(order, dtype=torch.int32, device=device)


def split_flags(device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 flags on ``device``: 4 a split tile
    (arrivals and published, a consumer warpgroup each). The kernel sets
    what it used back to 0, so calls on one stream share them."""
    f = _FLAGS.get(device)
    if f is None or f.numel() < n:
        f = _FLAGS[device] = torch.zeros(max(n, 1), dtype=torch.int32,
                                         device=device)
    return f


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check_kernel_inputs(q, k, v, bq, bk, window) -> None:
    """Raise on anything the CUDA kernel does not take."""
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.shape != (b, hkv, s, dh):
            raise ValueError(f"{name} shape {tuple(x.shape)} does not match "
                             f"(B, Hkv, S, Dh) = {(b, hkv, s, dh)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    if h % hkv or bq < 1 or bq * (h // hkv) > KERNEL_MAX_ROWS:
        raise ValueError(f"flash_attention kernel packs at most "
                         f"{KERNEL_MAX_ROWS} query rows a block "
                         f"(H={h}, Hkv={hkv}, bq={bq})")
    if bk not in KERNEL_KEY_TILES or bk > default_bk(q.dtype, dh):
        raise ValueError(f"flash_attention kernel takes bk in "
                         f"{KERNEL_KEY_TILES} (at most "
                         f"{default_bk(q.dtype, dh)} for {q.dtype} at "
                         f"head_dim {dh}), got {bk}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(x.stride(i) % vec for i in range(3)) \
                or x.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} rows "
                             "contiguous and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, bq: int | None = None,
                    bk: int | None = None,
                    impl: str = "auto") -> torch.Tensor:
    """Flash attention forward: q (B, H, S, Dh); k, v (B, Hkv, S, Dh) ->
    (B, H, S, Dh) in q's dtype, contiguous.

    Query ``i`` attends keys ``<= i`` (``causal``) and ``> i - window``
    (``window``). ``impl`` routes as in ``repro_torch.kernels``: the
    kernel on a CUDA tensor, :func:`ref.attention` on a CPU tensor. The
    inputs may be strided views (rows of Dh elements contiguous).
    """
    if not use_kernel(impl, q):
        return R.attention(q, k, v, causal=causal, window=window)
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    bq = default_bq(h, hkv) if bq is None else bq
    bk = default_bk(q.dtype, dh) if bk is None else bk
    _check_kernel_inputs(q, k, v, bq, bk, window)
    lib = build.load("flash", _SIGNATURES)
    o = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v)
                                        for i in range(3)))
    n_qt = -(-s // bq)
    qs, order, part, flags = n_qt, None, None, None
    if q.dtype == torch.bfloat16:
        qs, order = block_order(q.device, s, bq, bk, causal, window, hkv * b)
    if qs < n_qt:
        pairs = (n_qt - qs) * hkv * b
        part = torch.empty(pairs * lib.flash_split_floats(dh),
                           dtype=torch.float32, device=q.device)
        flags = split_flags(q.device, 4 * pairs)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, hkv, s, dh, strides, bq, bk,
        int(causal), window or 0, 1.0 / math.sqrt(dh), qs,
        None if order is None else order.data_ptr(),
        None if part is None else part.data_ptr(),
        None if flags is None else flags.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
