"""Split-KV flash decode (GQA, per-slot positions) over a dense slot cache
or a paged KV pool: the CUDA kernels' wrappers, their plain PyTorch
versions, and the split combine.

The counterpart of ``repro/kernels/attention/decode.py``. The kernels
(``csrc/decode.cu``, one body templated on its row addressing) replace
the Pallas TPU kernels ``decode.py:flash_decode`` (body
``_decode_kernel``) and ``decode.py:flash_decode_paged`` (body
``_paged_decode_kernel``), each with the ``combine_splits`` that ends it
(which XLA fuses into the TPU program): one thread block per (KV head,
split, slot) walks only the live rows of its split — rows past
``pos + Sq - 1``, before the sliding window, or past the occupancy bound
are never read — and writes an fp32 partial softmax state ``(o, m, l)``
per split to scratch; the last block of each (KV head, slot) to finish
merges the splits by log-sum-exp, in split order, and writes the
finished output in q's dtype. So :func:`flash_decode` and
:func:`flash_decode_paged` are one launch a call; :func:`combine_splits`
is the merge's plain version, and :func:`decode_partials` /
:func:`decode_paged_partials` return the partials alone for split-level
checks. On the H100 the kernels are bound by the bytes of the KV rows
they read, so a block issues its K and V rows all at once as
``cp.async`` copies and 8 warps split the keys, each with its own
softmax state. In bf16 the warps run both products on the tensor cores
(exact bf16 products, P kept at fp32 precision) and merge once a split;
fp32 stays on the CUDA cores; see the source. Any number of packed query
rows ``G * Sq`` works: a call of more than ``KERNEL_MAX_ROWS`` runs
groups of that many rows side by side.

Called with the decode step's new rows (``k_new``, ``v_new``), a
finished call first writes them into the cache in place and then
attends, as the step's row write followed by its decode: on a CUDA
tensor in the same launch (the kernel writes the rows, and every block
reading one of them takes it from ``k_new``/``v_new``; its launches count
under ``LAUNCHES["kv_rows_in_decode"]`` too), in the plain version as
``stores.ref_kv_row_update`` (dense) or :func:`stores.ref_paged_row_update`
(paged) before the plain decode.

The cache is taken whole, with explicit strides: the occupancy bound
``kv_len`` is an integer the kernel masks against, so no slice of the
horizon is copied or padded on any layer of any token. The paged kernel
takes the page pools whole as well, with the (B, NB) block table: the
thread that copies a logical row looks up its physical page itself, so
any page size works and no gathered copy of a slot's cache is made.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.machine import get_machine
from repro_torch.kernels import LAUNCHES, build, pos_vector, use_kernel
from repro_torch.kernels import stores

NEG_INF = -1e30

#: streaming multiprocessors of an H100 SXM, from the card's machine file
#: (``core/machine.py``, ``h100``); the default split count makes
#: ``B * Hkv * n_splits`` thread blocks cover them
H100_SMS = get_machine("h100").cores

#: head dims the kernel is built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: packed query rows (G * Sq) a thread block takes; a call with more runs
#: groups of this many side by side, each reading its split's rows
KERNEL_MAX_ROWS = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _I, _I,
                     _I, _I, _I, _I, ctypes.c_float, _P],
    "flash_decode_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I,
                           _L, _L, _L, _L, _I,
                           _I, _I, _I, _I, ctypes.c_float, _P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the split counters of the fused merge, one zeroed int32 tensor per
#: device (see :func:`split_counters`)
_COUNTERS: dict = {}
#: counters tensors a larger one replaced, never freed: a CUDA graph
#: captured over one reads its address at every replay
_RETIRED: list = []


def default_splits(b: int, hkv: int, n_blocks: int) -> int:
    """Fewest splits whose ``b * hkv * n_splits`` blocks cover the SMs.

    The serving path's split count. The tile tuner's
    (``kernels.tuning.decode_tiles`` on ``h100``) was measured against it
    on the card and not taken: at yi-9b's decode shape it picks 8
    splits, 1.126x this count's time (``PERF.md`` §6, PR 24)."""
    return max(1, min(n_blocks, math.ceil(H100_SMS / max(1, b * hkv))))


def split_plan(b: int, hkv: int, skv: int, bk: int, n_splits: int | None,
               kv_len: int | None) -> tuple:
    """``(bound, split_len, n_splits)`` of the TPU kernel's grid.

    Rows ``[0, bound)`` (``bound`` = ``kv_len`` clamped to ``[1, skv]``)
    are cut into ``bk``-row blocks and the blocks into ``n_splits``
    contiguous splits of ``split_len`` rows; ``n_splits=None`` picks
    :func:`default_splits`.
    """
    bound = skv if kv_len is None else max(1, min(int(kv_len), skv))
    bk = max(1, min(bk, bound))
    nb = math.ceil(bound / bk)
    if n_splits is None:
        n_splits = default_splits(b, hkv, nb)
    n_splits = max(1, min(n_splits, nb))
    return bound, math.ceil(nb / n_splits) * bk, n_splits


def ref_decode_partials(q, k, v, pos, *, window, split_len: int,
                        n_splits: int, bound: int):
    """Plain PyTorch version of the kernel: the same per-split partials.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh); pos (B,). Split ``s``
    covers cache rows ``[s*split_len, min((s+1)*split_len, bound))``;
    query token ``j`` of slot ``b`` sees rows ``<= pos[b] + j`` (and
    ``> pos[b] + j - window``). Returns fp32 ``o`` (S, B, Sq, H, Dh)
    unnormalized, ``m`` and ``l`` (S, B, Sq, H); a split with no live row
    carries ``m = -1e30, l = 0, o = 0``.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    dev = q.device
    qf = q.float().reshape(b, sq, hkv, g, dh) * (1.0 / math.sqrt(dh))
    q_pos = pos.to(dev).long().reshape(b, 1) + torch.arange(sq, device=dev)
    o = torch.zeros((n_splits, b, sq, h, dh), dtype=torch.float32, device=dev)
    m = torch.full((n_splits, b, sq, h), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((n_splits, b, sq, h), dtype=torch.float32, device=dev)
    for s in range(n_splits):
        lo, hi = s * split_len, min((s + 1) * split_len, bound)
        if hi <= lo:
            continue
        kf, vf = k[:, lo:hi].float(), v[:, lo:hi].float()
        st = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
        k_pos = torch.arange(lo, hi, device=dev)
        live = k_pos[None, None, :] <= q_pos[..., None]        # (B, Sq, n)
        if window is not None:
            live &= k_pos[None, None, :] > q_pos[..., None] - window
        st = st.masked_fill(~live[:, None, None], -math.inf)
        # rows no query of the slot sees are not read by the kernel: keep
        # whatever they hold (even NaN) out of the value product
        vf = vf.masked_fill(~live.any(1)[:, :, None, None], 0.0)
        mx = st.amax(-1).clamp_min(NEG_INF)                    # (B,Hkv,G,Sq)
        p = torch.exp(st - mx[..., None])                      # masked -> 0
        o[s] = torch.einsum("bhgqk,bkhd->bqhgd", p, vf).reshape(b, sq, h, dh)
        m[s] = mx.permute(0, 3, 1, 2).reshape(b, sq, h)
        l[s] = p.sum(-1).permute(0, 3, 1, 2).reshape(b, sq, h)
    return o, m, l


def _check_kernel_inputs(q, k, v, pos, window) -> None:
    """Raise on anything the CUDA kernels do not take. ``k``/``v`` are
    (B, S, Hkv, Dh) slot caches or (P, page, Hkv, Dh) page pools: either
    way their rows must be contiguous and 16-byte aligned."""
    h, dh = q.shape[2:]
    hkv = k.shape[2]
    for name, x in (("k", k), ("v", v), ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_decode kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    if h % hkv:
        raise ValueError(f"flash_decode kernel takes whole query-head "
                         f"groups a KV head (H={h}, Hkv={hkv})")
    if not q.is_contiguous():
        raise ValueError("flash_decode kernel needs a contiguous q")
    vec = 16 // q.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.shape != k.shape or x.shape[3] != dh:
            raise ValueError(f"{name} shape {tuple(x.shape)} does not match "
                             f"k {tuple(k.shape)} and head_dim {dh}")
        if x.stride(3) != 1 or x.stride(2) != dh \
                or x.stride(0) % vec or x.stride(1) % vec \
                or x.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel needs {name} rows "
                             "contiguous and 16-byte aligned")
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError("pos must be a contiguous int32 (B,) tensor")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _new_rows(k, q, k_new, v_new):
    """The new rows of a fused write as contiguous tensors in the
    cache's dtype, or ``(None, None)`` without them; raises on rows the
    kernel does not take: (B, Sq, Hkv, Dh) beside q (B, Sq, H, Dh) and a
    cache of Hkv heads, on q's device."""
    if not stores.writes_rows(k_new, v_new, None):
        return None, None
    b, sq = q.shape[:2]
    want = (b, sq, k.shape[2], k.shape[3])
    out = []
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != want or x.device != q.device:
            raise ValueError(f"{name} must be a {want} tensor on {q.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
        x = x.to(k.dtype).contiguous()
        if x.data_ptr() % 16 or x.numel() >= 2 ** 31:
            raise ValueError(f"{name} data must start 16-byte aligned and "
                             "hold under 2^31 elements")
        out.append(x)
    return out[0], out[1]


def workspace_layout(n_splits: int, b: int, sq: int, h: int,
                     dh: int) -> tuple:
    """``(floats, m offset, l offset)`` of one call's fp32 partials
    workspace, laid out ``o | m | l``: o (S, B, Sq, H, Dh) from offset 0,
    then m and l, (S, B, Sq, H) each."""
    n_o = n_splits * b * sq * h * dh
    n_m = n_splits * b * sq * h
    return n_o + 2 * n_m, n_o, n_o + n_m


def partials_views(ws, n_splits: int, b: int, sq: int, h: int,
                   dh: int) -> tuple:
    """The ``(o, m, l)`` views of a workspace laid out by
    :func:`workspace_layout`."""
    _, mo, lo = workspace_layout(n_splits, b, sq, h, dh)
    return (ws[:mo].view(n_splits, b, sq, h, dh),
            ws[mo:lo].view(n_splits, b, sq, h),
            ws[lo:].view(n_splits, b, sq, h))


def counters_needed(b: int, sq: int, h: int, hkv: int) -> int:
    """Split counters one finished call of more than one split uses: one
    per (KV head, group of ``KERNEL_MAX_ROWS`` packed rows, slot)."""
    return hkv * math.ceil(h // hkv * sq / KERNEL_MAX_ROWS) * b


def split_counters(device, n: int = 0) -> torch.Tensor:
    """The int32 split counters of the fused merge on ``device``, grown
    to at least ``n``.

    They are zeroed once, when made; the kernel's last block of each
    (KV head, row group, slot) sets its counter back to 0, so calls need
    no memset between them. One tensor serves one stream at a time, as
    the engines use it: calls in flight on two streams at once would
    share counters.

    A tensor handed out stays alive when a larger one replaces it, since
    a CUDA graph may hold its address. Growing them while the stream
    captures a graph raises: the zero fill would be a node of the graph,
    not done now. Size them before a capture (``serve.decode.ChunkGraphs``
    does).
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"split counters grow to {n} under a CUDA-graph capture; "
                f"size them before it (split_counters(device, n))")
        if c is not None:
            _RETIRED.append(c)
        c = _COUNTERS[device] = torch.zeros(max(n, 1), dtype=torch.int32,
                                            device=device)
    return c


def needs_workspace(dtype, dh: int, n_splits: int, finished: bool) -> bool:
    """Whether a launch writes fp32 partials: always but for a finished
    call of one split, which writes its output directly, except in fp32
    at Dh=256, whose body keeps its partials and merges them back even
    then (its registers are full; see ``csrc/decode.cu``)."""
    return (not finished or n_splits > 1
            or (dtype == torch.float32 and dh == 256))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch_buffers(q, hkv: int, n_splits: int, finished: bool) -> tuple:
    """What one launch writes, as ``(workspace, out, pointers)``: the
    partials workspace (:func:`needs_workspace`), the finished output
    (none for the partials alone), and the o, m, l, out and
    split-counter pointers of the C entry points (None for NULL; the
    counters only for a finished call of more than one split)."""
    b, sq, h, dh = q.shape
    ws = out = cnt = None
    o = m = l = None
    if needs_workspace(q.dtype, dh, n_splits, finished):
        n, mo, lo = workspace_layout(n_splits, b, sq, h, dh)
        ws = torch.empty(n, dtype=torch.float32, device=q.device)
        o = ws.data_ptr()
        m, l = o + 4 * mo, o + 4 * lo
    if finished:
        out = torch.empty_like(q)
        if n_splits > 1:
            cnt = split_counters(q.device, counters_needed(b, sq, h, hkv))
    return ws, out, (o, m, l, None if out is None else out.data_ptr(),
                     None if cnt is None else cnt.data_ptr())


def _count(name: str, write) -> None:
    LAUNCHES[name] += 1
    if write is not None:
        LAUNCHES["kv_rows_in_decode"] += 1


def _decode_kernel(q, k, v, pos, *, window, split_len: int, n_splits: int,
                   bound: int, finished: bool, k_new=None, v_new=None,
                   store_flavor=None):
    """One launch of the dense kernel: the finished output, or the
    partials ``(o, m, l)``; with ``k_new``/``v_new``, the rows written into
    the cache first, in the same launch."""
    b, sq, h, dh = q.shape
    _check_kernel_inputs(q, k, v, pos, window)
    if k.shape[0] != b:
        raise ValueError(f"k has {k.shape[0]} slots, q {b}")
    k_new, v_new = _new_rows(k, q, k_new, v_new)
    if k_new is not None and sq > k.shape[1]:
        raise ValueError(f"{sq} new rows do not fit a {k.shape[1]}-row cache")
    nt = stores.executed_flavor(store_flavor) == "nt"
    lib = build.load("decode", _SIGNATURES)
    ws, out, ptrs = _launch_buffers(q, k.shape[2], n_splits, finished)
    rc = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), *ptrs,
        _ptr(k_new), _ptr(v_new), _DTYPE_CODES[q.dtype], b, sq, h,
        k.shape[2], dh, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        k.shape[1], int(nt), n_splits, split_len, bound, window or 0,
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_decode")
    _count("flash_decode", k_new)
    return out if finished else partials_views(ws, n_splits, b, sq, h, dh)


def decode_partials(q, k, v, pos, *, window=None, split_len: int,
                    n_splits: int, bound: int, impl: str = "auto"):
    """Per-split partials ``(o, m, l)`` — the kernel without its merge, or
    its plain version; for split-level checks.

    See :func:`ref_decode_partials` for the contract. ``impl`` routes as
    in ``repro_torch.kernels``: a CUDA tensor reaches the kernel (or
    raises), a CPU tensor the plain version.
    """
    pos = pos_vector(pos, q.shape[0], q.device)
    if not use_kernel(impl, q):
        return ref_decode_partials(q, k, v, pos, window=window,
                                   split_len=split_len, n_splits=n_splits,
                                   bound=bound)
    return _decode_kernel(q, k, v, pos, window=window, split_len=split_len,
                          n_splits=n_splits, bound=bound, finished=False)


def combine_splits(o_part, m_part, l_part) -> torch.Tensor:
    """Merge per-split partial softmax states (flash-decoding combine):
    the plain version of the merge the kernels fuse.

    o_part: (S, B, Sq, H, Dh) unnormalized accumulators; m_part /
    l_part: (S, B, Sq, H). Splits with no live row carry (m=-1e30, l=0)
    and weigh exactly zero. Returns (B, Sq, H, Dh) fp32.
    """
    m_max = m_part.amax(0)
    w = torch.exp(m_part - m_max[None])
    l_tot = (l_part * w).sum(0)
    o = (o_part * w[..., None]).sum(0)
    return o / l_tot.clamp_min(1e-30)[..., None]


def decode_finished(q, k, v, pos, *, window=None, split_len: int,
                    n_splits: int, bound: int, impl: str = "auto",
                    k_new=None, v_new=None, store_flavor=None):
    """The finished (B, Sq, H, Dh) output in q's dtype under an explicit
    split plan: one launch of the kernel (splits merged inside it), or
    the plain partials merged by :func:`combine_splits` and cast.

    With ``k_new``/``v_new`` (B, Sq, Hkv, Dh) the rows are first written
    into ``k``/``v`` in place, as ``stores.kv_row_update`` writes them
    (``store_flavor`` picks the stores): inside the kernel's launch, or by
    ``stores.ref_kv_row_update`` before the plain version."""
    pos = pos_vector(pos, q.shape[0], q.device)
    if not use_kernel(impl, q):
        if stores.writes_rows(k_new, v_new, store_flavor):
            stores.ref_kv_row_update(k, v, k_new, v_new, pos)
        return combine_splits(*ref_decode_partials(
            q, k, v, pos, window=window, split_len=split_len,
            n_splits=n_splits, bound=bound)).to(q.dtype)
    return _decode_kernel(q, k, v, pos, window=window, split_len=split_len,
                          n_splits=n_splits, bound=bound, finished=True,
                          k_new=k_new, v_new=v_new, store_flavor=store_flavor)


def flash_decode(q, k, v, pos, *, window: int | None = None, bk: int = 128,
                 n_splits: int | None = None, kv_len: int | None = None,
                 impl: str = "auto", k_new=None, v_new=None,
                 store_flavor: str | None = None) -> torch.Tensor:
    """Split-KV flash decode against a fixed-horizon KV cache.

    q: (B, Sq, H, Dh), the current decode token(s); k, v: (B, Skv, Hkv,
    Dh) slot caches; ``pos`` the absolute position of the first query
    token, a scalar or (B,). Query token ``j`` attends cache rows
    ``<= pos + j`` (its own key is already in the cache). Only rows
    ``< kv_len`` are ever read (default: the whole horizon).

    The rows are cut into splits by :func:`split_plan`, as the TPU
    kernel's grid cuts them; ``bk=128`` rows a block, which the kernel's
    own tiles (64 rows in bf16, 32 in fp32) divide. Returns (B, Sq, H,
    Dh) in q's dtype: on a CUDA tensor from one kernel launch, which
    merges the splits itself (:func:`decode_finished`), and writes
    ``k_new``/``v_new`` into the cache first when given.
    """
    bound, split_len, n_splits = split_plan(q.shape[0], k.shape[2],
                                            k.shape[1], bk, n_splits, kv_len)
    return decode_finished(q, k, v, pos, window=window, split_len=split_len,
                           n_splits=n_splits, bound=bound, impl=impl,
                           k_new=k_new, v_new=v_new,
                           store_flavor=store_flavor)


def ref_decode(q, k, v, pos, *, window: int | None = None,
               kv_len: int | None = None) -> torch.Tensor:
    """Dense masked-GQA decode oracle (mirror of JAX ``ref_decode``).

    Reads the first ``kv_len`` rows (all with ``None``), softmaxes over
    them in one pass, and, like the JAX oracle, casts the probabilities
    to ``v``'s dtype before the value product.
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    if kv_len is not None:
        skv = max(1, min(int(kv_len), skv))
        k, v = k[:, :skv], v[:, :skv]
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, dh) * (1.0 / math.sqrt(dh))
    st = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    k_pos = torch.arange(skv, device=dev)
    q_pos = pos_vector(pos, b, dev).long()[:, None] \
        + torch.arange(sq, device=dev)[None, :]
    mask = k_pos[None, None, :] <= q_pos[..., None]            # (B, Sq, Skv)
    if window is not None:
        mask &= k_pos[None, None, :] > q_pos[..., None] - window
    st = torch.where(mask[:, None, None], st, NEG_INF)
    p = torch.softmax(st, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged pool
# ---------------------------------------------------------------------------

def paged_split_plan(b: int, hkv: int, page_size: int, n_blocks: int,
                     n_splits: int | None) -> tuple:
    """``(bound, split_len, n_splits)`` of the paged TPU kernel's grid.

    The first ``n_blocks`` table columns (pages) are read, so ``bound =
    n_blocks * page_size`` logical rows; the pages are cut into
    ``n_splits`` contiguous splits of ``ceil(n_blocks / n_splits)`` pages
    each, as the TPU wrapper cuts them (``n_splits`` at most
    ``n_blocks``; ``None`` picks :func:`default_splits`).
    """
    n_blocks = max(1, int(n_blocks))
    if n_splits is None:
        n_splits = default_splits(b, hkv, n_blocks)
    n_splits = max(1, min(n_splits, n_blocks))
    bps = math.ceil(n_blocks / n_splits)
    return n_blocks * page_size, bps * page_size, n_splits


def gather_pages(pages, block_tables, n_blocks: int | None = None):
    """A slot cache (B, n_blocks * page, Hkv, Dh) from a page pool (P,
    page, Hkv, Dh): each slot's first ``n_blocks`` logical pages (all
    columns with ``None``) in logical order, table entries clipped into
    ``[0, P - 1]`` as the kernel clips them."""
    bt = block_tables[:, :n_blocks].long().clamp(0, pages.shape[0] - 1)
    return pages[bt].reshape(bt.shape[0], -1, *pages.shape[2:])


def ref_decode_paged_partials(q, k_pages, v_pages, block_tables, pos, *,
                              window, split_len: int, n_splits: int,
                              bound: int):
    """Plain PyTorch version of the paged kernel: the same per-split
    partials. The first ``bound / page`` pages of each slot are gathered
    in logical order and go through :func:`ref_decode_partials` with the
    kernel's split boundaries, in logical rows."""
    nb = bound // k_pages.shape[1]
    k = gather_pages(k_pages, block_tables, nb)
    v = gather_pages(v_pages, block_tables, nb)
    return ref_decode_partials(q, k, v, pos, window=window,
                               split_len=split_len, n_splits=n_splits,
                               bound=bound)


def _check_page_bound(bound: int, ps: int, block_tables) -> None:
    if bound % ps or bound > block_tables.shape[1] * ps:
        raise ValueError(f"bound {bound} is not a whole number of pages "
                         f"within the table ({block_tables.shape[1]} x {ps})")


def _decode_paged_kernel(q, k_pages, v_pages, block_tables, pos, *, window,
                         split_len: int, n_splits: int, bound: int,
                         finished: bool, k_new=None, v_new=None,
                         store_flavor=None):
    """One launch of the paged kernel: the finished output, or the
    partials ``(o, m, l)``; with ``k_new``/``v_new``, row 0 of each slot's
    new rows written into its page first, in the same launch."""
    b, sq, h, dh = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[1]
    _check_kernel_inputs(q, k_pages, v_pages, pos, window)
    if block_tables.device != q.device or block_tables.dtype != torch.int32 \
            or block_tables.shape[0] != b or block_tables.stride(1) != 1:
        raise ValueError("block_tables must be a (B, NB) int32 tensor on "
                         f"{q.device} with contiguous rows")
    k_new, v_new = _new_rows(k_pages, q, k_new, v_new)
    nt = stores.executed_flavor(store_flavor) == "nt"
    lib = build.load("decode", _SIGNATURES)
    ws, out, ptrs = _launch_buffers(q, k_pages.shape[2], n_splits,
                                    finished)
    rc = lib.flash_decode_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), *ptrs,
        _ptr(k_new), _ptr(v_new), _DTYPE_CODES[q.dtype], b, sq, h,
        k_pages.shape[2], dh, block_tables.stride(0), block_tables.shape[1],
        n_pages, ps, k_pages.stride(0), k_pages.stride(1),
        v_pages.stride(0), v_pages.stride(1), int(nt),
        n_splits, split_len, bound, window or 0, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_decode_paged")
    _count("flash_decode_paged", k_new)
    return out if finished else partials_views(ws, n_splits, b, sq, h, dh)


def decode_paged_partials(q, k_pages, v_pages, block_tables, pos, *,
                          window=None, split_len: int, n_splits: int,
                          bound: int, impl: str = "auto"):
    """Per-split partials ``(o, m, l)`` over a page pool: the paged
    kernel without its merge, or its plain version
    (:func:`ref_decode_paged_partials`); for split-level checks.

    ``bound`` is a whole number of pages, at most the table's columns
    times the page size; no table column past it is read. ``impl``
    routes as in ``repro_torch.kernels``.
    """
    _check_page_bound(bound, k_pages.shape[1], block_tables)
    pos = pos_vector(pos, q.shape[0], q.device)
    kw = dict(window=window, split_len=split_len, n_splits=n_splits,
              bound=bound)
    if not use_kernel(impl, q):
        return ref_decode_paged_partials(q, k_pages, v_pages, block_tables,
                                         pos, **kw)
    return _decode_paged_kernel(q, k_pages, v_pages, block_tables, pos,
                                finished=False, **kw)


def decode_paged_finished(q, k_pages, v_pages, block_tables, pos, *,
                          window=None, split_len: int, n_splits: int,
                          bound: int, impl: str = "auto", k_new=None,
                          v_new=None, store_flavor=None):
    """The finished (B, Sq, H, Dh) output in q's dtype over a page pool
    under an explicit split plan: one launch of the paged kernel, or the
    plain partials merged by :func:`combine_splits` and cast.

    With ``k_new``/``v_new`` (B, Sq, Hkv, Dh), row 0 of each slot's new
    rows is first written in place at its position, as the reference
    model's scatter writes it (:func:`stores.ref_paged_row_update`, which
    is also the plain version): inside the kernel's launch on a CUDA
    tensor. The kernel's output equals the write followed by the read only
    if no physical row it writes is read in the same launch through
    another table column of any slot; the scratch page that every column
    of a free slot names breaks this, so a free slot's output is undefined
    there. At a negative position both wrap to the table's last columns,
    as the reference's scatter does: row ``pos % page`` of column
    ``pos // page + NB`` (the kernel clips to column 0 below ``-NB *
    page``, where the plain version's index raises)."""
    _check_page_bound(bound, k_pages.shape[1], block_tables)
    pos = pos_vector(pos, q.shape[0], q.device)
    kw = dict(window=window, split_len=split_len, n_splits=n_splits,
              bound=bound)
    if not use_kernel(impl, q):
        if stores.writes_rows(k_new, v_new, store_flavor):
            stores.ref_paged_row_update(k_pages, v_pages, block_tables,
                                        k_new, v_new, pos)
        return combine_splits(*ref_decode_paged_partials(
            q, k_pages, v_pages, block_tables, pos, **kw)).to(q.dtype)
    return _decode_paged_kernel(q, k_pages, v_pages, block_tables, pos,
                                finished=True, k_new=k_new, v_new=v_new,
                                store_flavor=store_flavor, **kw)


def flash_decode_paged(q, k_pages, v_pages, block_tables, pos, *,
                       window: int | None = None,
                       n_splits: int | None = None,
                       n_blocks: int | None = None,
                       impl: str = "auto", k_new=None, v_new=None,
                       store_flavor: str | None = None) -> torch.Tensor:
    """Split-KV flash decode against a paged KV pool.

    q: (B, Sq, H, Dh); ``k_pages``/``v_pages``: (P, page, Hkv, Dh)
    physical page pools shared by every slot; ``block_tables``: (B, NB)
    int32 mapping each slot's logical page ``i`` (cache rows ``i*page ..
    (i+1)*page-1``) to a physical page. Only the first ``n_blocks``
    columns (all with ``None``) are read, and of those only the pages
    holding rows the slot can see: columns past ``pos`` may hold any
    page id. Entries are clipped into ``[0, P - 1]``. Returns (B, Sq, H,
    Dh) in q's dtype: on a CUDA tensor from one kernel launch
    (:func:`decode_paged_finished`), which writes ``k_new``/``v_new`` first
    when given; the written column is counted over the table's full width,
    not ``n_blocks``.
    """
    n_blocks = block_tables.shape[1] if n_blocks is None else n_blocks
    bound, split_len, n_splits = paged_split_plan(
        q.shape[0], k_pages.shape[2], k_pages.shape[1], n_blocks, n_splits)
    return decode_paged_finished(q, k_pages, v_pages, block_tables, pos,
                                 window=window, split_len=split_len,
                                 n_splits=n_splits, bound=bound, impl=impl,
                                 k_new=k_new, v_new=v_new,
                                 store_flavor=store_flavor)


def ref_decode_paged(q, k_pages, v_pages, block_tables, pos, *,
                     window: int | None = None) -> torch.Tensor:
    """Dense paged oracle (mirror of JAX ``ref_decode_paged``): gather
    each slot's pages in logical order and run :func:`ref_decode`."""
    return ref_decode(q, gather_pages(k_pages, block_tables),
                      gather_pages(v_pages, block_tables), pos,
                      window=window)
