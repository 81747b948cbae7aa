"""Split-KV flash decode (GQA, per-slot positions) over a dense slot cache
or a paged KV pool: the CUDA kernels' wrappers, their plain PyTorch
versions, and the split combine.

The counterpart of ``repro/kernels/attention/decode.py``. The kernels
(``csrc/decode.cu``, one body templated on its row addressing) replace
the Pallas TPU kernels ``decode.py:flash_decode`` (body
``_decode_kernel``) and ``decode.py:flash_decode_paged`` (body
``_paged_decode_kernel``): one thread block per (KV head, split, slot)
walks only the live rows of its split — rows past ``pos + Sq - 1``,
before the sliding window, or past the occupancy bound are never read —
and writes an fp32 partial softmax state ``(o, m, l)`` per split.
:func:`combine_splits` merges the partials by log-sum-exp. On the H100
the kernels are bound by the bytes of the KV rows they read, so a block
issues its K and V rows all at once as ``cp.async`` copies and 8 warps
split the keys, each with its own softmax state. In bf16 the warps run
both products on the tensor cores (exact bf16 products, P kept at fp32
precision) and merge once a split; fp32 stays on the CUDA cores; see
the source. Any number of packed query rows ``G * Sq`` works: a call of
more than ``KERNEL_MAX_ROWS`` runs groups of that many rows side by side.

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

from repro_torch.kernels import LAUNCHES, build, pos_vector, use_kernel

NEG_INF = -1e30

#: streaming multiprocessors of an H100 SXM; the default split count
#: makes ``B * Hkv * n_splits`` thread blocks cover them
H100_SMS = 132

#: head dims the kernel is built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: packed query rows (G * Sq) a thread block takes; a call with more runs
#: groups of this many side by side, each reading its split's rows
KERNEL_MAX_ROWS = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flash_decode_partials": [_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L,
                              _I, _I, _I, _I, ctypes.c_float, _P],
    "flash_decode_paged_partials": [_P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I,
                                    _L, _L, _L, _L,
                                    _I, _I, _I, _I, ctypes.c_float, _P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def default_splits(b: int, hkv: int, n_blocks: int) -> int:
    """Fewest splits whose ``b * hkv * n_splits`` blocks cover the SMs."""
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


def decode_partials(q, k, v, pos, *, window=None, split_len: int,
                    n_splits: int, bound: int, impl: str = "auto"):
    """Per-split partials ``(o, m, l)`` — the kernel, or its plain version.

    See :func:`ref_decode_partials` for the contract. ``impl`` routes as
    in ``repro_torch.kernels``: a CUDA tensor reaches the kernel (or
    raises), a CPU tensor the plain version.
    """
    b, sq, h, dh = q.shape
    pos = pos_vector(pos, b, q.device)
    if not use_kernel(impl, q):
        return ref_decode_partials(q, k, v, pos, window=window,
                                   split_len=split_len, n_splits=n_splits,
                                   bound=bound)
    _check_kernel_inputs(q, k, v, pos, window)
    if k.shape[0] != b:
        raise ValueError(f"k has {k.shape[0]} slots, q {b}")
    lib = build.load("decode", _SIGNATURES)
    o = torch.empty((n_splits, b, sq, h, dh), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((n_splits, b, sq, h), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    rc = lib.flash_decode_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(),
        _DTYPE_CODES[q.dtype], b, sq, h, k.shape[2], dh,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        n_splits, split_len, bound, window or 0, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return o, m, l


def combine_splits(o_part, m_part, l_part) -> torch.Tensor:
    """Merge per-split partial softmax states (flash-decoding combine).

    o_part: (S, B, Sq, H, Dh) unnormalized accumulators; m_part /
    l_part: (S, B, Sq, H). Splits with no live row carry (m=-1e30, l=0)
    and weigh exactly zero. Returns (B, Sq, H, Dh) fp32.
    """
    m_max = m_part.amax(0)
    w = torch.exp(m_part - m_max[None])
    l_tot = (l_part * w).sum(0)
    o = (o_part * w[..., None]).sum(0)
    return o / l_tot.clamp_min(1e-30)[..., None]


def flash_decode(q, k, v, pos, *, window: int | None = None, bk: int = 128,
                 n_splits: int | None = None, kv_len: int | None = None,
                 impl: str = "auto") -> torch.Tensor:
    """Split-KV flash decode against a fixed-horizon KV cache.

    q: (B, Sq, H, Dh), the current decode token(s); k, v: (B, Skv, Hkv,
    Dh) slot caches; ``pos`` the absolute position of the first query
    token, a scalar or (B,). Query token ``j`` attends cache rows
    ``<= pos + j`` (its own key is already in the cache). Only rows
    ``< kv_len`` are ever read (default: the whole horizon).

    The rows are cut into splits by :func:`split_plan`, as the TPU
    kernel's grid cuts them; ``bk=128`` rows a block, which the kernel's
    own tiles (64 rows in bf16, 32 in fp32) divide. Returns (B, Sq, H, Dh) in q's dtype.
    """
    bound, split_len, n_splits = split_plan(q.shape[0], k.shape[2],
                                            k.shape[1], bk, n_splits, kv_len)
    o, m, l = decode_partials(q, k, v, pos, window=window,
                              split_len=split_len, n_splits=n_splits,
                              bound=bound, impl=impl)
    return combine_splits(o, m, l).to(q.dtype)


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


def decode_paged_partials(q, k_pages, v_pages, block_tables, pos, *,
                          window=None, split_len: int, n_splits: int,
                          bound: int, impl: str = "auto"):
    """Per-split partials ``(o, m, l)`` over a page pool: the paged
    kernel, or its plain version (:func:`ref_decode_paged_partials`).

    ``bound`` is a whole number of pages, at most the table's columns
    times the page size; no table column past it is read. ``impl``
    routes as in ``repro_torch.kernels``.
    """
    b, sq, h, dh = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[1]
    if bound % ps or bound > block_tables.shape[1] * ps:
        raise ValueError(f"bound {bound} is not a whole number of pages "
                         f"within the table ({block_tables.shape[1]} x {ps})")
    pos = pos_vector(pos, b, q.device)
    if not use_kernel(impl, q):
        return ref_decode_paged_partials(q, k_pages, v_pages, block_tables,
                                         pos, window=window,
                                         split_len=split_len,
                                         n_splits=n_splits, bound=bound)
    _check_kernel_inputs(q, k_pages, v_pages, pos, window)
    if block_tables.device != q.device or block_tables.dtype != torch.int32 \
            or block_tables.shape[0] != b or block_tables.stride(1) != 1:
        raise ValueError("block_tables must be a (B, NB) int32 tensor on "
                         f"{q.device} with contiguous rows")
    lib = build.load("decode", _SIGNATURES)
    o = torch.empty((n_splits, b, sq, h, dh), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((n_splits, b, sq, h), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    rc = lib.flash_decode_paged_partials(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(),
        _DTYPE_CODES[q.dtype], b, sq, h, k_pages.shape[2], dh,
        block_tables.stride(0), n_pages, ps,
        k_pages.stride(0), k_pages.stride(1),
        v_pages.stride(0), v_pages.stride(1),
        n_splits, split_len, bound, window or 0, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_decode_paged")
    LAUNCHES["flash_decode_paged"] += 1
    return o, m, l


def flash_decode_paged(q, k_pages, v_pages, block_tables, pos, *,
                       window: int | None = None,
                       n_splits: int | None = None,
                       n_blocks: int | None = None,
                       impl: str = "auto") -> torch.Tensor:
    """Split-KV flash decode against a paged KV pool.

    q: (B, Sq, H, Dh); ``k_pages``/``v_pages``: (P, page, Hkv, Dh)
    physical page pools shared by every slot; ``block_tables``: (B, NB)
    int32 mapping each slot's logical page ``i`` (cache rows ``i*page ..
    (i+1)*page-1``) to a physical page. Only the first ``n_blocks``
    columns (all with ``None``) are read, and of those only the pages
    holding rows the slot can see: columns past ``pos`` may hold any
    page id. Entries are clipped into ``[0, P - 1]``. Returns (B, Sq, H,
    Dh) in q's dtype.
    """
    n_blocks = block_tables.shape[1] if n_blocks is None else n_blocks
    bound, split_len, n_splits = paged_split_plan(
        q.shape[0], k_pages.shape[2], k_pages.shape[1], n_blocks, n_splits)
    o, m, l = decode_paged_partials(q, k_pages, v_pages, block_tables, pos,
                                    window=window, split_len=split_len,
                                    n_splits=n_splits, bound=bound, impl=impl)
    return combine_splits(o, m, l).to(q.dtype)


def ref_decode_paged(q, k_pages, v_pages, block_tables, pos, *,
                     window: int | None = None) -> torch.Tensor:
    """Dense paged oracle (mirror of JAX ``ref_decode_paged``): gather
    each slot's pages in logical order and run :func:`ref_decode`."""
    return ref_decode(q, gather_pages(k_pages, block_tables),
                      gather_pages(v_pages, block_tables), pos,
                      window=window)
