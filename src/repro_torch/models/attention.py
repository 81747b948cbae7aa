"""GQA attention (counterpart of ``repro/models/attention.py``): exact and
chunked causal attention for prefill, in plain PyTorch as in the JAX
package, and single-token decode against the slot cache through the
split-KV kernel suite.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import stores
from repro_torch.kernels.attention import ops as kops
from repro_torch.utils.loops import repeat

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q: (B, Sq, Hkv, G, Dh), k: (B, Skv, Hkv, Dh) -> (B, Hkv, G, Sq, Skv),
    fp32 (products of the inputs accumulated in fp32)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def _gqa_values(p, v):
    """p: (B, Hkv, G, Sq, Skv), v: (B, Skv, Hkv, Dh) -> (B, Sq, Hkv, G, Dh);
    the probabilities are cast to v's dtype first, as in JAX."""
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def dense_causal_attention(q, k, v, *, window: int | None = None,
                           q_offset: int = 0) -> torch.Tensor:
    """Exact, materializes (Sq, Skv) scores. For small S and tests.

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh). Queries sit at absolute
    positions q_offset..q_offset+Sq-1, keys at 0..Skv-1.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh) * (1.0 / math.sqrt(dh))
    s = _gqa_scores(qg, k)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > (qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, v).reshape(b, sq, h, dh)


def chunked_causal_attention(q, k, v, *, q_chunk: int = 512,
                             kv_chunk: int = 1024,
                             window: int | None = None) -> torch.Tensor:
    """Flash-style online-softmax attention, causal, optional window.

    Self-attention only (Sq == Skv). Each q chunk visits only its causal
    KV prefix (and only chunks inside the window when set), so the work
    matches the lower triangle at chunk granularity. The kv-chunk walk of
    a q chunk is a :func:`~repro_torch.utils.loops.repeat` loop, carried
    in a dict: a trace lowering records it as one loop region, as the
    JAX package's ``fori_loop`` lowers to one ``while``.

    q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) -> (B, S, H, Dh)
    """
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    # pad the queries to whole q chunks and the keys to the whole kv
    # chunks the last q chunk reaches; padded keys are in the future of
    # every real query (masked) and padded query rows are sliced off.
    # Each real query sees the chunks that the JAX package's padding to a
    # multiple of both chunk sizes gives it, without the rows past them
    # (that multiple is 38400 rows at S = 600 with the default chunks).
    n_q = -(-s // q_chunk)
    s_kv = -(-n_q * q_chunk // kv_chunk) * kv_chunk
    if n_q * q_chunk > s:
        q = F.pad(q, (0, 0, 0, 0, 0, n_q * q_chunk - s))
    if s_kv > s:
        k = F.pad(k, (0, 0, 0, 0, 0, s_kv - s))
        v = F.pad(v, (0, 0, 0, 0, 0, s_kv - s))
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for i in range(n_q):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qi_g = qi.reshape(b, q_chunk, hkv, g, dh) * scale
        qpos = i * q_chunk + torch.arange(q_chunk, device=dev)
        j_hi = (i * q_chunk + q_chunk + kv_chunk - 1) // kv_chunk
        j_lo = 0
        if window is not None:
            j_lo = max(0, (i * q_chunk - window) // kv_chunk)
        c = {"m": torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev),
             "l": torch.zeros((b, hkv, g, q_chunk), device=dev),
             "acc": torch.zeros((b, hkv, g, q_chunk, dh), device=dev)}

        def kv_step(t, qi_g=qi_g, qpos=qpos, j_lo=j_lo, c=c):
            j = j_lo + t
            kj = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vj = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            st = _gqa_scores(qi_g, kj)
            mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > (qpos[:, None] - window)
            st = torch.where(mask, st, NEG_INF)
            m_new = torch.maximum(c["m"], st.amax(-1))
            alpha = torch.exp(c["m"] - m_new)
            p = torch.exp(st - m_new[..., None])
            c["l"] = c["l"] * alpha + p.sum(-1)
            c["acc"] = c["acc"] * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vj.dtype), vj).float()
            c["m"] = m_new
        repeat(j_hi - j_lo, kv_step)
        l, acc = c["l"], c["acc"]
        o = acc / l.clamp_min(1e-30)[..., None]               # (B,Hkv,G,qc,Dh)
        o = o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, dh)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :s]


def decode_attention(q, k_cache, v_cache, pos, *, window: int | None = None,
                     impl: str = "auto", kv_len: int | None = None,
                     block_tables=None, k_new=None, v_new=None,
                     store_flavor: str | None = None) -> torch.Tensor:
    """Decode: q (B, Sq, H, Dh) against the slot cache (B, Skv, Hkv, Dh).

    ``pos`` (B,) is each slot's position of the first query token; cache
    rows past ``pos + j`` are masked for query token ``j``. Routed through
    ``kernels.attention.ops.flash_decode``: ``"auto"`` runs the split-KV
    kernel (one launch, splits merged inside it) on a CUDA tensor and its
    plain version on a CPU tensor,
    ``"ref"`` always the plain version. ``kv_len`` bounds the rows read.

    ``block_tables`` switches to the paged layout: the caches are page
    pools (P, page, Hkv, Dh) and ``block_tables`` (B, NB) int32 maps each
    slot's logical pages to physical ones (``serve.pages``). A routed
    impl or a ``kv_len`` runs ``ops.flash_decode_paged``; ``"ref"`` with
    no bound gathers the pages in logical order and falls through to the
    dense computation, as the reference does.

    ``k_new``/``v_new`` (B, Sq, Hkv, Dh) are the step's new K and V rows:
    the call writes them into the cache in place first (``store_flavor``
    picks the stores), then attends, in one kernel launch on a CUDA
    tensor (``ops.flash_decode``, ``ops.flash_decode_paged``).
    """
    new = dict(k_new=k_new, v_new=v_new, store_flavor=store_flavor)
    if block_tables is not None:
        if impl != "ref" or kv_len is not None:
            return kops.flash_decode_paged(q, k_cache, v_cache, block_tables,
                                           pos, window=window, impl=impl,
                                           kv_len=kv_len, **new)
        if stores.writes_rows(k_new, v_new, store_flavor):
            stores.ref_paged_row_update(k_cache, v_cache, block_tables,
                                        k_new, v_new, pos)
        new = {}
        b = q.shape[0]
        hkv, dh = k_cache.shape[2], k_cache.shape[3]
        bt = block_tables.long()
        k_cache = k_cache[bt].reshape(b, -1, hkv, dh)
        v_cache = v_cache[bt].reshape(b, -1, hkv, dh)
    return kops.flash_decode(q, k_cache, v_cache, pos, window=window,
                             impl=impl, kv_len=kv_len, **new)
