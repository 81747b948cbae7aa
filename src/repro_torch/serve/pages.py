"""Paged KV cache: a fixed pool of physical pages, per-slot block
tables, refcounted prefix sharing, and copy-on-write.

The counterpart of ``repro/serve/pages.py``. The dense engine
(``serve.engine.ServeEngine``) preallocates every slot at the full
decode horizon, so memory scales with ``slots x horizon`` however short
the live requests are. Here each attention layer's K/V leaf becomes a
physical pool ``(P, page, Hkv, Dh)`` shared by all slots (scan-stacked
``(R, P, page, Hkv, Dh)``), and a per-slot **block table** maps logical
page ``i`` (cache rows ``i*page .. (i+1)*page-1``) to whichever
physical page holds it. Recurrent state (Mamba, xLSTM) has no rows to
page: it stays slot-batched, one row a slot, as in the dense cache.

* memory scales with live tokens: a slot holds ``ceil(occupancy /
  page)`` pages, not a horizon;
* admission skips the zero-fill: a recycled page is overwritten in
  place (stale rows are masked by position, like the dense cache's
  unwritten horizon); only the pool's one-time init stores zeros;
* common prefixes are shared: full prompt pages are content-addressed
  (a hash chain over page token tuples), so two requests with the same
  system prompt map the same physical pages and admission copies none;
  a divergent write to a shared page is copied first
  (:meth:`PagePool.prepare_write`).

:class:`PagePool` is host-side bookkeeping in plain Python (refcounts,
free list, prefix index), the JAX package's class line for line, so
both pools hand out the same pages in the same order. The device steps
(:func:`paged_insert`, :func:`page_copy`, :func:`slot_copy`) update the
cache in place; under a mesh (DTensor leaves, laid out by
:func:`paged_cache_pspecs`: pools resident, heads on TP) each rank
updates its own shards.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve.slots import SLOT_AXIS, copy_slot, insert_leaf
from repro_torch.utils import sharding as shd
from repro_torch.utils.sharding import local


def pages_per_slot(max_len: int, page_size: int) -> int:
    """Block-table width: logical pages covering the decode horizon."""
    return math.ceil(max_len / page_size)


def kv_leaf_flags(cfg: ModelConfig) -> dict:
    """Cache-structured tree of bools: True on the paged (KV) leaves,
    False on the slot-batched recurrent ones."""
    out: dict = {"tail": {}}
    for path, d in M._walk(M.cache_defs(cfg, 1, 1)):
        M._set(out, path, M.is_kv(d))
    return out


def paged_cache_shapes(cfg: ModelConfig, max_slots: int, n_pages: int,
                       page_size: int) -> dict:
    """``(shape, dtype)`` tree of the paged decode cache.

    KV leaves become physical pools ``(n_pages, page, Hkv, Dh)``
    (scan-stacked ``(R, n_pages, page, Hkv, Dh)``): their size is set by
    the pool, not by ``slots x horizon``. Recurrent leaves keep the dense
    slot-batched shapes of ``max_slots`` slots.
    """
    out: dict = {"tail": {}}
    for (path, flag), (_, kv), (_, slot) in zip(
            M._walk(kv_leaf_flags(cfg)),
            M._walk(M.cache_shapes(cfg, n_pages, page_size)),
            M._walk(M.cache_shapes(cfg, max_slots, 1))):
        M._set(out, path, kv if flag else slot)
    return out


def init_paged_cache(cfg: ModelConfig, max_slots: int, n_pages: int,
                     page_size: int, device="cuda", mesh=None,
                     specs: dict | None = None) -> dict:
    """Zero-filled paged cache matching :func:`paged_cache_shapes`; with a
    ``mesh``, DTensors laid out by ``specs`` (:func:`paged_cache_pspecs`),
    each rank allocating its shard alone.

    This is the pool's one-time zero store; recycled pages are never
    re-zeroed (:class:`PagePool` hands them out stale, admission
    overwrites them in place).
    """
    out: dict = {"tail": {}}
    for path, (shape, dtype) in M._walk(paged_cache_shapes(
            cfg, max_slots, n_pages, page_size)):
        M._set(out, path, torch.zeros(shape, dtype=dtype, device=device)
               if mesh is None else
               shd.zeros(shape, dtype, mesh, shd.spec_at(specs, path),
                         device))
    return out


def paged_cache_pspecs(cfg: ModelConfig, rules: dict, mesh_sizes: dict,
                       max_slots: int, n_pages: int,
                       page_size: int) -> dict:
    """Spec tree matching :func:`paged_cache_shapes`.

    KV pool leaves ``(P, page, Hkv, Dh)`` keep the pool and page dims
    resident (every shard must see every block-table entry; the gather
    is the kernel's job) and put the TP split on ``kvheads``: the
    ``batch``/``kv_seq`` rules are masked out so the dense cache rules
    can never claim the pool dims. Recurrent leaves keep their dense
    slot-batched specs.
    """
    pool_rules = dict(rules, batch=(), kv_seq=())
    out: dict = {"tail": {}}
    for (path, flag), (_, kv), (_, slot) in zip(
            M._walk(kv_leaf_flags(cfg)),
            M._walk(M.cache_pspecs(cfg, pool_rules, mesh_sizes, n_pages,
                                   page_size)),
            M._walk(M.cache_pspecs(cfg, rules, mesh_sizes, max_slots, 1))):
        M._set(out, path, kv if flag else slot)
    return out


def _kv_bytes(cfg: ModelConfig, shapes: dict) -> int:
    return sum(math.prod(shape) * dtype.itemsize
               for (_, (shape, dtype)), (_, flag)
               in zip(M._walk(shapes), M._walk(kv_leaf_flags(cfg))) if flag)


def paged_kv_bytes(cfg: ModelConfig, n_pages: int, page_size: int) -> int:
    """Total bytes of the KV page pools."""
    return _kv_bytes(cfg, M.cache_shapes(cfg, n_pages, page_size))


def dense_kv_bytes(cfg: ModelConfig, max_slots: int, max_len: int) -> int:
    """KV bytes of the dense slot cache at the same shapes (baseline)."""
    return _kv_bytes(cfg, M.cache_shapes(cfg, max_slots, max_len))


class PoolExhausted(RuntimeError):
    """Raised by :meth:`PagePool.allocate` when no page can be handed out.

    A ``RuntimeError`` subclass, as in the JAX package, where the
    fault-tolerant serve path catches it as a retryable overload signal.
    """


class PagePool:
    """Host-side physical page allocator with refcounted prefix sharing.

    Every page has a refcount: one per block-table entry holding it,
    plus one when the prefix index retains it as shareable. Full prompt
    pages are registered under a content hash chain ``key_i = (key_{i-1},
    tokens of page i)``, so a later admission with the same prompt prefix
    maps the same physical pages (:meth:`match_prefix`, zero copies).
    Retained pages survive their last holder and are evicted LRU only
    when the free list runs dry, which is also where recycling happens:
    reallocated pages keep their stale contents.

    Writes go through :meth:`prepare_write`: an exclusively held page is
    written in place; a shared one is copied to a fresh page (the caller
    makes the device copy). ``stats`` counts shared maps, copies on
    write, fresh and recycled allocations, and evictions.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = [0] * self.n_pages
        self._free = list(range(self.n_pages - 1, -1, -1))  # pop() -> 0,1,..
        self._used = [False] * self.n_pages   # ever allocated (recycling)
        self._chains: dict = {}               # chain key -> phys page
        self._page_key: dict = {}             # phys page -> chain key
        self._retained: dict = {}             # phys -> key, LRU order
        self.stats = {"shared_maps": 0, "cow_copies": 0,
                      "fresh_allocs": 0, "recycled_allocs": 0,
                      "evictions": 0}

    # -- allocation ---------------------------------------------------------
    def available(self) -> int:
        """Pages an ``allocate`` call could hand out right now."""
        evictable = sum(1 for p in self._retained if self.refcount[p] == 1)
        return len(self._free) + evictable

    def allocate(self, n: int) -> list:
        """Take ``n`` exclusive pages (refcount 1 each), recycling
        stale pages and evicting index-retained ones LRU if needed."""
        out = []
        for _ in range(int(n)):
            if self._free:
                p = self._free.pop()
            else:
                p = self._evict_retained()
            self.refcount[p] = 1
            key = "recycled_allocs" if self._used[p] else "fresh_allocs"
            self.stats[key] += 1
            self._used[p] = True
            out.append(p)
        return out

    def _evict_retained(self) -> int:
        for p in list(self._retained):        # insertion order = LRU
            if self.refcount[p] == 1:         # only the index holds it
                self._unregister(p)
                self.refcount[p] = 0
                self.stats["evictions"] += 1
                return p
        raise PoolExhausted(
            f"page pool exhausted ({self.n_pages} pages, none evictable)")

    def release(self, pages) -> None:
        """Drop one reference per page; refcount-0 pages go back to the
        free list (still registered pages stay retained instead)."""
        for p in pages:
            p = int(p)
            if self.refcount[p] <= 0:
                raise RuntimeError(f"release of unheld page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._unregister(p)
                self._free.append(p)

    # -- prefix sharing -----------------------------------------------------
    @staticmethod
    def _chain(prev, tokens) -> tuple:
        return (prev, tuple(tokens))

    def match_prefix(self, prompt) -> list:
        """Physical pages of the longest registered full-page prefix of
        ``prompt``; takes one reference per matched page (the caller
        owns them as the head of its block table)."""
        ps = self.page_size
        out, key = [], None
        for i in range(len(prompt) // ps):
            key = self._chain(key, prompt[i * ps:(i + 1) * ps])
            p = self._chains.get(key)
            if p is None:
                break
            out.append(p)
        for p in out:
            self.refcount[p] += 1
            if p in self._retained:           # refresh LRU recency
                k = self._retained.pop(p)
                self._retained[p] = k
        self.stats["shared_maps"] += len(out)
        return out

    def register_prefix(self, prompt, chain_pages) -> None:
        """Register a request's full prompt pages as shareable.

        ``chain_pages`` are the request's block-table head in logical
        order (matched + fresh). The index takes its own reference on
        each newly registered page, so the prefix stays shareable after
        the request retires, until pool pressure evicts it.
        """
        ps = self.page_size
        key = None
        for i, p in enumerate(chain_pages):
            key = self._chain(key, prompt[i * ps:(i + 1) * ps])
            if key in self._chains:
                continue                      # already shared
            self._chains[key] = p
            self._page_key[p] = key
            self._retained[p] = key
            self.refcount[p] += 1

    def _unregister(self, p: int) -> None:
        key = self._page_key.pop(p, None)
        if key is not None:
            self._chains.pop(key, None)
        self._retained.pop(p, None)

    # -- sharing / CoW ------------------------------------------------------
    def fork(self, pages) -> None:
        """Share every page of a live request with a clone (refcount++
        including partial pages; the first divergent write copies)."""
        for p in pages:
            self.refcount[int(p)] += 1

    def prepare_write(self, phys: int) -> tuple:
        """Exclusive page for an in-place write: ``(page, copied)``.

        An exclusively held page comes straight back. A page retained
        only by the prefix index is unregistered (its content is about to
        change) and written in place. A page with other live holders is
        copied on write: a fresh page is allocated, the caller's
        reference moves to it, and the caller must device-copy the old
        contents before writing (``copied=True``).
        """
        phys = int(phys)
        rc = self.refcount[phys]
        retained = phys in self._retained
        if rc <= 0:
            raise RuntimeError(f"prepare_write on unheld page {phys}")
        if rc == 1 and not retained:
            return phys, False
        if rc == 2 and retained:
            self._unregister(phys)
            self.refcount[phys] -= 1
            return phys, False
        new = self.allocate(1)[0]
        self.refcount[phys] -= 1
        self.stats["cow_copies"] += 1
        return new, True

    # -- invariants ---------------------------------------------------------
    def check_conservation(self, tables) -> None:
        """Assert pool conservation against the live block tables.

        ``tables`` is an iterable of per-request page lists. Every page's
        refcount must equal its live holders plus its index retention;
        free pages must be unheld and refcount 0; every page must be
        either free or referenced. Raises AssertionError with the
        offending page on violation.
        """
        held: dict = {}
        for t in tables:
            for p in t:
                held[int(p)] = held.get(int(p), 0) + 1
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        for p in range(self.n_pages):
            want = held.get(p, 0) + (1 if p in self._retained else 0)
            if self.refcount[p] != want:
                raise AssertionError(
                    f"page {p}: refcount {self.refcount[p]} != "
                    f"{held.get(p, 0)} holders + "
                    f"{int(p in self._retained)} retained")
            if p in free and (self.refcount[p] != 0 or p in held):
                raise AssertionError(f"page {p} free but referenced")
            if p not in free and self.refcount[p] == 0:
                raise AssertionError(f"page {p} leaked (unreferenced, "
                                     "not free)")


# ---------------------------------------------------------------------------
# Device steps, in place
# ---------------------------------------------------------------------------

def _leaves(cache: dict, other: dict, flags: dict, shards: bool = True):
    """(axis, leaf, the same leaf of ``other``, is KV) over the cache; a
    DTensor leaf as this rank's shard (a pool leaf shards heads alone, so
    page indices are the same on every rank), or as it is when not
    ``shards``."""
    pick = local if shards else (lambda t: t)
    for part, axis in SLOT_AXIS.items():
        if part in cache:
            for (_, big), (_, small), (_, kv) in zip(
                    M._walk(pick(cache[part])), M._walk(pick(other[part])),
                    M._walk(flags[part])):
                yield axis, big, small, kv


def paged_insert(cfg: ModelConfig, cache: dict, one: dict, slot: int, phys,
                 logical) -> None:
    """Land a prefilled request in the paged cache, in place.

    ``one`` is a batch-1 prefill cache built at exactly the prompt length
    (``make_prefill_step(cfg, cache_len=None)``, no horizon zero-fill).
    Its KV rows are cut into pages (the last one padded) and logical page
    ``logical[i]`` lands in physical page ``phys[i]`` of every KV leaf.
    Shared prefix pages are left out of both lists: shared content is
    never copied. Its recurrent leaves land in slot row ``slot`` (cast to
    the cache's fp32), also when every page is shared and no KV row is
    copied. ``phys`` and ``logical`` are int64 tensors on the cache's
    device.
    """
    for axis, big, small, kv in _leaves(cache, one, kv_leaf_flags(cfg),
                                        shards=False):
        if not kv:
            # slot-batched: under a mesh the slot's owner writes it
            insert_leaf(big, small, axis, slot)
            continue
        if phys.numel() == 0:
            continue
        big, small = local(big), local(small)
        ps = big.shape[axis + 1]
        s = small.shape[axis + 1]
        npg = -(-s // ps)
        rows = F.pad(small, (0, 0, 0, 0, 0, npg * ps - s))
        rows = rows.reshape(small.shape[:axis] + (npg, ps)
                            + small.shape[axis + 2:])
        big.index_copy_(axis, phys,
                        rows.index_select(axis, logical).to(big.dtype))


def page_copy(cfg: ModelConfig, cache: dict, src: int, dst: int) -> None:
    """Copy physical page ``src`` to ``dst`` in every KV leaf (all
    attention layers, K and V), in place: the copy on write. Recurrent
    leaves are left alone."""
    for axis, big, _, kv in _leaves(cache, cache, kv_leaf_flags(cfg)):
        if kv:
            big.select(axis, dst).copy_(big.select(axis, src))


def slot_copy(cfg: ModelConfig, cache: dict, src: int, dst: int) -> None:
    """Copy slot row ``src`` to ``dst`` in every recurrent leaf, in place:
    a fork shares the KV pages through its block table, but its recurrent
    state (Mamba, xLSTM) is its own row. KV pools are left alone."""
    for axis, big, _, kv in _leaves(cache, cache, kv_leaf_flags(cfg),
                                    shards=False):
        if not kv:
            copy_slot(big, axis, src, dst)
