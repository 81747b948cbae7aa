"""The port's paged KV cache (``repro_torch.serve.pages``) against the JAX
package's.

* **Pool parity.** The same seeded admit / write / fork / release /
  exhaust schedule drives JAX's ``PagePool`` and the port's: every step
  must return the same pages, leave the same refcounts, stats and
  available count, and raise the same exception with the same message.
* **Pool invariants**, mirrored from ``tests/test_paged_serve.py``:
  conservation under random schedules, copy on write never mutating a
  page another holder sees, exhaustion and LRU eviction.
* **Device steps.** ``paged_insert`` and ``page_copy`` on bridged bf16
  pools must leave the very bytes JAX's jitted steps leave, and the pool
  sizes must match ``paged_kv_bytes`` / ``dense_kv_bytes``.
* **Recurrent leaves** (jamba's Mamba state beside its one attention
  layer): the paged layout keeps them slot-batched at ``max_slots``;
  ``paged_insert`` writes the slot row also when every page is shared,
  ``page_copy`` leaves them alone and ``slot_copy`` copies a slot row,
  byte for byte as JAX's steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serve import pages as JPG
from repro.train import serve as jserve
from repro_torch.models import bridge
from repro_torch.serve import pages as PG

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)

PS = 4
_PROMPT_RNG = np.random.default_rng(42)
PROMPTS = [tuple(int(t) for t in _PROMPT_RNG.integers(0, 512, n))
           for n in (3, 4, 6, 8, 8, 9)]


# ---------------------------------------------------------------------------
# Pool parity, step for step
# ---------------------------------------------------------------------------

def _pool_log(pool_cls, ops, n_pages=10):
    """Drive one pool through ``ops``; the log of every step's results,
    exceptions and resulting state."""
    pool = pool_cls(n_pages, PS)
    holders: list = []
    log = []
    for kind, a, b in ops:
        try:
            if kind == 0:                                   # admit
                prompt = PROMPTS[a % len(PROMPTS)]
                npg = -(-len(prompt) // PS)
                if pool.available() < npg:
                    continue
                shared = pool.match_prefix(prompt)
                fresh = pool.allocate(npg - len(shared))
                held = list(shared) + list(fresh)
                pool.register_prefix(prompt, held[:len(prompt) // PS])
                holders.append(held)
                log.append(("admit", shared, fresh))
            elif kind == 1 and holders:                     # release
                pool.release(holders.pop(a % len(holders)))
            elif kind == 2 and holders:                     # fork
                h = holders[a % len(holders)]
                pool.fork(h)
                holders.append(list(h))
            elif kind == 3 and holders:                     # write
                h = holders[a % len(holders)]
                lg = b % len(h)
                if pool.available() < 1:
                    continue
                h[lg], copied = pool.prepare_write(h[lg])
                log.append(("write", h[lg], copied))
            elif kind == 4:                                 # bad release
                free = [p for p in range(n_pages) if pool.refcount[p] == 0]
                if free:
                    pool.release([free[a % len(free)]])
            elif kind == 5 and pool.available() == 0:       # exhaust
                pool.allocate(1)
            elif kind == 6:                                 # bad write
                free = [p for p in range(n_pages) if pool.refcount[p] == 0]
                if free:
                    pool.prepare_write(free[b % len(free)])
        except RuntimeError as e:
            log.append(("raise", type(e).__name__, str(e)))
        pool.check_conservation(holders)
        log.append((list(pool.refcount), dict(pool.stats),
                    pool.available()))
    for h in holders:
        pool.release(h)
    pool.check_conservation([])
    log.append((list(pool.refcount), dict(pool.stats)))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_pool_matches_jax_step_for_step(seed):
    rng = np.random.default_rng(seed)
    ops = [tuple(int(x) for x in rng.integers(0, (7, 6, 8))) for _ in
           range(60)]
    want = _pool_log(JPG.PagePool, ops)
    got = _pool_log(PG.PagePool, ops)
    assert got == want
    assert any(e[0] == "raise" for e in got)    # the errors were driven


def test_pool_errors_match_jax():
    for cls in (JPG.PagePool, PG.PagePool):
        with pytest.raises(ValueError, match="must be >= 1"):
            cls(0, PS)
    assert issubclass(PG.PoolExhausted, RuntimeError)
    assert PG.PoolExhausted.__name__ == JPG.PoolExhausted.__name__


# ---------------------------------------------------------------------------
# Pool invariants (mirrors tests/test_paged_serve.py)
# ---------------------------------------------------------------------------

def _chain_val(prompt, j):
    return ("chain", prompt[:(j + 1) * PS])


@pytest.mark.parametrize("seed", range(6))
def test_pool_schedule_invariants(seed):
    """Random admit/write/fork/release schedules conserve the pool and
    never let a write reach a page another holder still sees."""
    rng = np.random.default_rng(100 + seed)
    pool = PG.PagePool(10, PS)
    contents: dict = {}
    holders: list = []
    stamp = 0
    for _ in range(50):
        kind, a, b = (int(x) for x in rng.integers(0, (5, 6, 8)))
        if kind == 0:                                     # admit
            prompt = PROMPTS[a % len(PROMPTS)]
            npg = -(-len(prompt) // PS)
            if pool.available() < npg:
                continue
            shared = pool.match_prefix(prompt)
            for j, p in enumerate(shared):
                assert contents[p] == _chain_val(prompt, j)
            fresh = pool.allocate(npg - len(shared))
            held = list(shared) + list(fresh)
            full = len(prompt) // PS
            view = {}
            for j in range(npg):
                if j >= len(shared):
                    contents[held[j]] = (_chain_val(prompt, j)
                                         if j < full else ("partial", stamp))
                    stamp += 1
                view[j] = contents[held[j]]
            pool.register_prefix(prompt, held[:full])
            holders.append({"pages": held, "view": view})
        elif kind == 1 and holders:                       # release
            pool.release(holders.pop(a % len(holders))["pages"])
        elif kind == 2 and holders:                       # fork
            h = holders[a % len(holders)]
            pool.fork(h["pages"])
            holders.append({"pages": list(h["pages"]),
                            "view": dict(h["view"])})
        elif kind == 3 and holders:                       # write
            h = holders[a % len(holders)]
            lg = b % len(h["pages"])
            if pool.available() < 1:
                continue
            page, copied = pool.prepare_write(h["pages"][lg])
            if copied:
                contents[page] = contents[h["pages"][lg]]
                h["pages"][lg] = page
            contents[page] = ("w", stamp)
            h["view"][lg] = contents[page]
            stamp += 1
        else:
            pool.check_conservation([h["pages"] for h in holders])
        for h in holders:
            for lg, p in enumerate(h["pages"]):
                assert contents[p] == h["view"][lg]
    pool.check_conservation([h["pages"] for h in holders])
    for h in holders:
        pool.release(h["pages"])
    pool.check_conservation([])


def test_pool_exhaustion_and_lru_eviction():
    pool = PG.PagePool(2, PS)
    prompt = PROMPTS[1]                   # 4 tokens = 1 full page
    held = pool.match_prefix(prompt) or pool.allocate(1)
    pool.register_prefix(prompt, held[:1])
    pool.release(held)                    # survives as a retained page
    assert pool.available() == 2          # 1 free + 1 evictable
    got = pool.allocate(2)                # forces the LRU eviction
    assert len(got) == 2 and pool.stats["evictions"] == 1
    assert pool.match_prefix(prompt) == []
    with pytest.raises(PG.PoolExhausted, match="exhausted"):
        pool.allocate(1)
    pool.release(got)
    with pytest.raises(RuntimeError, match="unheld"):
        pool.release(got[:1])


def test_check_conservation_catches_a_leak():
    pool = PG.PagePool(4, PS)
    held = pool.allocate(2)
    pool.check_conservation([held])
    with pytest.raises(AssertionError, match="refcount"):
        pool.check_conservation([])       # a holder dropped its pages


# ---------------------------------------------------------------------------
# Sizes and device steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_bytes_match_jax(dtype):
    cj, ct = cfg_pair(dtype)
    for n_pages, ps in ((32, 8), (321, 16), (7, 4)):
        assert PG.paged_kv_bytes(ct, n_pages, ps) \
            == JPG.paged_kv_bytes(cj, n_pages, ps)
    assert PG.dense_kv_bytes(ct, 4, 256) == JPG.dense_kv_bytes(cj, 4, 256)
    # memory scales with the pool, not with the horizon
    assert PG.dense_kv_bytes(ct, 4, 512) == 2 * PG.dense_kv_bytes(ct, 4, 256)
    assert PG.paged_kv_bytes(ct, 64, 8) == 2 * PG.paged_kv_bytes(ct, 32, 8)
    assert PG.dense_kv_bytes(ct, 4, 256) \
        / PG.paged_kv_bytes(ct, 4 * (64 // 8), 8) > 3.9
    assert PG.pages_per_slot(24, 4) == 6 and PG.pages_per_slot(25, 4) == 7


def _random_pools(cj, n_pages, seed):
    shapes = JPG.paged_cache_shapes(cj, 2, n_pages, PS)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), shapes)


def _bits(tree):
    return [np.asarray(x).view(np.uint16) if x.dtype == jnp.bfloat16
            else np.asarray(x) for x in jax.tree.leaves(tree)]


def _torch_bits(tree):
    return [x.view(torch.int16).numpy().view(np.uint16)
            if x.dtype == torch.bfloat16 else x.numpy()
            for _, x in sorted(_flat(tree).items())]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_paged_cache_layout_matches_jax():
    cj, ct = cfg_pair("bfloat16")
    want = [tuple(s.shape) for s in
            jax.tree.leaves(JPG.paged_cache_shapes(cj, 2, 9, PS))]
    got = PG.init_paged_cache(ct, 2, 9, PS, device="cpu")
    assert [tuple(x.shape) for _, x in sorted(_flat(got).items())] == want
    assert all(bool((x == 0).all()) for x in _flat(got).values())


@pytest.mark.parametrize("prompt_len,phys,logical", [
    (9, [5, 2], [1, 2]),        # shared first page, padded partial last
    (8, [0, 7], [0, 1]),        # full pages, nothing shared
    (4, [], []),                # fully shared: nothing copied
])
def test_paged_insert_matches_jax(prompt_len, phys, logical):
    cj, ct = cfg_pair("bfloat16")
    pj, _ = bridged_params(cj, ct)
    pools_j = _random_pools(cj, 9, seed=prompt_len)
    pools_t = bridge.cache_from_jax(jax.tree.map(np.asarray, pools_j), ct,
                                    device="cpu")
    toks = np.random.default_rng(1).integers(0, ct.vocab_size,
                                             (1, prompt_len))
    # the exact-length prefill cache, bridged bit for bit: the insert,
    # not the prefill arithmetic, is under test here
    _, one_j = jserve.make_prefill_step(cj, cache_len=None)(
        pj, {"tokens": jnp.asarray(toks)})
    one_t = bridge.cache_from_jax(jax.tree.map(np.asarray, one_j), ct,
                                  device="cpu")
    want = jax.jit(JPG.make_paged_insert_step(cj, PS))(
        pools_j, one_j, jnp.int32(0), jnp.asarray(phys, jnp.int32),
        jnp.asarray(logical, jnp.int32))
    ptrs = [x.data_ptr() for x in _flat(pools_t).values()]
    PG.paged_insert(ct, pools_t, one_t, 0,
                    torch.tensor(phys, dtype=torch.int64),
                    torch.tensor(logical, dtype=torch.int64))
    assert [x.data_ptr() for x in _flat(pools_t).values()] == ptrs
    for g, w in zip(_torch_bits(pools_t), _bits(want)):
        np.testing.assert_array_equal(g, w)


def test_page_copy_matches_jax():
    cj, ct = cfg_pair("bfloat16")
    pools_j = _random_pools(cj, 6, seed=3)
    pools_t = bridge.cache_from_jax(jax.tree.map(np.asarray, pools_j), ct,
                                    device="cpu")
    want = jax.jit(JPG.make_page_copy_step(cj))(pools_j, jnp.int32(4),
                                                jnp.int32(1))
    PG.page_copy(ct, pools_t, 4, 1)
    for g, w in zip(_torch_bits(pools_t), _bits(want)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Recurrent leaves beside the pools
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"


def test_recurrent_paged_layout_matches_jax():
    """KV leaves are pools, recurrent leaves keep ``max_slots`` rows (in
    fp32), as in JAX's ``paged_cache_shapes``; only pools count as KV."""
    cj, ct = cfg_pair("bfloat16", JAMBA)
    want = {path: (tuple(s.shape), str(s.dtype)) for path, s in
            _flat(JPG.paged_cache_shapes(cj, 3, 9, PS)).items()}
    got = {path: (tuple(shape), str(dtype).replace("torch.", "")) for
           path, (shape, dtype) in
           _flat(PG.paged_cache_shapes(ct, 3, 9, PS)).items()}
    assert got == want
    assert _flat(PG.kv_leaf_flags(ct)) == _flat(jax.tree.map(
        bool, JPG.kv_leaf_flags(cj)))
    cache = PG.init_paged_cache(ct, 3, 9, PS, device="cpu")
    assert {p: tuple(x.shape) for p, x in _flat(cache).items()} \
        == {p: shape for p, (shape, _) in want.items()}
    assert all(bool((x == 0).all()) for x in _flat(cache).values())
    assert PG.paged_kv_bytes(ct, 9, PS) == JPG.paged_kv_bytes(cj, 9, PS)
    assert PG.dense_kv_bytes(ct, 3, 48) == JPG.dense_kv_bytes(cj, 3, 48)


def _jamba_pools(cj, ct, seed):
    shapes = JPG.paged_cache_shapes(cj, 3, 9, PS)
    rng = np.random.default_rng(seed)
    pools_j = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype), shapes)
    return pools_j, bridge.cache_from_jax(jax.tree.map(np.asarray, pools_j),
                                          ct, device="cpu")


@pytest.mark.parametrize("phys,logical", [([5, 2], [1, 2]), ([], [])])
def test_recurrent_paged_insert_matches_jax(phys, logical):
    """A 9-token prompt into slot 1: its pages (none when all are shared)
    and its Mamba rows, conv cast from bf16 to the slot's fp32."""
    cj, ct = cfg_pair("bfloat16", JAMBA)
    pj, _ = bridged_params(cj, ct)
    pools_j, pools_t = _jamba_pools(cj, ct, seed=len(phys))
    toks = np.random.default_rng(1).integers(0, ct.vocab_size, (1, 9))
    _, one_j = jserve.make_prefill_step(cj, cache_len=None)(
        pj, {"tokens": jnp.asarray(toks)})
    # the prefill's conv state is bf16; it crosses as the fp32 it becomes
    # in the slot (exactly)
    one_host = jax.tree.map(lambda x, s: np.asarray(x.astype(s.dtype)),
                            one_j, JM.cache_shapes(cj, 1, 9))
    one_t = bridge.cache_from_jax(one_host, ct, device="cpu")
    want = jax.jit(JPG.make_paged_insert_step(cj, PS))(
        pools_j, one_j, jnp.int32(1), jnp.asarray(phys, jnp.int32),
        jnp.asarray(logical, jnp.int32))
    PG.paged_insert(ct, pools_t, one_t, 1,
                    torch.tensor(phys, dtype=torch.int64),
                    torch.tensor(logical, dtype=torch.int64))
    for g, w in zip(_torch_bits(pools_t), _bits(want)):
        np.testing.assert_array_equal(g, w)


def test_recurrent_page_and_slot_copies_match_jax():
    """``page_copy`` copies page 4 to 1 in the pools only; ``slot_copy``
    copies slot row 2 to 0 in the recurrent leaves only."""
    cj, ct = cfg_pair("bfloat16", JAMBA)
    pools_j, pools_t = _jamba_pools(cj, ct, seed=7)
    want = jax.jit(JPG.make_page_copy_step(cj))(pools_j, jnp.int32(4),
                                                jnp.int32(1))
    PG.page_copy(ct, pools_t, 4, 1)
    for g, w in zip(_torch_bits(pools_t), _bits(want)):
        np.testing.assert_array_equal(g, w)
    want = jax.jit(JPG.make_slot_copy_step(cj))(want, jnp.int32(2),
                                                jnp.int32(0))
    PG.slot_copy(ct, pools_t, 2, 0)
    for g, w in zip(_torch_bits(pools_t), _bits(want)):
        np.testing.assert_array_equal(g, w)
