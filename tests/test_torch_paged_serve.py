"""The port's paged serving path against the JAX package's.

Smoke yi-9b in fp32 with the same weights (bridged through numpy), the
reference test's ``PS=4, MAX_LEN=24, CHUNK=3, SLOTS=2``:

* the paged decode forward (in-place page writes with the overshoot
  clamp, attention through the block table) against JAX's, logits and
  pools within 1e-5;
* one admit / step / cancel / fork schedule through JAX's
  ``PagedServeEngine`` and the port's: identical greedy token streams,
  identical block tables after every operation and identical pool stats;
* inside the port, as ``tests/test_paged_serve.py`` holds the reference:
  paged == dense streams, a shared-prefix admission copies no page, a
  fork's copy on write leaves the parent stream untouched, cancel
  recycles pages, pool bytes scale with the pool and not the horizon,
  and ``check_pool`` passes after every run (and catches a leak).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import Request as JRequest
from repro.serve import pages as JPG
from repro_torch.models import bridge
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.serve import pages as PG

from _torch_common import bridged_params, cfg_pair, f32

torch.set_num_threads(1)

PS, MAX_LEN, CHUNK, SLOTS = 4, 24, 3, 2
KW = dict(max_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK)
_PROMPT_RNG = np.random.default_rng(42)
PROMPTS = [tuple(int(t) for t in _PROMPT_RNG.integers(0, 512, n))
           for n in (3, 4, 6, 8, 8, 9)]


@pytest.fixture(scope="module")
def models():
    cj, ct = cfg_pair("float32")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _paged(ct, pt, **kw):
    return PagedServeEngine(ct, pt, page_size=PS, device="cpu",
                            **dict(KW, **kw))


# ---------------------------------------------------------------------------
# The paged decode forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,kv_len", [("ref", None), ("auto", 21)])
def test_paged_decode_forward_matches_jax(models, impl, kv_len):
    """Per-slot positions through a permuted block table; slot 2 is past
    the horizon, so its row is clamped into its last logical page."""
    cj, ct, pj, pt = models
    rng = np.random.default_rng(3)
    pools_j = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        JPG.paged_cache_shapes(cj, 3, 19, PS))
    pools_t = bridge.cache_from_jax(jax.tree.map(np.asarray, pools_j), ct,
                                    device="cpu")
    bt = rng.permutation(18).reshape(3, 6).astype(np.int32)
    tok = rng.integers(0, ct.vocab_size, (3, 1))
    pos = np.array([12, 7, 25], np.int32)
    lj, _, new_j = JM.forward(cj, pj, {"tokens": jnp.asarray(tok)},
                              mode="decode", cache=pools_j,
                              pos=jnp.asarray(pos),
                              block_tables=jnp.asarray(bt))
    ptr = pools_t["scan"]["0"]["k"].data_ptr()
    lt, _, new_t = M.forward(ct, pt, {"tokens": torch.tensor(tok)},
                             mode="decode", cache=pools_t,
                             pos=torch.tensor(pos), impl=impl, kv_len=kv_len,
                             block_tables=torch.tensor(bt))
    assert new_t["scan"]["0"]["k"].data_ptr() == ptr      # in place
    np.testing.assert_allclose(f32(lt), f32(lj), rtol=1e-5, atol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(f32(new_t["scan"]["0"][n]),
                                   f32(new_j["scan"]["0"][n]),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Engine parity with JAX
# ---------------------------------------------------------------------------

def _schedule(eng, make_request, ops) -> tuple:
    """Interpret ``ops`` on an engine; returns ({rid: tokens}, a paged
    engine's block tables after every operation)."""
    results, tables, rid = {}, [], 0
    for kind, a, b in ops:
        if kind == "admit" and eng.free_slots():
            eng.admit(make_request(f"r{rid}", PROMPTS[a], b))
            rid += 1
        elif kind == "step":
            results.update((r, t.tolist()) for r, t in eng.step())
        elif kind == "cancel":
            act = sorted(s.rid for s in eng.slots if s is not None)
            if act:
                r = act[a % len(act)]
                results[r] = eng.cancel(r).tolist()
        elif kind == "fork" and eng.free_slots():
            act = sorted(s.rid for s in eng.slots if s is not None)
            if act:
                eng.fork(act[a % len(act)], f"f{rid}")
                rid += 1
        if eng.paged:
            tables.append(eng.block_tables.tolist())
    while any(s is not None for s in eng.slots):
        results.update((r, t.tolist()) for r, t in eng.step())
        if eng.paged:
            tables.append(eng.block_tables.tolist())
    return results, tables


SCHEDULES = {
    "fork-cancel": [("admit", 4, 7), ("admit", 4, 5), ("step", 0, 0),
                    ("cancel", 0, 0), ("fork", 0, 0), ("step", 0, 0),
                    ("admit", 5, 8), ("step", 0, 0), ("step", 0, 0)],
    "shared-cow": [("admit", 5, 8), ("fork", 0, 0), ("step", 0, 0),
                   ("step", 0, 0), ("cancel", 1, 0), ("admit", 5, 4),
                   ("admit", 3, 6)],
    "churn": [("admit", 0, 1), ("admit", 2, 9), ("step", 0, 0),
              ("admit", 1, 3), ("step", 0, 0), ("cancel", 0, 0),
              ("admit", 4, 2), ("fork", 1, 0), ("step", 0, 0),
              ("admit", 3, 5)],
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("share", [True, False])
def test_paged_engine_matches_jax(models, name, share):
    cj, ct, pj, pt = models
    ops = SCHEDULES[name]
    jeng = JPagedServeEngine(cj, pj, page_size=PS, share_prefixes=share,
                             **KW)
    teng = _paged(ct, pt, share_prefixes=share)
    want, want_tables = _schedule(jeng, JRequest, ops)
    got, got_tables = _schedule(teng, Request, ops)
    assert got == {r: np.asarray(t).tolist() for r, t in want.items()}
    assert got_tables == want_tables
    assert teng.pool.stats == jeng.pool.stats
    assert teng.pool.refcount == jeng.pool.refcount
    assert teng.gather_pages == jeng.gather_pages
    teng.check_pool()


# ---------------------------------------------------------------------------
# Inside the port (mirrors tests/test_paged_serve.py)
# ---------------------------------------------------------------------------

def _random_ops(seed):
    rng = np.random.default_rng(seed)
    kinds = ("admit", "step", "cancel")
    return [(kinds[int(k)], int(a), 1 + int(b))
            for k, a, b in rng.integers(0, (3, 6, 8), (8, 3))]


@pytest.mark.parametrize("seed", range(4))
def test_paged_streams_equal_dense(models, seed):
    """The same admission/decode/cancel schedule on the port's dense and
    paged engines yields the same greedy streams."""
    _, ct, _, pt = models
    ops = _random_ops(seed)
    dense = ServeEngine(ct, pt, device="cpu", **KW)
    paged = _paged(ct, pt)
    rd, _ = _schedule(dense, Request, ops)
    rp, _ = _schedule(paged, Request, ops)
    paged.check_pool()
    assert rd == rp


def test_shared_prefix_admission_copies_nothing(models):
    _, ct, _, pt = models
    eng = _paged(ct, pt)
    prompt = PROMPTS[4]                   # 8 tokens = 2 full pages
    eng.admit(Request("a", prompt, 2))
    before = dict(eng.pool.stats)
    eng.admit(Request("b", prompt, 2))
    after = eng.pool.stats
    assert after["shared_maps"] - before["shared_maps"] == 2
    assert after["cow_copies"] == before["cow_copies"] == 0
    assert (after["fresh_allocs"] + after["recycled_allocs"]
            == before["fresh_allocs"] + before["recycled_allocs"])
    assert list(eng.block_tables[0][:2]) == list(eng.block_tables[1][:2])
    res = eng.run([])
    eng.check_pool()
    assert res["a"].tolist() == res["b"].tolist()


def test_fork_cow_parent_stream_undisturbed(models):
    _, ct, _, pt = models
    prompt = PROMPTS[5]                   # 9 tokens: partial last page
    eng = _paged(ct, pt)
    eng.admit(Request("x", prompt, 8))
    eng.fork("x", "y")
    res = eng.run([])
    eng.check_pool()
    assert eng.pool.stats["cow_copies"] >= 1
    assert res["x"].tolist() == res["y"].tolist()
    ref = ServeEngine(ct, pt, device="cpu", **KW).run(
        [Request("x", prompt, 8)])
    assert res["x"].tolist() == ref["x"].tolist()
    with pytest.raises(KeyError, match="no active request"):
        eng.fork("x", "z")


def test_cancel_recycles_pages(models):
    _, ct, _, pt = models
    eng = _paged(ct, pt, share_prefixes=False)
    eng.admit(Request("a", PROMPTS[3], 8))
    held = [int(p) for p in eng.block_tables[0] if p >= 0]
    assert held
    out = eng.cancel("a")
    assert out is not None and out.shape[0] >= 1
    assert eng.cancel("a") is None
    eng.check_pool()
    assert all(eng.pool.refcount[p] == 0 for p in held)
    eng.admit(Request("b", PROMPTS[3], 4))     # recycles, no zero-fill
    assert eng.pool.stats["recycled_allocs"] >= 1
    res = eng.run([])
    ref = ServeEngine(ct, pt, device="cpu", **KW).run(
        [Request("b", PROMPTS[3], 4)])
    assert res["b"].tolist() == ref["b"].tolist()


def test_pool_bytes_scale_with_pool_not_horizon(models):
    _, ct, _, pt = models
    sizes = {}
    for max_len in (24, 48):
        eng = PagedServeEngine(ct, pt, page_size=PS, n_pages=10,
                               device="cpu", max_slots=SLOTS,
                               max_len=max_len, chunk=CHUNK)
        sizes[max_len] = sum(x.numel() * x.element_size()
                             for x in eng.cache["scan"]["0"].values())
    assert sizes[24] == sizes[48] == PG.paged_kv_bytes(ct, 11, PS)
    assert PG.dense_kv_bytes(ct, SLOTS, 48) \
        == 2 * PG.dense_kv_bytes(ct, SLOTS, 24)


def test_check_pool_catches_a_leaked_slot(models):
    """Every place that frees a slot releases its pages; a slot freed
    without that is a leak check_pool reports."""
    _, ct, _, pt = models
    eng = _paged(ct, pt)
    eng.admit(Request("a", PROMPTS[3], 8))
    eng.admit(Request("b", PROMPTS[2], 1))     # retires on the 1-token path
    eng.step()
    eng.check_pool()
    eng.slots[0] = None                        # dropped without release
    with pytest.raises(AssertionError, match="refcount"):
        eng.check_pool()


def test_quarantine_releases_pages(models):
    _, ct, _, pt = models
    bad = dict(pt, final_norm=torch.full_like(pt["final_norm"],
                                              float("nan")))
    eng = PagedServeEngine(ct, bad, page_size=PS, device="cpu", **KW)
    eng.admit(Request("a", PROMPTS[3], 5))
    eng.step()
    assert [r for r, _ in eng.quarantined] == ["a"]
    eng.check_pool()
    assert (eng.block_tables < 0).all()
