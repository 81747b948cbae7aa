"""The PyTorch port's ServeEngine against the JAX ServeEngine.

Smoke yi-9b in fp32 with the same weights (bridged through numpy): greedy
token streams must be identical, token for token, across chunk sizes,
mixed prompt lengths, mid-flight admission into freed slots, 1-token
budgets and the batched-admission path. Sampled streams cannot match
``jax.random``; they are held to the port's own invariants instead.
"""

import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import make_chunked_decode_step as jax_chunked_step
from repro.train import serve as jax_serve
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.decode import make_chunked_decode_step
from repro_torch.train.serve import make_prefill_step

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)

# (prompt length, max_new_tokens): 6 requests on 2 slots, so later ones
# are admitted mid-flight at other slots' positions; one 1-token budget
SPECS = [(8, 6), (11, 12), (5, 1), (8, 5), (14, 7), (3, 9)]


@pytest.fixture(scope="module")
def models():
    cj, ct = cfg_pair("float32")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _requests(vocab, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [(str(i), tuple(int(t) for t in rng.integers(0, vocab, n)), m)
            for i, (n, m) in enumerate(specs)]


def _jax_run(cj, pj, reqs, **kw):
    eng = JServeEngine(cj, pj, **kw)
    return eng.run([JRequest(*r) for r in reqs])


def _torch_run(ct, pt, reqs, **kw):
    eng = ServeEngine(ct, pt, device="cpu", **kw)
    return eng.run([Request(*r) for r in reqs]), eng


@pytest.mark.parametrize("chunk", [1, 3])
def test_greedy_streams_match_jax(models, chunk):
    cj, ct, pj, pt = models
    reqs = _requests(ct.vocab_size, SPECS)
    want = _jax_run(cj, pj, reqs, max_slots=2, max_len=24, chunk=chunk)
    got, eng = _torch_run(ct, pt, reqs, max_slots=2, max_len=24, chunk=chunk)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tolist() == want[rid].tolist(), rid
    assert got["2"].tolist() == want["2"].tolist() and len(got["2"]) == 1
    assert eng.stats()["prefill_dispatches"] == len(reqs)


def test_batched_admission_matches_jax(models):
    """All slots free and equal prompt lengths: one batched prefill."""
    cj, ct, pj, pt = models
    reqs = _requests(ct.vocab_size, [(9, 7), (9, 4), (9, 10)], seed=1)
    want = _jax_run(cj, pj, reqs, max_slots=3, max_len=20, chunk=2)
    got, eng = _torch_run(ct, pt, reqs, max_slots=3, max_len=20, chunk=2)
    assert eng.prefill_dispatches == 1
    for rid in want:
        assert got[rid].tolist() == want[rid].tolist(), rid


def test_chunked_decode_step_matches_jax(models):
    cj, ct, pj, pt = models
    import jax
    import jax.numpy as jnp
    toks = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 6))
    _, cache_j = jax_serve.make_prefill_step(cj, cache_len=16)(
        pj, {"tokens": jnp.asarray(toks)})
    _, cache_t = make_prefill_step(ct, cache_len=16)(
        pt, {"tokens": torch.tensor(toks)})
    first = np.array([[3], [77]])
    pos = np.array([6, 6], np.int32)
    want, _, wpos = jax_chunked_step(cj, 4)(pj, cache_j, jnp.asarray(first),
                                            jnp.asarray(pos),
                                            jax.random.PRNGKey(0))
    got, _, gpos, ok = make_chunked_decode_step(ct, 4)(
        pt, cache_t, torch.tensor(first), torch.tensor(pos), kv_len=10)
    assert got.tolist() == np.asarray(want).tolist()
    assert gpos.tolist() == np.asarray(wpos).tolist() and bool(ok.all())


def test_admission_checks(models):
    _, ct, _, pt = models
    eng = ServeEngine(ct, pt, max_slots=1, max_len=12, chunk=2, device="cpu")
    with pytest.raises(ValueError, match="prompt ids must be in"):
        eng.admit(Request("oov", (1, ct.vocab_size), 2))
    with pytest.raises(ValueError, match="prompt ids must be in"):
        eng.admit(Request("neg", (-1, 4), 2))
    with pytest.raises(ValueError, match="exceeds the slot horizon"):
        eng.admit(Request("long", (1,) * 10, 4))
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        eng.admit(Request("none", (1, 2), 0))
    assert eng.free_slots() == [0]


def test_cancel_and_cache_in_place(models):
    _, ct, _, pt = models
    eng = ServeEngine(ct, pt, max_slots=2, max_len=24, chunk=3, device="cpu")
    (_, p0, _), (_, p1, _) = _requests(ct.vocab_size, [(6, 9), (4, 9)])
    eng.admit(Request("a", p0, 9))
    eng.admit(Request("b", p1, 9))
    ptrs = [t.data_ptr() for t in eng.cache["scan"]["0"].values()]
    eng.step()
    assert [t.data_ptr() for t in eng.cache["scan"]["0"].values()] == ptrs
    out = eng.cancel("a")
    assert out is not None and len(out) == 4     # prefill token + one chunk
    assert eng.cancel("a") is None and eng.free_slots() == [0]


def test_sampled_streams_are_per_request(models):
    """Same seed -> same streams; a request's stream does not depend on
    its slot, its admission order or its batchmates."""
    _, ct, _, pt = models
    reqs = _requests(ct.vocab_size, SPECS[:4], seed=3)
    kw = dict(max_len=24, chunk=3, temperature=0.9, seed=11)
    a, _ = _torch_run(ct, pt, reqs, max_slots=2, **kw)
    b, _ = _torch_run(ct, pt, reqs, max_slots=2, **kw)
    c, _ = _torch_run(ct, pt, reqs[::-1], max_slots=3, **kw)
    d, _ = _torch_run(ct, pt, reqs, max_slots=2, **dict(kw, seed=12))
    for rid in a:
        assert a[rid].tolist() == b[rid].tolist() == c[rid].tolist()
        assert 0 <= a[rid].min() and a[rid].max() < ct.vocab_size
    assert any(a[rid].tolist() != d[rid].tolist() for rid in a)


def test_nonfinite_guard_quarantines(models):
    _, ct, _, pt = models
    bad = dict(pt, final_norm=torch.full_like(pt["final_norm"], float("nan")))
    eng = ServeEngine(ct, bad, max_slots=2, max_len=16, chunk=2, device="cpu")
    res = eng.run([Request(*r) for r in _requests(ct.vocab_size,
                                                  [(4, 5), (5, 5)])])
    assert res == {} and sorted(r for r, _ in eng.quarantined) == ["0", "1"]
