"""The port's fault injector (``repro_torch.serve.faults``) and the
engines' fault hooks (``drain_quarantined``, ``set_chunk``) against the
JAX package's.

Smoke configs in fp32 with the same weights (bridged through numpy):
``chaos_schedule`` gives JAX's specs for the same seed; NaN poison
quarantines the same request on the dense, paged and xLSTM caches, in
place; the scrub leaves healthy slots bit for bit; step and admission
faults fire at their indices; a chunk re-planned mid-flight streams as
JAX's engine does.
"""

import jax
import numpy as np
import pytest
import torch

from repro.serve import FaultSpec as JFaultSpec
from repro.serve import FaultyEngine as JFaultyEngine
from repro.serve import PagedServeEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServe
from repro.serve import chaos_schedule as jax_chaos_schedule
from repro.serve.faults import poison_slot as jax_poison
from repro.serve.faults import scrub_nonfinite as jax_scrub
from repro_torch.models.model import _walk
from repro_torch.serve import (FaultSpec, FaultyEngine, PagedServeEngine,
                               Request, ServeEngine, TransientFault,
                               chaos_schedule, poison_slot)
from repro_torch.serve.faults import scrub_nonfinite
from repro_torch.serve.pages import PoolExhausted

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)

SLOTS, MAX_LEN, CHUNK = 2, 32, 2

RATES = {"step_error": 0.06, "stuck": 0.08, "slow": 0.05,
         "nonfinite": 0.2, "admit_error": 0.08, "pool_exhausted": 0.04}


@pytest.fixture(scope="module")
def xlstm():
    cj, ct = cfg_pair("float32", "xlstm-125m")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def yi():
    cj, ct = cfg_pair("float32", "yi-9b")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _pair(models, layout, **kw):
    """(JAX engine, port engine) of one layout on the same weights."""
    cj, ct, pj, pt = models
    common = dict(max_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK, **kw)
    if layout == "paged":
        return (JPaged(cj, pj, page_size=4, **common),
                PagedServeEngine(ct, pt, page_size=4, device="cpu", **common))
    return JServe(cj, pj, **common), ServeEngine(ct, pt, device="cpu",
                                                 **common)


def _req(rid, budget=6, base=1, cls=Request):
    """Five prompt tokens: on pages of 4 the last page is partial, so it
    is the slot's own and the paged poison has a page to land on."""
    return cls(rid, tuple(range(base, base + 5)), budget)


def _ptrs(eng) -> list:
    return [t.data_ptr() for _, t in _walk(eng.cache)]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_chaos_schedule_equals_jax(seed):
    want = jax_chaos_schedule(seed, 40, RATES, slots=SLOTS)
    got = chaos_schedule(seed, 40, RATES, slots=SLOTS)
    assert [(f.kind, f.at, f.slot, f.factor) for f in got] == \
        [(f.kind, f.at, f.slot, f.factor) for f in want]
    assert any(f.kind == "nonfinite" for f in got)


def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultSpec("meteor_strike", frozenset({1}))
    with pytest.raises(ValueError):
        JFaultSpec("meteor_strike", frozenset({1}))


def test_step_error_stuck_and_slow(xlstm):
    _, eng_t = _pair(xlstm, "dense")
    eng = FaultyEngine(
        eng_t,
        [FaultSpec("step_error", frozenset({0})),
         FaultSpec("stuck", frozenset({1})),
         FaultSpec("slow", frozenset({2}), factor=7.0)],
        budget_s=1e-3)
    eng.admit(_req("a"))
    with pytest.raises(TransientFault):
        eng.step()
    before = list(eng.slots[0].out)
    assert eng.step() == []                       # stuck: no progress
    assert eng.slots[0].out == before
    assert eng.last_step_seconds == pytest.approx(50e-3)
    eng.step()                                    # slow: progresses
    assert len(eng.slots[0].out) > len(before)
    assert eng.last_step_seconds == pytest.approx(7e-3)
    eng.step()                                    # healthy again
    assert eng.last_step_seconds == pytest.approx(1e-3)
    assert eng.injected == {"step_error": 1, "stuck": 1, "slow": 1}


def test_admission_faults(xlstm):
    _, eng_t = _pair(xlstm, "dense")
    eng = FaultyEngine(
        eng_t, [FaultSpec("admit_error", frozenset({0})),
                FaultSpec("pool_exhausted", frozenset({1}))], budget_s=1e-3)
    with pytest.raises(TransientFault):
        eng.admit(_req("a"))
    with pytest.raises(PoolExhausted):
        eng.admit(_req("a"))
    assert eng.admit(_req("a")) == 0              # third attempt lands


def test_faulty_engine_delegates_and_budgets_from_the_plan(xlstm):
    cj, ct, pj, pt = xlstm
    inner = ServeEngine(ct, pt, max_slots=SLOTS, max_len=MAX_LEN,
                        machine="neoverse_v2", device="cpu")
    eng = FaultyEngine(inner, [])
    from repro_torch.serve.planner import planned_round_seconds
    assert eng.budget_s == planned_round_seconds(inner.plan,
                                                 chunk=inner.chunk)
    assert eng.max_slots == SLOTS and eng.chunk == inner.chunk
    eng.admit(_req("a"))
    assert eng.free_slots() == [1]
    assert eng.cancel("a") is not None
    eng.set_chunk(3)                              # delegated mutator
    assert inner.chunk == 3 and eng.chunk == 3


@pytest.mark.parametrize("models,layout", [
    ("yi", "dense"), ("yi", "paged"), ("xlstm", "dense"),
    ("xlstm", "paged")])
def test_poison_quarantines_the_same_request_as_jax(models, layout,
                                                    request):
    m = request.getfixturevalue(models)
    eng_j, eng_t = _pair(m, layout)
    for eng, cls in ((eng_j, JRequest), (eng_t, Request)):
        eng.admit(_req("victim", base=1, cls=cls))
        eng.admit(_req("bystander", base=2, cls=cls))
    ptrs = _ptrs(eng_t)
    jax_poison(eng_j, 0)
    poison_slot(eng_t, 0)
    assert _ptrs(eng_t) == ptrs                   # in place
    assert any(bool(torch.isnan(t).any()) for _, t in _walk(eng_t.cache))
    assert eng_j.step() == eng_t.step() == []
    qj, qt = eng_j.drain_quarantined(), eng_t.drain_quarantined()
    assert [r for r, _ in qt] == [r for r, _ in qj] == ["victim"]
    assert [t.tolist() for _, t in qt] == [t.tolist() for _, t in qj]
    assert eng_t.drain_quarantined() == [] and eng_t.quarantined == []
    assert eng_t.slots[0] is None and eng_t.slots[1] is not None
    jax_scrub(eng_j)
    scrub_nonfinite(eng_t)
    assert _ptrs(eng_t) == ptrs
    assert all(bool(torch.isfinite(t).all()) for _, t in _walk(eng_t.cache)
               if t.is_floating_point())
    want, got = {}, {}
    for _ in range(8):
        want.update({r: t.tolist() for r, t in eng_j.step()})
        got.update({r: t.tolist() for r, t in eng_t.step()})
    assert got == want and "bystander" in got


@pytest.mark.parametrize("models", ["yi", "xlstm"])
def test_scrub_keeps_healthy_rows_bit_exact(models, request):
    _, eng = _pair(request.getfixturevalue(models), "dense")
    eng.admit(_req("a", base=1))
    eng.admit(_req("b", base=2))
    before = [t.clone() for _, t in _walk(eng.cache)]
    poison_slot(eng, 0)
    scrub_nonfinite(eng)
    for b, (_, a) in zip(before, _walk(eng.cache)):
        assert bool(torch.isfinite(a).all())
        if a.dim() >= 2 and a.shape[1] == SLOTS:  # slot-batched leaf
            assert torch.equal(a[:, 1], b[:, 1])
            assert bool((a[:, 0] == 0).all())    # the poison, scrubbed


def test_poison_rejects_a_slot_out_of_range(xlstm):
    _, eng = _pair(xlstm, "dense")
    with pytest.raises(ValueError):
        poison_slot(eng, SLOTS)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_set_chunk_mid_flight_streams_as_jax(yi, layout):
    """Chunk 2, then 3, then 2 again, with requests in flight: the same
    streams as JAX's engine re-planned at the same rounds; the port keeps
    each chunk length's body and takes it back for a length seen before."""
    eng_j, eng_t = _pair(yi, layout)
    rng = np.random.default_rng(5)
    specs = [(tuple(int(t) for t in rng.integers(0, 512, n)), m)
             for n, m in [(6, 9), (9, 12), (5, 7), (7, 10)]]
    for eng, cls in ((eng_j, JRequest), (eng_t, Request)):
        eng.admit(cls("a", *specs[0]))
        eng.admit(cls("b", *specs[1]))
    body2 = eng_t._chunks[2][0]
    want, got = {}, {}
    pending = [(f"r{i}",) + s for i, s in enumerate(specs[2:])]
    for rnd in range(12):
        if rnd in (1, 3):
            chunk = 3 if rnd == 1 else 2
            eng_j.set_chunk(chunk)
            eng_t.set_chunk(chunk)
        want.update({r: t.tolist() for r, t in eng_j.step()})
        got.update({r: t.tolist() for r, t in eng_t.step()})
        while pending and eng_t.free_slots():
            rid, prompt, m = pending.pop(0)
            eng_j.admit(JRequest(rid, prompt, m))
            eng_t.admit(Request(rid, prompt, m))
    assert got == want and len(got) == 4
    assert eng_t.chunk_lengths == [2, 3]
    assert eng_t._chunks[2][0] is body2 and eng_t._body is body2
    assert eng_t.captured_graphs() == 0           # a CPU engine runs eagerly


def test_faultless_wrapper_streams_as_jax_wrapper(xlstm):
    eng_j, eng_t = _pair(xlstm, "dense")
    wj = JFaultyEngine(eng_j, [], budget_s=1e-3)
    wt = FaultyEngine(eng_t, [], budget_s=1e-3)
    for w, cls in ((wj, JRequest), (wt, Request)):
        w.admit(_req("a", base=1, cls=cls))
        w.admit(_req("b", base=3, cls=cls))
    want, got = {}, {}
    for _ in range(4):
        want.update({r: t.tolist() for r, t in wj.step()})
        got.update({r: t.tolist() for r, t in wt.step()})
    assert got == want and set(got) == {"a", "b"}
    assert jax.tree.leaves(eng_j.cache)           # both sides stepped
