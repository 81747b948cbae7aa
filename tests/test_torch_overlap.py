"""The port's overlapped serving runtime against the JAX package's
(``tests/test_overlap.py``): pipelined decode dispatch is a scheduling
change only (streams and dispatch counts byte-identical to serial, dense
and paged, greedy and sampled, through the router; fp32 greedy pipelined
streams equal to the JAX engine's pipelined streams, MoE included), cancel
and fork consume the rounds in flight, ``set_chunk`` and a quarantine
with rounds in flight stream as JAX's pipelined engine, the dispatch gap
is measured, prompt staging hits, misses and evicts, and snapshots skip
while a write is busy.

The reference's ``test_serial_keeps_donation_pipelined_does_not`` has no
counterpart: the port writes its cache in place in both modes, so there
is no donation to give up (``serve/engine.py``'s docstring).
"""

import os

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.serve import PagedServeEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServe
from repro.serve.faults import poison_slot as jax_poison
from repro.serve.faults import scrub_nonfinite as jax_scrub
from repro_torch.checkpoint import Checkpointer
from repro_torch.serve import (PagedServeEngine, ReplicaRouter, Request,
                               ServeEngine)
from repro_torch.serve.faults import poison_slot, scrub_nonfinite
from repro_torch.serve.staging import PromptStager

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)

SLOTS, MAX_LEN, CHUNK = 3, 40, 2


@pytest.fixture(scope="module")
def yi():
    """(JAX cfg, port cfg, JAX params, port params): smoke yi-9b, fp32."""
    cj, ct = cfg_pair("float32", "yi-9b")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _requests(cfg, n, seed=1, budgets=(9, 7, 11), cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", tuple(int(t) for t in
                               rng.integers(0, cfg.vocab_size, 6 + (i % 3))),
                budgets[i % len(budgets)])
            for i in range(n)]


def _streams(results):
    return {rid: [int(t) for t in toks] for rid, toks in results.items()}


def _drain(eng):
    out = {}
    while any(s is not None for s in eng.slots):
        out.update(_streams(dict(eng.step())))
    return out


def _engine(ct, pt, *, paged=False, pipeline=0, **kw):
    cls = PagedServeEngine if paged else ServeEngine
    if paged:
        kw.setdefault("page_size", 8)
    return cls(ct, pt, max_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
               pipeline=pipeline, device="cpu", **kw)


def _jax_engine(cj, pj, *, paged=False, pipeline=0, **kw):
    cls = JPaged if paged else JServe
    if paged:
        kw.setdefault("page_size", 8)
    return cls(cj, pj, max_slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
               pipeline=pipeline, **kw)


# -- byte identity ----------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_pipelined_streams_byte_identical(yi, paged, temperature):
    """Serial against pipeline=2, more requests than slots (admissions
    while rounds are in flight): identical streams and dispatch counts."""
    _, ct, _, pt = yi
    reqs = _requests(ct, 2 * SLOTS)
    out = {}
    for pipeline in (0, 2):
        eng = _engine(ct, pt, paged=paged, pipeline=pipeline,
                      temperature=temperature, seed=3)
        out[pipeline] = (_streams(eng.run(list(reqs))),
                         eng.decode_dispatches, eng.prefill_dispatches)
        assert eng.stats()["in_flight"] == 0
        if paged:
            eng.check_pool()
    assert out[0][0] == out[2][0]
    assert out[0][1:] == out[2][1:]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("pipeline", [2, 3])
def test_pipelined_streams_match_jax_pipelined(yi, paged, pipeline):
    """fp32 greedy: the port's pipelined streams and dispatch counts equal
    the JAX engine's at the same in-flight bound."""
    cj, ct, pj, pt = yi
    eng_j = _jax_engine(cj, pj, paged=paged, pipeline=pipeline)
    eng_t = _engine(ct, pt, paged=paged, pipeline=pipeline)
    want = _streams(eng_j.run(_requests(cj, 2 * SLOTS, cls=JRequest)))
    got = _streams(eng_t.run(_requests(ct, 2 * SLOTS)))
    assert got == want
    assert eng_t.decode_dispatches == eng_j.decode_dispatches


def test_moe_pipelined_streams_match_jax_pipelined():
    """jamba (MoE with finite capacity, fp32): a free slot's fed token
    takes expert capacity and differs between the modes, so the pipelined
    streams are held against the JAX engine's pipelined streams."""
    cj, ct = cfg_pair("float32", "jamba-v0.1-52b")
    pj, pt = bridged_params(cj, ct)
    rng = np.random.default_rng(3)
    specs = [(f"m{i}", tuple(int(t) for t in rng.integers(0, ct.vocab_size,
                                                          n)), m)
             for i, (n, m) in enumerate([(20, 14), (30, 9), (20, 6),
                                         (30, 1), (20, 12)])]
    kw = dict(max_slots=2, max_len=48, chunk=3, pipeline=2)
    want = _streams(JServe(cj, pj, **kw).run([JRequest(*s) for s in specs]))
    got = _streams(ServeEngine(ct, pt, device="cpu", **kw).run(
        [Request(*s) for s in specs]))
    assert got == want


def test_router_pipelined_identical(yi):
    """The router's path: pipelined replicas retire the serial replicas'
    streams, and stats() shows each replica's pipeline and gap."""
    _, ct, _, pt = yi
    reqs = _requests(ct, 8, seed=5)
    out = {}
    for pipeline in (0, 2):
        engines = [_engine(ct, pt, pipeline=pipeline, seed=2)
                   for _ in range(2)]
        router = ReplicaRouter(engines, policy="round_robin", max_queue=8)
        out[pipeline] = _streams(router.run(list(reqs)))
        for row in router.stats():
            assert row["pipeline"] == pipeline
            assert row["mean_dispatch_gap_s"] >= 0.0
        # submit staged every prompt; admissions took them from the queue
        st = [e.stats()["staging"] for e in engines]
        assert sum(s["hits"] for s in st) == len(reqs)
        assert sum(s["misses"] for s in st) == 0
    assert out[0] == out[2]


def test_cancel_and_fork_sync_inflight(yi):
    """cancel() and the paged fork() first consume the rounds in flight,
    so the tokens returned and the streams after are the serial engine's
    and the JAX pipelined engine's."""
    cj, ct, pj, pt = yi
    got = {}
    engines = [(0, _engine(ct, pt, paged=True, pipeline=0), Request),
               (2, _engine(ct, pt, paged=True, pipeline=2), Request),
               ("jax", _jax_engine(cj, pj, paged=True, pipeline=2),
                JRequest)]
    for key, eng, cls in engines:
        for r in _requests(ct, SLOTS, budgets=(12, 12, 12), cls=cls):
            eng.admit(r)
        eng.step()
        eng.step()
        if key == 2:
            assert eng.stats()["in_flight"] == 2
        toks = eng.cancel("r1")
        if key == 2:
            assert eng.stats()["in_flight"] == 0
        eng.fork("r0", "r0b", max_new_tokens=3)
        got[key] = ([int(x) for x in toks], _drain(eng))
        if key != "jax":
            eng.check_pool()
    assert got[0] == got[2] == got["jax"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_set_chunk_with_rounds_in_flight(yi, paged):
    """Chunk 2, then 3 with two rounds in flight, then 2 again: the
    streams of a serial engine and of JAX's pipelined engine under the
    same schedule; the chained feed crosses between the chunk lengths'
    bodies with no sync."""
    cj, ct, pj, pt = yi
    rng = np.random.default_rng(5)
    specs = [(tuple(int(t) for t in rng.integers(0, 512, n)), m)
             for n, m in [(6, 13), (9, 16), (5, 7), (7, 10)]]
    runs = {}
    for key, eng, cls in (
            ("serial", _engine(ct, pt, paged=paged), Request),
            ("pipelined", _engine(ct, pt, paged=paged, pipeline=2), Request),
            ("jax", _jax_engine(cj, pj, paged=paged, pipeline=2),
             JRequest)):
        eng.admit(cls("a", *specs[0]))
        eng.admit(cls("b", *specs[1]))
        out, pending = {}, [(f"r{i}",) + s for i, s in enumerate(specs[2:])]
        for rnd in range(14):
            if rnd in (2, 4):
                if key == "pipelined" and rnd == 2:
                    assert eng.stats()["in_flight"] == 2
                eng.set_chunk(3 if rnd == 2 else 2)
            out.update(_streams(dict(eng.step())))
            while pending and eng.free_slots():
                rid, prompt, m = pending.pop(0)
                eng.admit(cls(rid, prompt, m))
        runs[key] = out
    assert runs["serial"] == runs["pipelined"] == runs["jax"]
    assert len(runs["jax"]) == 4


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_quarantine_in_pipelined_mode(yi, paged):
    """A NaN poison with rounds in flight quarantines the victim when its
    poisoned round is consumed, with the tokens of the rounds before it;
    the rounds dispatched after are skipped for it, and the bystander
    streams on (the pool scrubbed once the victim is out, as the
    fault-tolerant router does): as JAX's pipelined engine does."""
    cj, ct, pj, pt = yi
    res = {}
    for key, eng, cls in (
            ("port", _engine(ct, pt, paged=paged, pipeline=2), Request),
            ("jax", _jax_engine(cj, pj, paged=paged, pipeline=2),
             JRequest)):
        eng.admit(cls("victim", tuple(range(1, 6)), 14))
        eng.admit(cls("bystander", tuple(range(2, 7)), 14))
        assert eng.step() == [] and eng.step() == []
        (poison_slot if key == "port" else jax_poison)(eng, 0)
        got, quarantined = {}, []
        for _ in range(10):
            got.update(_streams(dict(eng.step())))
            q = eng.drain_quarantined()
            if q:
                # the router's cleanup: the victim's NaN pages go back to
                # the pool, where the bystander's next page may come from
                (scrub_nonfinite if key == "port" else jax_scrub)(eng)
            quarantined += [(r, [int(x) for x in t]) for r, t in q]
        res[key] = (got, quarantined)
    assert res["port"] == res["jax"]
    got, quarantined = res["port"]
    assert [r for r, _ in quarantined] == ["victim"]
    assert "bystander" in got and len(got["bystander"]) == 14


# -- dispatch-gap stats -------------------------------------------------------

def test_dispatch_gap_measured(yi):
    _, ct, _, pt = yi
    eng = _engine(ct, pt, pipeline=2)
    stats = eng.stats()
    assert stats["gap_rounds"] == 0 and stats["mean_dispatch_gap_s"] == 0.0
    eng.run(_requests(ct, SLOTS))
    stats = eng.stats()
    assert stats["pipeline"] == 2
    assert stats["gap_rounds"] > 0
    assert stats["mean_dispatch_gap_s"] > 0.0
    assert stats["in_flight"] == 0          # run() drains


# -- prompt staging -----------------------------------------------------------

def test_stager_hit_miss_and_fallback():
    st = PromptStager(depth=2, device="cpu")
    assert st.stage("a", (1, 2, 3)) is True
    assert st.stage("a", (1, 2, 3)) is False       # refreshed, no copy
    assert st.take("a", (1, 2, 3)).tolist() == [[1, 2, 3]]
    st.stage("b", (4, 5))
    # prompt mismatch: staged tokens never win over the request's
    assert st.take("b", (9, 9)).tolist() == [[9, 9]]
    # an unstaged rid stages inline
    got = st.take("c", (7,))
    assert got.tolist() == [[7]] and got.dtype == torch.int64
    s = st.stats()
    assert s == {"staged": 2, "hits": 1, "misses": 2, "queued": 0}


def test_stager_depth_eviction_and_discard():
    st = PromptStager(depth=2, device="cpu")
    for i, rid in enumerate(("a", "b", "c")):
        st.stage(rid, (i,))
    assert st.stats()["queued"] == 2        # the oldest ("a") evicted
    assert st.take("a", (0,)).tolist() == [[0]]
    assert st.stats()["misses"] == 1
    st.discard("b")
    assert st.stats()["queued"] == 1
    assert st.take("c", (2,)).tolist() == [[2]]
    assert st.stats()["hits"] == 1


def test_engine_staging_used_on_admit(yi):
    """A staged admission counts as a hit and streams as an identical
    engine admitting the request unstaged."""
    _, ct, _, pt = yi
    reqs = _requests(ct, 2)
    eng = _engine(ct, pt)
    assert eng.stage(reqs[0]) is True
    eng.admit(reqs[0])
    eng.admit(reqs[1])                      # never staged: a miss
    s = eng.stats()["staging"]
    assert s["hits"] == 1 and s["misses"] == 1
    eng2 = _engine(ct, pt)
    eng2.admit(reqs[0])
    assert _drain(eng)[reqs[0].rid] == _drain(eng2)[reqs[0].rid]


def test_run_stages_the_next_admissions(yi):
    """run()'s look-ahead stages pending prompts while rounds decode:
    every admission after the first batch is a hit."""
    _, ct, _, pt = yi
    eng = _engine(ct, pt, pipeline=2)
    reqs = _requests(ct, 3 * SLOTS)
    eng.run(reqs)
    s = eng.stats()["staging"]
    assert s["hits"] == len(reqs) - SLOTS and s["queued"] == 0


def test_cancel_discards_staged_prompt(yi):
    _, ct, _, pt = yi
    eng = _engine(ct, pt)
    req = _requests(ct, 1)[0]
    eng.stage(req)
    assert eng.cancel(req.rid) is None      # never admitted
    assert eng.stager.stats()["queued"] == 0


# -- opportunistic snapshots --------------------------------------------------

def test_snapshot_skip_if_busy(yi, tmp_path):
    """A snapshot while the previous write runs is skipped, not waited
    for; after wait() the next lands, and restores bit for bit, also
    through the JAX package's Checkpointer."""
    _, ct, _, pt = yi
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=2)
    eng = _engine(ct, pt, pipeline=2)
    eng.admit(_requests(ct, 1)[0])
    eng.step()
    assert eng.snapshot(ckpt, step=0) is True
    saved = eng.snapshot(ckpt, step=1)
    ckpt.wait()
    assert eng.snapshot(ckpt, step=2) is True
    ckpt.wait()
    steps = ckpt.all_steps()
    assert 2 in steps
    if not saved:
        assert 1 not in steps
    assert eng.stats()["in_flight"] == 1          # the snapshot synced none
    step, back = ckpt.restore_latest({"params": pt})
    assert step == 2
    for (_, a), (_, b) in zip(_walk(back["params"]), _walk(pt)):
        assert torch.equal(a, b)
    assert os.path.isdir(tmp_path / "ck")
    _, jback = JCheckpointer(str(tmp_path / "ck")).restore_latest(
        {"params": _as_numpy(pt)})
    for (_, a), (_, b) in zip(_walk(jback["params"]), _walk(pt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _as_numpy(tree):
    return {k: _as_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}
