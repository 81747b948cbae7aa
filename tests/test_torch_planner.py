"""The port's tile tuner, KV-traffic model and chunk planner against the
JAX package's, and the engines' planned chunk (``chunk=None``).

``kernels/tuning.py``, ``serve/kv_traffic.py`` and the planner's pricing
are copies: at the same shapes, configs and machines they must give the
JAX package's plans field for field. The planner is fed one trace on
both sides (the JAX decode step's HLO trace, walked into the port's
dataclasses), so the comparison holds the planning arithmetic, not the
two lowerings (``test_torch_trace.py`` holds those against each other).
Machines both packages register; the port adds ``h100``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.core import trace as JT
from repro.kernels import tuning as JTU
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import kv_traffic as JKV
from repro.serve import planner as JPL
from repro_torch.configs import get_config
from repro_torch.kernels import tuning as TTU
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.serve import kv_traffic as TKV
from repro_torch.serve import planner as TPL

from _torch_common import bridged_params, cfg_pair, trace_from_jax

torch.set_num_threads(1)

SHARED = ("tpu_v5e", "tpu_v5p", "tpu_v4", "zen4", "golden_cove",
          "neoverse_v2")


def _plain(x):
    """Results with the packages' dataclasses as plain tuples."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(v) for v in dataclasses.astuple(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("name", SHARED)
def test_tiles_match_jax(name):
    for skv in (1, 77, 128, 600, 2048, 32768):
        for dh, h, hkv in ((128, 32, 4), (256, 8, 4), (64, 32, 32)):
            for batch in (1, 8):
                for dtype in ("bfloat16", "float32", "bf16"):
                    kw = dict(skv=skv, dh=dh, h=h, hkv=hkv, batch=batch,
                              dtype=dtype)
                    for b in (None, "tp_bound", "mca_sched"):
                        assert _plain(TTU.decode_tiles(name, backend=b,
                                                       **kw)) == \
                            _plain(JTU.decode_tiles(name, backend=b, **kw))
        for s, dh, h, hkv in ((128, 128, 32, 4), (2048, 128, 32, 4),
                              (4096, 256, 8, 4), (1000, 64, 16, 16)):
            kw = dict(s=s, dh=dh, h=h, hkv=hkv)
            assert _plain(TTU.flash_tiles(name, **kw)) == \
                _plain(JTU.flash_tiles(name, **kw))


def test_fit_block_and_torch_dtype_names():
    for block in (1, 7, 128, 256, 512, 1024):
        for s in (1, 64, 1000, 1001, 2048, 4099):
            assert TTU.fit_block(block, s) == JTU.fit_block(block, s)
    kw = dict(skv=900, dh=128, h=32, hkv=4, batch=8)
    assert TTU.decode_tiles("h100", dtype=str(torch.bfloat16), **kw) == \
        TTU.decode_tiles("h100", dtype="bfloat16", **kw)
    assert TTU.default_machine() == "tpu_v5e"      # no card, no host_cpu


def test_h100_decode_tiles_take_the_kernels_tiles():
    """Every h100 plan at a served shape is a whole number of the decode
    kernel's 64-row (bf16) tiles and a split count the kernel takes."""
    for skv in range(128, 2049, 128):
        for dh, h, hkv in ((128, 32, 4), (256, 8, 4), (128, 32, 8)):
            p = TTU.decode_tiles("h100", skv=skv, dh=dh, h=h, hkv=hkv,
                                 batch=8, dtype="bfloat16")
            assert p.bk % 64 == 0 and p.n_splits in TTU.DECODE_SPLIT_CANDIDATES
            assert p.store_flavor == "standard" and p.seconds > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kv_traffic_matches_jax(arch):
    cj, ct = jax_config(arch), get_config(arch)
    m = dict(machines=SHARED)
    for f in ("attn_layer_count", "tp_reduce_count"):
        assert getattr(TKV, f)(ct) == getattr(JKV, f)(cj)
    assert TKV.kv_row_bytes(ct, 8) == JKV.kv_row_bytes(cj, 8)
    assert TKV.page_bytes(ct, 16) == JKV.page_bytes(cj, 16)
    calls = [
        ("collective_traffic", (8, 2), m),
        ("collective_traffic", (8, 4), dict(m, ws_bytes=1e9,
                                            cores_active=4)),
        ("decode_kv_profiles", (8, 2048), {}),
        ("decode_read_traffic", (8, 2048, 700), m),
        ("kv_update_traffic", (8, 2048), m),
        ("kv_update_traffic", (8, 2048), dict(m, nt_stores=True)),
        ("kv_update_traffic", (8, 2048), dict(m, flavor="auto")),
        ("page_gather_traffic", (8, 2048, 700, 16), m),
        ("cow_fork_traffic", (16,), dict(m, n_copies=3)),
        ("page_admission_traffic", (300, 2048, 16), dict(m, shared_pages=5)),
        ("rescue_traffic", (300, 120, 2048), dict(m, page_size=16)),
        ("rescue_traffic", (300, 120, 2048), m),
    ]
    for f, args, kw in calls:
        try:
            want = getattr(JKV, f)(cj, *args, **kw)
        except ZeroDivisionError:     # no attention layer: no KV bytes
            with pytest.raises(ZeroDivisionError):
                getattr(TKV, f)(ct, *args, **kw)
            continue
        assert _plain(getattr(TKV, f)(ct, *args, **kw)) == _plain(want), f
    for name in SHARED:
        for occ in (1, 300, 5000):
            assert _plain(TKV.bounded_decode_plan(ct, 8, 2048, occ, name)) \
                == _plain(JKV.bounded_decode_plan(cj, 8, 2048, occ, name))


@pytest.fixture(scope="module")
def step_traces():
    """The smoke decode step's HLO (2 slots, 64-row horizon, fp32), its
    JAX trace and the same trace as the port's dataclasses."""
    cj, ct = cfg_pair("float32")
    hlo = JPL.decode_step_hlo(cj, 2, 64)
    return cj, ct, hlo, trace_from_jax(JT.lower_text(hlo))


def _same_plan(got, want):
    """ChunkPlans field for field; the per-machine tables over the shared
    machines (the port's also price h100)."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, dict):
            assert set(SHARED) <= set(g) and set(SHARED) <= set(w)
            assert {k: g[k] for k in SHARED} == {k: w[k] for k in SHARED}, \
                f.name
            assert "h100" in g
        else:
            assert g == w, f.name


@pytest.mark.parametrize("backend", ["tp_bound", "mca_sched"])
@pytest.mark.parametrize("kw", [
    {}, {"occupancy": 20}, {"occupancy": 20, "page_size": 8},
    {"occupancy": 40, "page_size": 4, "store_flavor": "nt"}, {"tp": 2},
    {"tp": 2, "occupancy": 33}],
    ids=["dense", "occupancy", "paged", "paged-nt", "tp2", "tp2-occupancy"])
def test_plan_matches_jax_on_one_trace(step_traces, backend, kw):
    cj, ct, hlo, ttr = step_traces
    for machine in ("zen4", "tpu_v5e", "golden_cove"):
        want = JPL.plan_chunk_size(cj, 2, 64, machine=machine, hlo_text=hlo,
                                   backend=backend, **kw)
        got = TPL.plan_chunk_size(ct, 2, 64, machine=machine, trace=ttr,
                                  backend=backend, **kw)
        _same_plan(got, want)
        assert TPL.planned_round_seconds(got, 3) == \
            JPL.planned_round_seconds(want, 3)
        assert TPL.planned_round_seconds(got, machine="zen4") == \
            JPL.planned_round_seconds(want, machine="zen4")
    for name in SHARED:
        assert TPL.kv_read_seconds(ct, 2, 40, name, max_len=64, tp=2) == \
            JPL.kv_read_seconds(cj, 2, 40, name, max_len=64, tp=2)


def test_plan_memo_and_h100_plan():
    """A repeated plan is a memo hit; the h100 plan of the full-width
    yi-9b step prices it under a few ms and picks standard stores."""
    cfg = get_config("yi-9b")
    TPL.reset_plan_stats()
    a = TPL.plan_chunk_size(cfg, 8, 2048, machine="h100", occupancy=600)
    b = TPL.plan_chunk_size(cfg, 8, 2048, machine="h100", occupancy=600)
    assert a is b and TPL.plan_stats()["memo_hits"] == 1
    assert TPL.plan_stats()["online_plans"] == 1
    assert a.machine == "h100" and a.store_flavor == "standard"
    assert 1e-3 < a.t_step_seconds < 2e-2 and a.chunk >= 1
    assert a.per_machine_dense["h100"] >= a.t_step_seconds
    mca = TPL.plan_chunk_size(cfg, 8, 2048, machine="h100", occupancy=600,
                              backend="mca")
    assert mca.backend == "mca_sched" and mca.chunk <= a.chunk
    assert mca.t_step_seconds >= a.t_step_seconds
    with pytest.raises(KeyError, match="unknown machine"):
        TPL.plan_chunk_size(cfg, 8, 2048, machine="a100")


@pytest.fixture(scope="module")
def models():
    cj, ct = cfg_pair("float32")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _requests(vocab, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [(str(i), tuple(int(t) for t in rng.integers(0, vocab, n)), m)
            for i, (n, m) in enumerate(specs)]


SPECS = [(8, 6), (11, 12), (5, 1), (8, 5), (14, 7), (3, 9)]


@pytest.mark.parametrize("paged", [False, True])
def test_planned_engine_streams_as_jax(models, paged):
    """``chunk=None`` plans the chunk (engine.plan); fp32 greedy streams are
    the JAX engine's at that chunk, token for token."""
    cj, ct, pj, pt = models
    reqs = _requests(ct.vocab_size, SPECS)
    kw = dict(max_slots=2, max_len=24)
    if paged:
        eng = PagedServeEngine(ct, pt, page_size=4, device="cpu", **kw)
    else:
        eng = ServeEngine(ct, pt, device="cpu", **kw)
    assert eng.plan is not None and eng.chunk == eng.plan.chunk >= 1
    assert eng.plan.machine == "tpu_v5e" and eng.plan.occupancy == 24
    assert eng.plan.page_size == (4 if paged else None)
    assert eng.plan.store_flavor == "standard"
    got = eng.run([Request(*r) for r in reqs])
    jeng = (JPagedServeEngine(cj, pj, page_size=4, chunk=eng.chunk, **kw)
            if paged else JServeEngine(cj, pj, chunk=eng.chunk, **kw))
    want = jeng.run([JRequest(*r) for r in reqs])
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    # planned for another machine: its own plan, on its own column
    h = ServeEngine(ct, pt, device="cpu", machine="h100", **kw)
    assert h.plan.machine == "h100" and h.chunk == h.plan.chunk
    # an explicit chunk makes no plan
    assert ServeEngine(ct, pt, device="cpu", chunk=3, **kw).plan is None
