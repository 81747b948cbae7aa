"""The port's serving and ladder benchmarks (``repro_torch.bench``: fig2,
fig5-fig10) against the reference's ``benchmarks/``, and the runner's
device rule.

What the benchmarks price is held equal to the reference's on the same
configs: fig5's ladder rows, fig7's KV-read traffic and paper-scale KV
seconds, fig8's dense and paged KV bytes and page traffic, fig9's
traces and collective ordering, fig10's fault schedules. What they
measure is held to run: the runner refuses without a card unless
``--device cpu`` asks for the host.
"""

import os
import sys

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.serve import kv_traffic as JKV
from repro.serve import pages as JP
from repro_torch.bench import (fig2_unitmix, fig5_memladder, fig7_decode,
                               fig8_paged, fig9_load, fig10_chaos)
from repro_torch.bench import run as bench_run
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serve import kv_traffic as KV

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks import fig5_memladder as ref5  # noqa: E402
from benchmarks import fig7_decode as ref7  # noqa: E402
from benchmarks import fig8_paged as ref8  # noqa: E402
from benchmarks import fig9_load as ref9  # noqa: E402
from benchmarks import fig10_chaos as ref10  # noqa: E402

torch.set_num_threads(1)

PAPER_CPUS = ("zen4", "golden_cove", "neoverse_v2")


def _close(got, want, rel=1e-12):
    """Rows equal: strings and ints exactly, floats within ``rel``."""
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=rel, abs=0.0), k
        else:
            assert got[k] == v, k


# --- fig5 --------------------------------------------------------------------

@pytest.mark.parametrize("nt", [False, True])
def test_fig5_rows_equal_reference(nt):
    got, want = fig5_memladder.ladder_rows(nt), ref5.ladder_rows(nt)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _close(g, w)
    assert fig5_memladder.ordering_ok(got) == ref5.ordering_ok(want)


def test_fig5_lines_hold_the_reference_and_the_card():
    got = fig5_memladder.main(quick=False, device="cpu")
    want = ref5.main(quick=False)
    assert [ln for ln in got if ".h100." not in ln
            and not ln.startswith("fig5,h100.")] == want
    card = [ln for ln in got if ln.startswith("fig5,h100.")]
    assert len(card) == 4 and "home=HBM3" in card[-1]


# --- fig7 --------------------------------------------------------------------

@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
@pytest.mark.parametrize("occ", [64, 512, 1024])
def test_fig7_kv_read_traffic_equals_reference(arch_cfg, occ):
    if arch_cfg == "smoke":
        cj, ct, batch, max_len = (jax_smoke("yi-9b"), get_smoke_config(
            "yi-9b"), 4, 1024)
    else:
        cj, ct, batch, max_len = (jax_config("yi-9b"), get_config("yi-9b"),
                                  8, 4096)
    want = {r["machine"]: r for r in JKV.decode_read_traffic(
        cj, batch, max_len, occ, machines=PAPER_CPUS)}
    got = {r["machine"]: r for r in KV.decode_read_traffic(
        ct, batch, max_len, occ, machines=PAPER_CPUS)}
    for name in PAPER_CPUS:
        _close(got[name], want[name])


def test_fig7_paper_scale_lines_equal_reference():
    got = fig7_decode.paper_scale_lines()
    assert got[:3] == ref7.paper_scale_lines()
    assert got[3].startswith("fig7,pred_kv_full.h100,")


def test_fig7_gate_reads_the_decode_call():
    """The gate judges the decode call's time (``k_*``) and raises where
    the bounded path does not grow with occupancy or loses at low
    occupancy."""
    def rec(k_split, k_dense):
        cells = [{"occ": o, "occ_frac": o / 1024, "k_split": s,
                  "k_dense": d, "t_split": 1.0, "t_dense": 1.0}
                 for o, s, d in zip((64, 256, 512, 1024), k_split, k_dense)]
        return {"batch": 4, "cells": cells,
                "kv_rows": [{"machine": m, "read_ratio": 2.0}
                            for m in PAPER_CPUS]}
    assert "occupancy_bound=OK" in fig7_decode.gate(
        rec((1, 2, 3, 4), (5, 5, 5, 5)))
    with pytest.raises(AssertionError, match="occupancy-bound"):
        fig7_decode.gate(rec((4, 2, 3, 3), (5, 5, 5, 5)))
    with pytest.raises(AssertionError, match="low occupancy"):
        fig7_decode.gate(rec((1, 6, 7, 8), (5, 5, 5, 5)))


# --- fig8 --------------------------------------------------------------------

def test_fig8_memory_lines_equal_reference():
    assert fig8_paged.memory_lines(get_smoke_config("yi-9b")) == \
        ref8.memory_lines(jax_smoke("yi-9b"))
    # the card's cell priced on the published config: the same bytes
    full = fig8_paged.memory_lines(get_config("yi-9b"), fig8_paged.CARD)
    jc = jax_config("yi-9b")
    for hor in fig8_paged.CARD["mem_horizons"]:
        assert f"dense={JP.dense_kv_bytes(jc, 8, hor)};" \
            f"paged={JP.paged_kv_bytes(jc, 8 * 32, 16)};" in \
            next(ln for ln in full if f"hor{hor}," in ln)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b"])
def test_fig8_page_pricing_equals_reference(arch):
    cj, ct = jax_smoke(arch), get_smoke_config(arch)
    for fn, args in ((KV.page_gather_traffic, (2, 256, 64, 8)),
                     (KV.cow_fork_traffic, (8,)),
                     (KV.page_admission_traffic, (64, 256, 8))):
        want = getattr(JKV, fn.__name__)(cj, *args, machines=PAPER_CPUS)
        got = fn(ct, *args, machines=PAPER_CPUS)
        for g, w in zip(got, want):
            _close(g, w)
    assert KV.page_bytes(ct, 8) == JKV.page_bytes(cj, 8)
    for args in [(7, 9, 3, 4, 6), (200, 40, 8, 16, 128), (5, 1, 2, 4, 4)]:
        assert fig8_paged._expected_gather(*args) == \
            ref8._expected_gather(*args)


# --- fig9 --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [7, 42])
def test_fig9_trace_equals_reference(kind, seed):
    assert fig9_load.make_trace(kind, 16, seed) == \
        ref9.make_trace(kind, 16, seed)
    with pytest.raises(ValueError):
        fig9_load.make_trace("uniform", 4, seed)


@pytest.mark.parametrize("arch", ["gemma3-4b", "yi-9b"])
def test_fig9_sharding_gates_equal_reference(arch):
    assert fig9_load._sharding_gates(get_smoke_config(arch)) == \
        ref9._sharding_gates(jax_smoke(arch))
    for tp in (2, 4):
        want = JKV.collective_traffic(jax_smoke(arch), 2, tp)
        got = KV.collective_traffic(get_smoke_config(arch), 2, tp)
        shared = {r["machine"]: r for r in got}
        for w in want:
            _close(shared[w["machine"]], w)


def test_fig10_fault_schedules_equal_reference():
    for k in (0, 4, 9):
        got = fig10_chaos.chaos_faults(k)
        want = ref10.chaos_faults(k)
        assert [[(f.kind, f.at, f.slot, f.factor) for f in r] for r in got] \
            == [[(f.kind, f.at, f.slot, f.factor) for f in r] for r in want]


def test_fig10_chaos_run_replans_through_set_chunk():
    """fig10's chaos run on replicas planned on ``h100`` (the card's plan
    machine; smoke xlstm-125m here): the pool exhaustion's priced
    decision is a replan, it lands through ``set_chunk`` (the replica
    keeps both chunk lengths), and the reference's gates hold."""
    from repro_torch.bench._common import model
    cfg, params = model(fig10_chaos.ARCH, "cpu")
    engines = fig10_chaos.build_engines(cfg, params, slots=fig10_chaos.SLOTS,
                                        machine="h100", device="cpu")
    out = fig10_chaos.chaos_record(engines, "poisson", 16, cfg.vocab_size)
    lines = fig10_chaos.gate_lines("poisson", 16, out)
    choices = [d["choice"] for d in out["router"].degrade_log]
    assert choices == ["replan"] and "replans=1;" in lines[0]
    plan = engines[0].plan.chunk
    assert any(e.chunk_lengths == sorted({plan // 2, plan})
               for e in engines)


# --- fig2 and the runner ----------------------------------------------------

def test_fig2_on_the_host_reads_no_clock():
    lines = fig2_unitmix.main(quick=True, device="cpu")
    names = [ln.split(",")[1] for ln in lines]
    assert names == ["matmul_only", "vector_only", "xlu_only",
                     "mixed_mm_vec", "sm_clock"]
    assert "overlap_frac=" in lines[3] and "device=host" in lines[0]
    assert lines[-1].count("not measured") == 4


def test_runner_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--only", "fig5"]) != 0
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and "_meta" not in err.out
    assert bench_run.main(["--only", "fig5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "_meta,fig5_memladder," in out and out.rstrip().endswith(",ok")


def test_runner_lists_the_reference_modules_in_order():
    ref = ("table1_machines", "table2_ports", "table3_instructions",
           "fig2_unitmix", "fig3_rpe", "fig4_wa", "fig4b_ntstore",
           "fig5_memladder", "fig6_serve", "fig7_decode", "fig8_paged",
           "fig9_load", "fig10_chaos")
    assert bench_run.MODULES == ref
