"""The port's machine files, memory ladder, write-allocate model and
store-flavor selector against the JAX package's (``repro.core``), and
the ``h100`` machine file against NVIDIA's published rates.

The six machines the packages share are copies: their content hashes
must match and every ladder and WA function must give the JAX package's
numbers (within 1e-12 relative: the same arithmetic in the same order).
"""

import dataclasses
import math

import pytest
import torch

from repro.core import machine as JM
from repro.core import memtier as JMT
from repro.core import wa as JWA
from repro.kernels import stores as JS
from repro_torch.core import machine as TM
from repro_torch.core import memtier as TMT
from repro_torch.core import portmodel, trace
from repro_torch.core import wa as TWA
from repro_torch.kernels import stores as TS
from repro_torch.utils import hw

torch.set_num_threads(1)

SHARED = ("tpu_v5e", "tpu_v5p", "tpu_v4", "zen4", "golden_cove",
          "neoverse_v2")
#: working sets from a few KiB (L1/VMEM) through L2/L3 to DRAM/HBM
WS = (4e3, 48e3, 600e3, 3e6, 40e6, 2e8, 8e9)
REL = 1e-12


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


def _same_resolution(got, want):
    assert (got.machine, got.home, got.overlap, got.bottleneck_tier) == \
        (want.machine, want.home, want.overlap, want.bottleneck_tier)
    for x, y in ((got.seconds, want.seconds), (got.ws_bytes, want.ws_bytes),
                 (got.saturation, want.saturation),
                 (got.traffic_bytes, want.traffic_bytes)):
        _close(x, y)
    assert len(got.legs) == len(want.legs)
    for g, w in zip(got.legs, want.legs):
        assert g.tier == w.tier
        for f in ("seconds", "load_bytes", "store_bytes", "wa_ratio",
                  "load_bw", "store_bw"):
            _close(getattr(g, f), getattr(w, f))


def test_registry_order_and_h100():
    assert TM.registered_names() == SHARED + ("h100",)
    assert set(JM.registered_names()) >= set(SHARED)
    TM.validate_model(TM.get_machine("h100"))


@pytest.mark.parametrize("name", SHARED)
def test_shared_machines_fingerprint_as_jax(name):
    assert TM.machine_fingerprint(name) == JM.machine_fingerprint(name)
    assert repr(TM.get_machine(name)) == repr(JM.get_machine(name))


def test_h100_rates_are_the_published_ones():
    """Each in-core port carries the whole chip's rate: the tensor cores
    989 TFLOP/s dense bf16, the FP32 lanes 67 TFLOP/s (an FMA is 2), the
    SFU 16 results an SM a clock, HBM3 3.35 TB/s; 132 SMs drive the
    shared tiers."""
    m = TM.get_machine("h100")
    g = m.chip
    mxu = m.entry("mxu")
    assert 2 * 128 ** 3 * m.clock_hz / mxu.cycles_per_unit \
        == pytest.approx(989e12, rel=1e-12)
    vpu = m.entry("vpu")
    fp32 = 2 * 1024 * m.clock_hz / vpu.cycles_per_unit
    assert fp32 == pytest.approx(g.fp32_flops, rel=0.01)
    xlu = m.entry("xlu")
    assert 1024 / xlu.cycles_per_unit == pytest.approx(16 * 132)
    assert m.clock_hz / m.entry("dma").cycles_per_unit == \
        pytest.approx(3.35e12)
    assert m.cores == 132 and m.wa_mode == "auto_claim"
    assert [t.name for t in m.mem_tiers] == ["REG", "SMEM/L1", "L2", "HBM3"]
    assert all(t.wa_residue == 0.0 for t in m.mem_tiers)
    assert [t.shared_bw > 0 for t in m.mem_tiers] == [False, False, True,
                                                       True]
    assert m.mem_tiers[2].capacity_bytes == 50e6
    assert m.mem_tiers[-1].shared_bw == 3.35e12
    assert g.smem_max_bytes == 228 * 1024 and g.hbm_bytes == 80e9
    assert g.nvlink_bw == 900e9


def test_card_numbers_have_one_source():
    """The decode kernels' SM count and chip_smoke's peaks are the h100
    machine file's, at the values they had."""
    import os
    import sys
    from repro_torch.kernels.attention import decode as D
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    assert D.H100_SMS == TM.get_machine("h100").cores == 132
    assert (chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_FLOPS,
            chip_smoke.BF16_FLOPS) == (3.35e12, 67e12, 989e12)


def test_matmul_trace_prices_at_the_bf16_peak():
    """A pure matmul lowered from ATen (M, N, K multiples of 128) prices
    at 989 TFLOP/s on h100 within 1 %, in-core."""
    a = torch.empty(4096, 8192, dtype=torch.bfloat16, device="meta")
    b = torch.empty(8192, 4096, dtype=torch.bfloat16, device="meta")
    tr = trace.lower_step(torch.mm, a, b)
    m = TM.get_machine("h100")
    rep = portmodel.analyze(tr, m)
    assert rep.flops == 2.0 * 4096 * 8192 * 4096
    assert rep.flops / rep.seconds_incore(m) == pytest.approx(989e12,
                                                              rel=0.01)


def test_hbm_stream_prices_at_the_hbm_rate():
    """A 1 GiB copy (read once, written once) prices at 3.35 TB/s within
    1 %, through the ladder (home HBM3, all 132 SMs streaming)."""
    x = torch.empty(2 ** 28, dtype=torch.float32, device="meta")
    tr = trace.lower_step(torch.clone, x)
    m = TM.get_machine("h100")
    rep = portmodel.compare(tr, machines=["h100"])["h100"]
    assert rep.bytes_hbm == 2 * 2 ** 30
    assert rep.home_tier == "HBM3" and rep.bottleneck_tier == "HBM3"
    assert rep.bytes_hbm / rep.tier_bound_seconds(m) == \
        pytest.approx(3.35e12, rel=0.01)
    assert rep.bytes_hbm / rep.seconds(m) == pytest.approx(3.35e12,
                                                           rel=0.01)


@pytest.mark.parametrize("name", SHARED)
def test_memtier_matches_jax(name):
    for ws in WS:
        for traffic in (1e3, ws, 3 * ws):
            for cores in (None, 1, 8):
                _same_resolution(
                    TMT.memory_seconds(name, traffic, ws,
                                       cores_active=cores),
                    JMT.memory_seconds(name, traffic, ws,
                                       cores_active=cores))
        for nt in (False, True):
            for overlap in ("full", "none"):
                kw = dict(ws_bytes=ws, load_bytes=ws / 2,
                          store_bytes=ws / 3, nt_stores=nt,
                          overlap=overlap)
                _same_resolution(TMT.transfer_time(name, **kw),
                                 JMT.transfer_time(name, **kw))
        kw = dict(n_pages=17, page_bytes=ws / 64, table_bytes=68.0)
        _same_resolution(TMT.page_gather_time(name, **kw),
                         JMT.page_gather_time(name, **kw))
        _same_resolution(TMT.page_gather_time(name, ws_bytes=ws, **kw),
                         JMT.page_gather_time(name, ws_bytes=ws, **kw))
        for nt in (False, True):
            kw = dict(page_bytes=ws / 64, n_pages=3, nt_stores=nt)
            _same_resolution(TMT.page_copy_time(name, **kw),
                             JMT.page_copy_time(name, **kw))
        _close(TMT.modeled_saturation(name, ws),
               JMT.modeled_saturation(name, ws))


@pytest.mark.parametrize("name", SHARED)
def test_wa_matches_jax(name):
    for dims, dtype, aligned, donated, full, buf in (
            ((8, 128), "f32", True, True, True, None),
            ((3, 7, 100), "bf16", False, True, False, None),
            ((1, 4, 128), "bf16", True, False, False, 1e6),
            ((), "f32", True, True, True, None),
            ((5, 129), "s8", False, False, False, 4e5)):
        kw = dict(offset_aligned=aligned, donated=donated,
                  full_overwrite=full, buffer_bytes=buf)
        prof_t = TWA.store_profile(dims, dtype, **kw)
        prof_j = JWA.store_profile(dims, dtype, **kw)
        assert dataclasses.astuple(prof_t) == dataclasses.astuple(prof_j)
        for nt in (False, True):
            for ws in (None,) + WS:
                kw = dict(nt_stores=nt, ws_bytes=ws)
                _close(TWA.priced_store_traffic(prof_t, name, **kw),
                       JWA.priced_store_traffic(prof_j, name, **kw))
                for flavor in ("standard", "nt", "auto"):
                    _close(TWA.priced_store_traffic(prof_t, name, ws_bytes=ws,
                                                    flavor=flavor),
                           JWA.priced_store_traffic(prof_j, name, ws_bytes=ws,
                                                    flavor=flavor))
                for cores in (None, 4):
                    kw2 = dict(nt_stores=nt, ws_bytes=ws,
                               cores_active=cores, tile_full_frac=0.75)
                    _close(TWA.traffic_ratio_for(name, **kw2),
                           JWA.traffic_ratio_for(name, **kw2))
                    _close(TWA.ladder_traffic_ratio(name, **kw2),
                           JWA.ladder_traffic_ratio(name, **kw2))
                    if ws is not None:
                        _close(TWA.modeled_saturation_for(name, ws, cores),
                               JWA.modeled_saturation_for(name, ws, cores))
    assert TWA.wa_mode_of(name) == JWA.wa_mode_of(name)
    scan = {"stored_bytes": 1e6, "rmw_read_bytes": 2.5e5,
            "copy_bytes": 3e4, "wa_ratio": 1.31}
    for bw in (None, 0.2, 0.9):
        got = TWA.apply_wa_mode(scan, name, bw_utilization=bw)
        want = JWA.apply_wa_mode(scan, name, bw_utilization=bw)
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(got[k], float):
                _close(got[k], want[k])
            else:
                assert got[k] == want[k]
    for mode in ("auto_claim", "saturation_gated", "explicit_only"):
        for bw in (0.0, 0.6, 1.0):
            for res in (None, 0.0, 0.1, 1.0):
                kw = dict(bw_utilization=bw, residue=res,
                          tile_full_frac=0.9)
                _close(TWA.machine_traffic_ratio(mode, **kw),
                       JWA.machine_traffic_ratio(mode, **kw))


@pytest.mark.parametrize("name", SHARED + ("h100",))
def test_store_flavor_selection(name):
    """``resolve_flavor("auto", m)`` is the JAX package's on every shared
    machine, at every working set and core count, and ``"standard"`` on
    h100, whose ladder claims lines on store."""
    for ws in (None,) + WS:
        for cores in (None, 1, 64):
            got = TS.resolve_flavor("auto", name, ws_bytes=ws,
                                    cores_active=cores)
            if name == "h100":
                assert got == "standard"
                continue
            assert got == JS.resolve_flavor("auto", name, ws_bytes=ws,
                                            cores_active=cores)
            plan_t = TS.plan_stores(name, ws_bytes=ws, cores_active=cores)
            plan_j = JS.plan_stores(name, ws_bytes=ws, cores_active=cores)
            assert dataclasses.astuple(plan_t) == \
                dataclasses.astuple(plan_j)
    assert TS.resolve_flavor("nt", name) == "nt"
    assert TS.executed_flavor("auto") == "standard"
    with pytest.raises(ValueError, match="unknown store flavor"):
        TS.resolve_flavor("fast", name)


def test_dtype_bytes_reads_torch_dtypes():
    for dt, n in ((torch.bfloat16, 2), (torch.float32, 4), (torch.int64, 8),
                  (torch.bool, 1), (torch.float16, 2), (torch.int32, 4)):
        assert hw.dtype_bytes(dt) == hw.dtype_bytes(str(dt)) == n
        assert hw.dtype_bytes(str(dt).removeprefix("torch.")) == n
    assert hw.dtype_bytes("bf16") == 2 and hw.dtype_bytes("nope") == 4


def test_unregistered_machine_raises():
    with pytest.raises(KeyError, match="unknown machine"):
        TM.get_machine("a100")
    assert math.isinf(TM.get_machine("h100").mem_tiers[-1].capacity_bytes)
