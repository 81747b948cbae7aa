"""The port's calibration (``repro_torch.core.ubench``) against the JAX
package's ``repro.core.ubench`` on the CPU.

Both measure with the same sequence of timings (``_timeit`` replaced on
both sides by the same readings): the class rates and the memory ladder
must then be equal, float for float, and the registered ``host_cpu``
models must fingerprint alike. One real calibration at a small size
checks the measurement itself. Every test that registers ``host_cpu``
takes it out of both registries again: a registered ``host_cpu`` turns
``tuning.default_machine()`` from ``tpu_v5e`` to it for every test that
runs after it in the same worker.
"""

import dataclasses

import pytest
import torch

from repro.core import machine as JM
from repro.core import ubench as JU
from repro_torch.core import machine as TM
from repro_torch.core import ubench as TU
from repro_torch.kernels import tuning

torch.set_num_threads(1)


def _readings():
    """A fresh iterator of distinct, plausible timings (seconds)."""
    return iter([1e-4 * (1.0 + 0.37 * i) for i in range(64)])


@pytest.fixture
def same_readings(monkeypatch):
    """Both packages' ``_timeit`` replaced by the same readings."""
    jr, tr = _readings(), _readings()
    monkeypatch.setattr(JU, "_timeit", lambda fn, *a, reps=5: next(jr))
    monkeypatch.setattr(TU, "_timeit", lambda fn, *a, reps=5: next(tr))


@pytest.fixture
def clean_host():
    """Take ``host_cpu`` and the calibrations out of both packages after
    the test."""
    yield
    TU.forget("cpu")
    JM.MACHINES.pop("host_cpu", None)
    JU._CAL_CACHE.clear()
    tuning.clear_cache()


def _tiers(tiers):
    return [dataclasses.astuple(t) for t in tiers]


def test_rates_and_ladder_equal_jax_on_the_same_readings(same_readings):
    want = JU.measure_host_rates()
    got = TU.measure_host_rates(device="cpu")
    jraw, traw = want.pop("_raw"), got.pop("_raw")
    assert got == want
    assert _tiers(traw["mem_tiers"]) == _tiers(jraw["mem_tiers"])
    for k in ("add_s", "fma_s", "div_s", "exp_s", "gather_s", "move_s",
              "matmul_s", "copy_big_s", "flops_matmul", "stream_bw"):
        assert traw[k] == jraw[k], k


def test_registered_host_model_fingerprints_as_jax(same_readings,
                                                   clean_host):
    jm = JU.calibrated_host_model()
    tm = TU.calibrated_host_model(device="cpu")
    assert tm.name == jm.name == "host_cpu"
    assert TM.machine_fingerprint("host_cpu") == \
        JM.machine_fingerprint("host_cpu")
    assert TU.host_peaks("cpu") == JU.host_peaks()
    assert _tiers(TU.mem_tiers("cpu")) == _tiers(JU.mem_tiers())
    for ws in (1e3, 1e5, 1e7, 1e9):
        assert TU.tier_bw(ws, "cpu") == JU.tier_bw(ws)
    assert tuning.default_machine() == "host_cpu"


def test_default_machine_after_cleanup(clean_host):
    assert "host_cpu" not in TM.MACHINES
    assert tuning.default_machine() == "tpu_v5e"


def test_real_small_cpu_calibration():
    """One real measurement at a small size: every rate positive, the
    ladder monotone in bandwidth, innermost first, DRAM last."""
    rates = TU.measure_host_rates(n=1024, device="cpu")
    raw = rates.pop("_raw")
    assert all(v > 0 for v in rates.values())
    tiers = raw["mem_tiers"]
    assert tiers[-1].name == "DRAM" and tiers[-1].shared_bw > 0
    assert all(a.load_bw >= b.load_bw for a, b in zip(tiers, tiers[1:]))
    assert raw["flops_matmul"] > 0 and raw["stream_bw"] > 0


def test_card_calibration_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TU.measure_host_rates()


def test_card_tiers_register_only_what_was_measured(monkeypatch):
    """The card's L2 and HBM3 tiers (``ubench._card_tiers``, readings
    faked): each tier's shared ceiling and HBM3's per-SM read rate are
    measured; L2's per-SM rate and both store rates stay ``h100``'s
    published ones, and the sweep's L2 rung is reported only."""
    monkeypatch.setattr(TU, "_timeit", lambda fn, *a, reps=5: 1e-3)
    sweeps = {"L2": [(1, 5e10), (264, 2.8e11)],
              "HBM3": [(1, 6e10), (132, 2.7e12), (264, 2.6e12)]}
    order = iter(t for t, _ in TU.CTA_SWEEP_ELEMS)
    monkeypatch.setattr(TU, "cta_sweep", lambda x: sweeps[next(order)])
    gen = torch.Generator().manual_seed(0)
    raw = {}
    l2, hbm = TU._card_tiers(torch.device("cpu"), gen, torch.ones(1 << 10),
                             3.0e12, raw)
    pub = TM.get_machine("h100").mem_tiers
    assert raw["cta_sweep"] == sweeps
    assert l2 == dataclasses.replace(pub[2], shared_bw=raw["l2_chain_bw"])
    assert raw["l2_chain_bw"] == 3 * 4 * TU.CARD_L2_N / (1e-3 / TU.K_CHAIN)
    assert hbm == dataclasses.replace(pub[3], load_bw=6e10,
                                      shared_bw=3.0e12)


def test_measured_gpu_model_keeps_the_published_rest():
    """``h100_measured`` takes the measured tensor-core rate, stream and
    L2/HBM3 tiers; every other class and the SMs' own tiers are the
    ``h100`` file's."""
    h = TM.get_machine("h100")
    tiers = [dataclasses.replace(h.mem_tiers[2], load_bw=1e11,
                                 shared_bw=7e12),
             dataclasses.replace(h.mem_tiers[3], load_bw=4e10,
                                 shared_bw=3e12)]
    m = TM.measured_gpu_model(mxu_flops=7e14, hbm_bw=3e12, tiers=tiers)
    assert m.name == "h100_measured" and "h100_measured" not in TM.MACHINES
    assert m.mem_tiers[:2] == h.mem_tiers[:2]
    assert m.mem_tiers[2:] == tuple(tiers)
    for cls in ("vpu", "xlu", "vdiv", "vlsu", "gather4", "sc", "ici"):
        assert m.table[cls] == h.table[cls], cls
    assert m.table["mxu"].cycles_per_unit == pytest.approx(
        h.table["mxu"].cycles_per_unit * 989e12 / 7e14)
    assert m.table["dma"].cycles_per_unit == pytest.approx(
        h.table["dma"].cycles_per_unit * 3.35e12 / 3e12)
    TM.validate_model(m)
    assert TU.machine_tier_bw(m, 1e9) == 3e12       # the shared ceiling
    assert TU.machine_tier_bw(h, 1e9) == pytest.approx(3.35e12)
