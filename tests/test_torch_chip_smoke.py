"""chip_smoke's rule for profiler windows that read a call under its
bound, held on the CPU: ``under_bound`` names a reading under a bound
that is a true floor (the bytes of an HBM-resident working set, or an
operation count) and no other."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("reading,bound,kind,named", [
    (313.8, 320.5, "hbm", True),          # init_nt at 1 GiB, read short
    (335.2, 320.5, "hbm", False),
    (320.5, 320.5, "hbm", False),         # at the bound is possible
    (3.29, 1.95, "l2", False),            # decode's rows fit in L2
    (0.50, 1.95, "l2", False),
    (20.0, 34.76, "operations", True),    # flash attention's operations
    (249.4, 34.76, "operations", False),
])
def test_under_bound_names_readings_under_a_floor(reading, bound, kind,
                                                  named):
    got = chip_smoke.under_bound({"k": reading}, {"k": (bound, kind)})
    assert got == ([("k", reading, bound)] if named else [])


def test_under_bound_checks_every_kernel_in_order():
    readings = {"copy": 700.0, "init_nt": 313.8, "pi_integration": 20.0,
                "copy_l2": 1.0}
    bounds = {"init_nt": (320.5, "hbm"), "copy": (641.0, "hbm"),
              "pi_integration": (24.0, "operations"),
              "copy_l2": (5.0, "l2"), "sum_reduction": (320.5, "hbm")}
    assert chip_smoke.under_bound(readings, bounds) == [
        ("init_nt", 313.8, 320.5), ("pi_integration", 20.0, 24.0)]


def test_only_true_floors_are_checked():
    """A call with no bound, or a bound of no floor kind, is never named."""
    assert chip_smoke.FLOOR_KINDS == ("hbm", "operations")
    assert chip_smoke.under_bound({"k": 1.0}, {}) == []
    assert chip_smoke.under_bound({"k": 1.0}, {"k": (2.0, "bytes")}) == []


def _windows(monkeypatch, readings):
    """``chip_smoke.device_us`` reads ``readings`` (µs a call, 4 calls a
    window), one a profiler window; the card's synchronize is a no-op."""
    import torch
    seq = iter(readings)

    def device_us(prof, counts=None):
        us = next(seq)
        if counts is not None:
            counts["kernel"] = 4
        return {"kernel": us * 4}

    monkeypatch.setattr(chip_smoke, "device_us", device_us)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return torch


def test_timed_retakes_a_window_under_its_bound(monkeypatch, capsys):
    torch = _windows(monkeypatch, [313.8, 335.2])
    ms = chip_smoke.timed(torch, lambda: None, 4, warmup=0,
                          bound=("init_nt", 320.5, "hbm"))
    assert ms == pytest.approx(0.3352)
    out = capsys.readouterr().out
    assert "init_nt read 313.80 us, under its hbm bound 320.50 us" in out
    assert "measured in window 2" in out


def test_timed_fails_when_every_window_reads_under(monkeypatch):
    torch = _windows(monkeypatch, [20.0] * chip_smoke.PROFILE_ATTEMPTS)
    with pytest.raises(chip_smoke.PhaseError, match="under a bound"):
        chip_smoke.timed(torch, lambda: None, 4, warmup=0,
                         bound=("flash_attention", 34.76, "operations"))


def test_timed_keeps_a_reading_under_a_bound_that_is_no_floor(monkeypatch):
    torch = _windows(monkeypatch, [3.29])
    ms = chip_smoke.timed(torch, lambda: None, 4, warmup=0,
                          bound=("flash_decode", 5.0, "l2"))
    assert ms == pytest.approx(0.00329)
