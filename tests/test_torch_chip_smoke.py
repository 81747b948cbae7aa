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


def test_decode_bound_counts_the_finished_output():
    """The decode rows' bound: q, each live K and V row, pos and the
    table entries read once, and the finished (B, 1, H, Dh) output written
    once in q's dtype (no fp32 partials), at the served shape."""
    b, h, hkv, dh, live = 8, 32, 4, 128, 2904
    ms, by, n = chip_smoke.decode_bound(b, h, hkv, dh, live, 2)
    assert n == 2 * b * h * dh * 2 + live * hkv * dh * 2 * 2 + b * 4
    assert by == "bytes"
    assert ms == pytest.approx(n / chip_smoke.HBM_BYTES_PER_S * 1e3)
    _, _, n_paged = chip_smoke.decode_bound(b, h, hkv, dh, live, 2, 185)
    assert n_paged == n + 185 * 4
    # 64 query heads a KV head: the operations outweigh the bytes
    ms, by, _ = chip_smoke.decode_bound(1, 64, 1, 128, 1000, 2)
    assert by == "operations"
    assert ms == pytest.approx(1000 * 64 * 128 * 4 / chip_smoke.FP32_FLOPS
                               * 1e3)


@pytest.mark.parametrize("want,got,dtype,ok", [
    (1.0, 1.0 + 5e-5, "float32", True),
    (1.0, 1.0 + 2e-4, "float32", False),
    (1.0, 1.0 + 2 ** -7, "bfloat16", True),          # one ulp at 1
    (1.0, 1.0 + 2 * 2 ** -7, "bfloat16", False),     # two ulps
    (1.3e-3, 1.3e-3 + 8e-5, "bfloat16", True),       # ulp 7.6e-6 + 1e-4
    (1.3e-3, 1.3e-3 + 2e-4, "bfloat16", False),
])
def test_finished_ok_is_one_bf16_ulp_over_the_fp32_tolerance(want, got,
                                                             dtype, ok):
    import torch
    dt = getattr(torch, dtype)
    w = torch.tensor([0.25, want], dtype=torch.float32)
    g = torch.tensor([0.25, got], dtype=torch.float32).to(dt)
    assert chip_smoke.finished_ok(torch, g, w)[0] is ok
