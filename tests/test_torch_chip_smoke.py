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


def _windows(monkeypatch, readings, events=None):
    """``chip_smoke.device_us`` reads ``readings`` (µs a call, 4 calls a
    window), one a profiler window, with ``events`` of the kernel's 4
    recorded in each (all of them by default); the card's synchronize is
    a no-op."""
    import torch
    seq = iter(readings)
    seen = iter(events or [4] * len(readings))

    def device_us(prof, counts=None):
        us, n = next(seq), next(seen)
        if counts is not None:
            counts["kernel"] = n
        return {"kernel": us * n}

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


def test_timed_retakes_empty_windows_apart_from_readings(monkeypatch,
                                                         capsys):
    """Windows that saw no device time are the profiler's loss: they are
    retaken up to EMPTY_WINDOWS of them, beside the PROFILE_ATTEMPTS
    readings under a bound."""
    n = chip_smoke.EMPTY_WINDOWS - 1
    torch = _windows(monkeypatch, [0.0] * n + [313.8, 335.2])
    ms = chip_smoke.timed(torch, lambda: None, 4, warmup=0,
                          bound=("init_nt", 320.5, "hbm"))
    assert ms == pytest.approx(0.3352)
    assert f"measured in window {n + 2}" in capsys.readouterr().out
    torch = _windows(monkeypatch, [0.0] * chip_smoke.EMPTY_WINDOWS)
    with pytest.raises(chip_smoke.PhaseError, match="saw no device time"):
        chip_smoke.timed(torch, lambda: None, 4, warmup=0)


def test_timed_retakes_a_window_that_lost_most_events(monkeypatch, capsys):
    """A window that recorded 1 of the kernel's 4 launches is taken again,
    bound or no bound; 3 of 4 is kept (mean event time x 1 a call)."""
    torch = _windows(monkeypatch, [2.0, 9.5], events=[1, 3])
    ms = chip_smoke.timed(torch, lambda: None, 4, warmup=0)
    assert ms == pytest.approx(0.0095)
    out = capsys.readouterr().out
    assert "window 1 taken again: the profiler recorded 1 of 4" in out
    assert "measured in window 2" in out
    torch = _windows(monkeypatch, [9.5] * chip_smoke.PROFILE_ATTEMPTS,
                     events=[2] * chip_smoke.PROFILE_ATTEMPTS)
    with pytest.raises(chip_smoke.PhaseError, match="most of a kernel's"):
        chip_smoke.timed(torch, lambda: None, 4, warmup=0)


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


@pytest.mark.parametrize("name,decode,paged", [
    ("void (anonymous namespace)::decode_kernel<128, 16, false, true>"
     "(__nv_bfloat16 const*, ...)", True, False),      # dense, writing
    ("void (anonymous namespace)::decode_kernel<128, 16, true, true>"
     "(__nv_bfloat16 const*, ...)", True, True),       # paged, writing
    ("void (anonymous namespace)::decode_f32_kernel<256, 32, true, false>"
     "(float const*, ...)", True, True),
    ("void (anonymous namespace)::decode_kernel<128, 16, false>"
     "(__nv_bfloat16 const*, ...)", True, False),      # a parent's names
    ("void (anonymous namespace)::decode_partials_kernel<128, 16, true>"
     "(__nv_bfloat16 const*, ...)", True, True),
    ("void (anonymous namespace)::kv_rows_kernel<true>(uint4 const*, ...)",
     False, False),
])
def test_trace_groups_decode_kernels_by_layout(name, decode, paged):
    """The trace phase tells the dense and the paged decode instantiations
    apart by their PAGED template argument, whatever follows it."""
    assert bool(chip_smoke.DECODE_KERNEL.search(name)) == decode
    assert bool(chip_smoke.DECODE_PAGED.search(name)) == paged


#: two functions of ``cuobjdump -sass`` output, as it prints them on an H100
FAKE_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN4_GLOBAL__N_9pi_kernelILb0EEEvxfPfPiS1_
        /*0000*/                   MUFU.RCP R2, R3 ;     /* 0x0000000300027308 */
        /*0010*/              @P0 BRA 0x0 ;             /* 0xfffffffc00000947 */
\t\tFunction : _ZN4_GLOBAL__N_9pi_kernelILb1EEEvxfPfPiS1_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.RCP R2, R3 ;
        /*0020*/                   FFMA R4, -R3, R2, 1 ;
        /*0030*/                   FADD R5, R5, R4 ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   BRA.U !UP0, 0x70 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x0 ;
"""


def test_sass_loops_spans_backward_branches():
    """A loop is a backward branch's span (target to branch, both in);
    forward branches are none, and only the named function is read."""
    assert chip_smoke.sass_loops(FAKE_SASS, "pi_kernelILb1E") == [(4, 1),
                                                                 (8, 1)]
    assert chip_smoke.sass_loops(FAKE_SASS, "pi_kernelILb0E") == [(2, 1)]
    assert chip_smoke.sass_loops(FAKE_SASS, "sum_kernel") == []


#: a flash body's SASS and its ptxas report, as the H100's toolkit prints
#: them (one instance; names cut to one mangled kernel)
FLASH_KERNEL = ("_ZN40_GLOBAL__N__d12099d2_8_flash_cu_2c13897917flash_bf16_"
                "kernelILi128ELi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
                "PKiP6float4Piiiiiiiiif")
FLASH_SASS = f"""
\t\tFunction : {FLASH_KERNEL}
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
        /*0030*/                   FMNMX R2, R3, R4, !PT ;
\t\tFunction : _ZN4_GLOBAL__N_9pi_kernelILb0EEEvxfPfPiS1_
        /*0000*/                   MUFU.RCP R2, R3 ;
"""
FLASH_PTXAS = f"""ptxas info    : Compiling entry function '{FLASH_KERNEL}' for 'sm_90a'
ptxas info    : Function properties for {FLASH_KERNEL}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_sass_op_counts_count_hopper_instructions():
    """``HGMMA`` and ``UTMALDG`` by function, whatever their suffixes."""
    got = chip_smoke.sass_op_counts(FLASH_SASS)
    assert got[FLASH_KERNEL] == {"HGMMA": 2, "UTMALDG": 1}
    assert got["_ZN4_GLOBAL__N_9pi_kernelILb0EEEvxfPfPiS1_"] == {
        "HGMMA": 0, "UTMALDG": 0}


def test_ptxas_kernels_reads_registers_and_spills():
    """(registers, spill stores, spill loads, stack) by mangled name."""
    assert chip_smoke.ptxas_kernels(FLASH_PTXAS) == {
        FLASH_KERNEL: (168, 4, 12, 8)}


def test_pi_floors():
    """One MUFU.RCP a point at 16 an SM a clock, and the hot loop's
    instructions at 128 an SM a clock: 2^28 points on 132 SMs at
    1980 MHz."""
    sfu, issue = chip_smoke.pi_floors_us(2 ** 28, 132, 1980.0, 12)
    assert sfu == pytest.approx(2 ** 28 / (132 * 16 * 1.98e9) * 1e6)
    assert sfu == pytest.approx(64.19, abs=0.01)
    assert issue == pytest.approx(96.29, abs=0.01)
    assert chip_smoke.pi_floors_us(2 ** 28, 132, 1980.0, None)[1] is None


class _Event:
    """A raw profiler event as ``runtime_calls`` reads it."""

    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType
        return getattr(DeviceType, self._device)


class _Profile:
    """A profile of the trace phase's kind: a greedy chunk as one graph
    replay (2 input copies, one graph launch, 2 readbacks), beside the
    eager calls of a prefill."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


@pytest.mark.parametrize("events,drops", [(0, 3), (100, 3), (768, 7),
                                          (1008, 10)])
def test_profiler_drops_a_hundredth_at_least_three(events, drops):
    assert chip_smoke.profiler_drops(events) == drops


def test_host_launches_counts_by_kind():
    calls = {"cudaLaunchKernel": 5, "cudaLaunchKernelExC": 2,
             "cuLaunchKernel": 1, "cuLaunchKernelEx": 1,
             "cudaGraphLaunch": 3, "cudaMemcpyAsync": 7,
             "cudaMemsetAsync": 1, "cudaStreamSynchronize": 4,
             "aten::mm": 9}
    assert chip_smoke.host_launches(calls) == {"kernel": 9, "graph": 3,
                                               "copy": 8}
    assert chip_smoke.host_launches({}) == {"kernel": 0, "graph": 0,
                                            "copy": 0}


def test_runtime_calls_read_only_host_api_events():
    """Host API calls are counted by name; device events (kernels inside
    a replay among them) and other host events are not."""
    events = ([_Event("cudaMemcpyAsync", "CPU")] * 2
              + [_Event("cudaGraphLaunch", "CPU")]
              + [_Event("void decode_kernel<128, 16, false, true>()",
                        "CUDA")] * 48
              + [_Event("Memcpy HtoD (Pageable -> Device)", "CUDA")] * 2
              + [_Event("cudaMemcpyAsync", "CPU")] * 2
              + [_Event("aten::mm", "CPU"), _Event("cudaLaunchKernel", "CPU"),
                 _Event("cudaStreamSynchronize", "CPU")])
    calls = chip_smoke.runtime_calls(_Profile(events))
    assert calls == {"cudaMemcpyAsync": 4, "cudaGraphLaunch": 1,
                     "cudaLaunchKernel": 1}
    assert chip_smoke.host_launches(calls) == {"kernel": 1, "graph": 1,
                                               "copy": 4}


def test_kv_read_bytes_windows_local_layers():
    """gemma3-4b: a K and V row is 4 KiB (4 KV heads x 256 x 2 x bf16);
    the 5 global layers read rows 0..pos, the 29 local ones at most the
    1024-row window; yi-9b (no local layers) reads pos + 1 rows a layer."""
    from repro_torch.configs import get_config
    gemma = get_config("gemma3-4b")
    row = 4 * 256 * 2 * 2
    assert chip_smoke.kv_read_bytes(gemma, 99) == 34 * 100 * row
    assert chip_smoke.kv_read_bytes(gemma, 1023) == 34 * 1024 * row
    assert chip_smoke.kv_read_bytes(gemma, 1499) == \
        (5 * 1500 + 29 * 1024) * row
    yi = get_config("yi-9b")
    assert chip_smoke.kv_read_bytes(yi, 1499) == 48 * 1500 * 4 * 128 * 4


def test_phase_seven_is_listed_and_driven_last():
    """Phase 7 (the serving benchmarks, 7a-7d) is in the script's phase
    list, and ``main`` drives it after the other phases and before the
    ``kernels`` line, adding its decode launches by path."""
    import inspect
    doc = chip_smoke.__doc__
    for part in ("\n7. the serving benchmarks", "7a. fig7", "7b. fig8",
                 "7c. fig9", "7d. fig10"):
        assert part in doc
    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_moe_forward(") \
        < src.index("phase_serving_benchmarks(") \
        < src.index('json.dumps({"kernels": rows})')
    assert 'fig_launches["flash_decode"]' in src
    assert 'fig_launches["flash_decode_paged"]' in src
    fig = inspect.getsource(chip_smoke.phase_serving_benchmarks)
    for phase in ("phase_fig7(", "phase_fig8(", "phase_fig9(",
                  "phase_fig10("):
        assert phase in fig


def test_last_line_contract_is_unchanged(monkeypatch, capsys):
    """The last line is exactly ``{"ok": true, "device": {"platform":
    "gpu", "kind": ..., "count": ...}}``; without a card the script exits
    non-zero and prints no result."""
    import inspect
    import torch
    src = inspect.getsource(chip_smoke.main).rstrip().splitlines()
    assert src[-4:] == [
        '    print(json.dumps({"ok": True, "device": {',
        '        "platform": "gpu", "kind": name,',
        '        "count": torch.cuda.device_count()}}))',
        "    return 0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
