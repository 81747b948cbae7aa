#!/usr/bin/env python3
"""Design probes of the Gauss-Seidel and sum kernels on the card.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/gs_sum_probe.py [stages] [clocks] [sum]

(all three when none is named). Each builds a copy of a source in
``src/repro_torch/kernels/csrc`` with a few constants or lines replaced
(a replacement that no longer matches the source fails loudly), next to
the port's own libraries, and prints one line a reading:

- ``stages``: ``stencil.cu`` with other shapes of the TMA route's ring
  (rows a stage x stages, staged output boxes). A pass of 1, 2 and 4
  fused sweeps at chip_smoke's (4098, 4096), each held bit for bit
  against the plain version, in two rounds.
- ``clocks``: ``stencil.cu`` with ``clock64()`` counters around each
  stage's wait for its rows, its row steps (their stores included), its
  output copy and its load issue. Cycles a row step of each, averaged
  over the warps, for both routes (the 4-byte route on a view 4 bytes
  past a 16-byte boundary) and 0, 1, 2 and 4 fused sweeps.
- ``sum``: ``stream.cu``'s sum kernel with 4, 8 or 16 16-byte loads a
  thread in flight, 2, 4 or 8 blocks an SM, plain or evict-first
  (``__ldcs``) loads, against ``torch.sum`` at 2^28 f32, in two rounds.

Device times are chip_smoke's (``chip_smoke.timed``: torch.profiler).
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_P, _I = ctypes.c_void_p, ctypes.c_int

#: TMA-route ring shapes: (rows a stage, stages, staged boxes); the first
#: is the kernel's own
STAGE_SHAPES = ((64, 3, 2), (48, 4, 2), (32, 6, 2), (32, 6, 4), (16, 12, 2))
#: sum variants: (loads in flight a thread, blocks an SM, evict-first);
#: the first is the kernel's own
SUM_VARIANTS = ((8, 4, True), (4, 4, True), (4, 4, False), (8, 4, False),
                (16, 2, True), (8, 2, True), (4, 8, False))


def replaced(src: str, pairs) -> str:
    """``src`` with each (old, new) replaced; raises if an old is absent."""
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"probe: {old!r} not found in the source")
        src = src.replace(old, new)
    return src


def build_variant(build, name: str, source: str) -> ctypes.CDLL:
    """``source`` compiled as ``_build/probe_<name>.so`` and loaded."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"probe_{name}.cu"
    so = build.BUILD_DIR / f"probe_{name}.so"
    cu.write_text(source)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def gs_lib(build, name: str, pairs) -> ctypes.CDLL:
    src = (build.CSRC / "stencil.cu").read_text()
    lib = build_variant(build, name, replaced(src, pairs))
    lib.stencil_gauss_seidel_pass.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.stencil_gauss_seidel_pass.restype = _I
    return lib


def gs_pass(torch, build, lib, u, y, fused: int) -> None:
    h, w = u.shape
    rc = lib.stencil_gauss_seidel_pass(
        u.data_ptr(), y.data_ptr(), h, w, fused,
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "probe gauss_seidel pass")


def probe_stages(torch, C, build, SR) -> None:
    g = torch.Generator(device="cuda").manual_seed(21)
    u = torch.randn(C.GS_SHAPE, generator=g, device="cuda")
    y = torch.empty_like(u)
    want = {f: SR.gauss_seidel_2d5pt(u, f) for f in (1, 2, 4)}
    libs = {}
    for rows, stages, boxes in STAGE_SHAPES:
        libs[(rows, stages, boxes)] = gs_lib(build, f"gs_{rows}x{stages}b{boxes}", (
            ("static constexpr int ROWS = TMA ? 64 : 32;",
             f"static constexpr int ROWS = TMA ? {rows} : 32;"),
            ("static constexpr int STAGES = TMA ? 3 : 6;",
             f"static constexpr int STAGES = TMA ? {stages} : 6;"),
            ("constexpr int kGsBoxes = 2;", f"constexpr int kGsBoxes = {boxes};")))
    for rnd in (1, 2):
        for f in (1, 2, 4):
            out = []
            for shape, lib in libs.items():
                gs_pass(torch, build, lib, u, y, f)
                torch.cuda.synchronize()
                ok = "" if torch.equal(y, want[f]) else " NOT bit-identical"
                ms = C.timed(torch, lambda lib=lib: gs_pass(torch, build, lib, u, y,
                                                            f), 10)
                out.append(f"{shape[0]}x{shape[1]} rows x stages, {shape[2]} "
                           f"boxes {ms * 1e3:.1f}{ok}")
            print(f"stages: round {rnd}, {C.GS_SHAPE} {f} fused sweep(s), us: "
                  + "; ".join(out))


def probe_clocks(torch, C, build, SK) -> None:
    lib = gs_lib(build, "gs_clocks", (
        ("const __grid_constant__ CUtensorMap tmy) {",
         "const __grid_constant__ CUtensorMap tmy, long long* clk) {\n"
         "  long long t_wait = 0, t_step = 0, t_store = 0, t_issue = 0, "
         "t_all = clock64();"),
        ("  for (int s = 0; s < n_stages; ++s) {\n    if constexpr (TMA)",
         "  for (int s = 0; s < n_stages; ++s) {\n"
         "    const long long c_a = clock64();\n    if constexpr (TMA)"),
        ("    const float* slot = ring + (s % STAGES) * kStage + off;",
         "    const long long c_b = clock64();\n    t_wait += c_b - c_a;\n"
         "    const float* slot = ring + (s % STAGES) * kStage + off;"),
        ("    if constexpr (TMA) {\n      if (d0 < D) {",
         "    const long long c_c = clock64();\n    t_step += c_c - c_b;\n"
         "    if constexpr (TMA) {\n      if (d0 < D) {"),
        ("    issue(s + STAGES - 1);\n  }",
         "    const long long c_d = clock64();\n    t_store += c_d - c_c;\n"
         "    issue(s + STAGES - 1);\n    t_issue += clock64() - c_d;\n  }\n"
         "  if (lane == 0) {\n    long long* o = clk + 5 * blockIdx.x;\n"
         "    o[0] = t_wait, o[1] = t_step, o[2] = t_store, o[3] = t_issue;\n"
         "    o[4] = clock64() - t_all;\n  }"),
        ("(x, y, h, w, tmx, tmy);", "(x, y, h, w, tmx, tmy, g_clk);"),
        ("// --- Gauss-Seidel", "long long* g_clk = nullptr;\n\n// --- Gauss-Seidel"),
        ('extern "C" {',
         'extern "C" {\n\nvoid probe_clock(void* p) { g_clk = static_cast<long long*>(p); }')))
    lib.probe_clock.argtypes = [_P]
    lib.probe_clock.restype = None
    g = torch.Generator(device="cuda").manual_seed(21)
    h, w = C.GS_SHAPE
    flat = torch.randn(h * w + 4, generator=g, device="cuda")
    grids = {"TMA": flat[:h * w].view(h, w),
             "4-byte (view)": flat[1:h * w + 1].view(h, w)}
    y = torch.empty(h, w, device="cuda")
    clk = torch.zeros(5 * (w // 24 + 1), dtype=torch.int64, device="cuda")
    lib.probe_clock(clk.data_ptr())
    for route, u in grids.items():
        for f in (0, 1, 2, 4):
            strips = -(-w // SK.gs_strip_columns(f, route == "TMA"))
            clk.zero_()
            gs_pass(torch, build, lib, u, y, f)
            torch.cuda.synchronize()
            m = (clk[:5 * strips].view(strips, 5).double().mean(0) / h).tolist()
            print(f"clocks: {route} route, {f} fused sweep(s), cycles a row "
                  f"step (mean over {strips} warps): wait {m[0]:.1f}, row "
                  f"steps {m[1]:.1f}, output copy {m[2]:.1f}, load issue "
                  f"{m[3]:.1f}, all {m[4]:.1f}")


def probe_sum(torch, C, build, SK) -> None:
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(C.STREAM_HBM_SHAPE, generator=g, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty((), device="cuda")
    want = x.double().sum().item()
    src = (build.CSRC / "stream.cu").read_text()
    runs = {}
    for loads, per_sm, evict in SUM_VARIANTS:
        name = f"sum_{loads}l{per_sm}b{'cs' if evict else ''}"
        lib = build_variant(build, name, replaced(src, (
            ("constexpr int kSumBlocksPerSm = 4;",
             f"constexpr int kSumBlocksPerSm = {per_sm};"),
            ("constexpr int kSumLoads = 8;", f"constexpr int kSumLoads = {loads};"),
            ("v[u] = __ldcs(xv + i + u * stride);",
             "v[u] = " + ("__ldcs(xv + i + u * stride);" if evict
                          else "xv[i + u * stride];")))))
        lib.stream_sum.argtypes = SK._STREAM_SIGNATURES["stream_sum"]
        lib.stream_sum.restype = _I
        blocks = min(per_sm * sms, math.ceil(x.numel() // 4 / (256 * loads)))
        parts = torch.empty(blocks, device="cuda")

        def run(lib=lib, blocks=blocks, parts=parts):
            rc = lib.stream_sum(0, x.data_ptr(), x.numel(), parts.data_ptr(),
                                blocks, counter.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
            build.check(lib, rc, "probe sum")
        run()
        err = abs(out.item() - want)
        if err > 1e-5 * abs(want):
            raise RuntimeError(f"probe: sum {name} off by {err}")
        label = (f"{loads} loads a thread, {per_sm} blocks an SM, "
                 f"{'evict-first' if evict else 'plain'}")
        runs[label] = run
    for rnd in (1, 2):
        out_us = [f"torch.sum {C.timed(torch, lambda: torch.sum(x), 10) * 1e3:.1f}"]
        out_us += [f"{label} {C.timed(torch, run, 10) * 1e3:.1f}"
                   for label, run in runs.items()]
        out_us.append(f"torch.sum {C.timed(torch, lambda: torch.sum(x), 10) * 1e3:.1f}")
        print(f"sum: round {rnd}, 2^28 f32, us: " + "; ".join(out_us))


def main() -> int:
    import torch
    modes = sys.argv[1:] or ["stages", "clocks", "sum"]
    if not torch.cuda.is_available() or not set(modes) <= {"stages", "clocks",
                                                           "sum"}:
        print(__doc__, file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.kernels.stream import kernels as SK, ref as SR
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if "stages" in modes:
        probe_stages(torch, C, build, SR)
    if "clocks" in modes:
        probe_clocks(torch, C, build, SK)
    if "sum" in modes:
        probe_sum(torch, C, build, SK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
