#!/usr/bin/env python3
"""Design probes of the 3-D Jacobi kernel (plane tiles marched down z) on
the card.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/jacobi3d_probe.py [<variant> ...]

Each variant is a copy of ``src/repro_torch/kernels/csrc/stencil.cu``
with a few constants or lines replaced (a replacement that no longer
matches the source fails loudly), all compiled at once next to the
port's own libraries. Each is run at chip_smoke's (514, 512, 1024), held
bit for bit against the plain version, and timed with chip_smoke's
``timed`` (device time by torch.profiler) in two rounds, beside
``copy_`` of the same input and its byte bound; one line a reading.
With no variant named, all of ``VARIANTS`` run (the first is the
kernel's own).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_P, _I = ctypes.c_void_p, ctypes.c_int

_TILE = "constexpr int kJ3X = 128, kJ3Y = 16;"
_STAGES = "constexpr int kJ3Stages = 8;"
_BLOCKS = "constexpr long long kJ3Blocks = 16384;"
_THREADS = "constexpr int kJ3Threads = 256;"


def _shape(x: int, y: int, stages: int, blocks: int = 16384,
           threads: int = 256) -> tuple:
    """Replacements for a tile of y x x output points, a ring of
    ``stages`` slots, the blocks the chunks of z aim for and the threads
    of a block."""
    return ((_TILE, f"constexpr int kJ3X = {x}, kJ3Y = {y};"),
            (_STAGES, f"constexpr int kJ3Stages = {stages};"),
            (_BLOCKS, f"constexpr long long kJ3Blocks = {blocks};"),
            (_THREADS, f"constexpr int kJ3Threads = {threads};"))


#: name: (what it changes, replacements in stencil.cu); the first is the
#: kernel's own
VARIANTS = {
    "own": ("16 x 128 tiles, 8 slots (6 planes ahead), ~16384 blocks, "
            "256 threads", ()),
    "16x64-6-2048": ("16 x 64 tiles, 6 slots, ~2048 blocks",
                     _shape(64, 16, 6, 2048)),
    "16x64-6-16384": ("16 x 64 tiles, 6 slots", _shape(64, 16, 6)),
    "8x128-12": ("8 x 128 tiles, 12 slots", _shape(128, 8, 12)),
    "16x128-6": ("6 slots", _shape(128, 16, 6)),
    "16x128-10": ("10 slots", _shape(128, 16, 10)),
    "16x128-8-2048": ("~2048 blocks", _shape(128, 16, 8, 2048)),
    "16x128-8-4096": ("~4096 blocks", _shape(128, 16, 8, 4096)),
    "16x128-8-8192": ("~8192 blocks", _shape(128, 16, 8, 8192)),
    "16x128-8-32768": ("~32768 blocks", _shape(128, 16, 8, 32768)),
    "16x128-8-512": ("512 threads", _shape(128, 16, 8, threads=512)),
    "32x128-6-512": ("32 x 128 tiles, 6 slots, 512 threads",
                     _shape(128, 32, 6, threads=512)),
    "evict-first": ("evict-first (st.global.cs) stores for the output",
                    (("oc[(static_cast<long long>(p - 2) * (h - 2) + i * "
                      "kJ3RowStep) * ow] =\n              __fmul_rn(",
                      "__stcs(oc + (static_cast<long long>(p - 2) * (h - 2) "
                      "+ i * kJ3RowStep) * ow,\n              __fmul_rn("),
                     ("static_cast<float>(1.0 / 6.0), sum);\n      }\n"
                      "      below[i]",
                      "static_cast<float>(1.0 / 6.0), sum));\n      }\n"
                      "      below[i]"))),
}


def build_all(build, names) -> dict:
    """Every named variant compiled at once; ``{name: library}``."""
    sys.path.insert(0, HERE)
    from gs_sum_probe import replaced
    from ptxas_report import parse
    src = (build.CSRC / "stencil.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        cu = build.BUILD_DIR / f"j3probe_{name}.cu"
        so = build.BUILD_DIR / f"j3probe_{name}.so"
        cu.write_text(replaced(src, VARIANTS[name][1]))
        jobs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe {name}: nvcc failed:\n{log}")
        regs = {k: r for k, r in parse(log).items() if "jacobi3d" in k}
        lib = ctypes.CDLL(str(so))
        lib.stencil_jacobi_3d7pt.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.stencil_jacobi_3d7pt.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        print(f"probe {name}: built; jacobi3d registers, spill stores and "
              f"loads (bytes): " + ", ".join(
                  f"{r[0]} / {r[1]} / {r[2]}" for r in regs.values()))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.kernels.stream import ref as SR

    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build_all(build, names)
    d, h, w = C.JACOBI_3D_SHAPE
    u = torch.randn(C.JACOBI_3D_SHAPE,
                    generator=torch.Generator(device="cuda").manual_seed(21),
                    device="cuda")
    o = torch.empty((d - 2, h - 2, w - 2), device="cuda")
    want = SR.jacobi_3d7pt(u)
    n_bytes = (d * h * w + (d - 2) * (h - 2) * (w - 2)) * 4
    bound_us = n_bytes / C.HBM_BYTES_PER_S * 1e6
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        rc = lib.stencil_jacobi_3d7pt(u.data_ptr(), o.data_ptr(), d, h, w,
                                      stream)
        build.check(lib, rc, "jacobi_3d7pt probe")

    for name in names:
        run(libs[name])
        torch.cuda.synchronize()
        C.check(torch.equal(o, want), f"probe {name}: not bit-identical")
    dst = torch.empty_like(u)
    for rnd in (1, 2):
        copy_us = C.timed(torch, lambda: dst.copy_(u), 5) * 1e3
        print(f"round {rnd}: copy_ of the input {copy_us:.1f} us; byte "
              f"bound {bound_us:.1f} us")
        for name in names:
            us = C.timed(torch, lambda lib=libs[name]: run(lib), 5) * 1e3
            print(f"round {rnd}: {name} ({VARIANTS[name][0]}): {us:.1f} us "
                  f"= {n_bytes / us / 1e3:.0f} GB/s, {bound_us / us:.3f} of "
                  f"the bound (device time by profiler)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
