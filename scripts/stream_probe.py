#!/usr/bin/env python3
"""A/B probes of the stream suite's elementwise body and misaligned INIT
on one NVIDIA H100: the design variants of ``scripts/stream_probe.cu``
timed against each other and against one PyTorch call, at the stream
phase's HBM-resident size (2^28 f32 = 1 GiB an array).

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/stream_probe.py

Each variant's device time comes from ``chip_smoke.timed`` (torch.profiler,
mean device time a call, 10 calls a window), held to its byte bound as
chip_smoke holds its stream timings: a window that reads under the bytes
over 3.35 TB/s is taken again. The list is timed four times, forward and
in reverse in turn, and every reading is printed, so a variant's spread
shows beside its mean. Every variant's output is checked against
PyTorch's once before it is timed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SHAPE = (16384, 16384)
S = 2.0


def build_probe(build) -> ctypes.CDLL:
    src = os.path.join(HERE, "stream_probe.cu")
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"libstream_probe-{digest}.so"
    if not out.exists():
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                              src], capture_output=True, text=True)
        print(res.stdout + res.stderr)
        res.check_returncode()
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_elementwise.argtypes = [I, I, I, I, I, I, I, P, P, P, P, P, L,
                                      ctypes.c_float, P]
    lib.probe_tma_copy.argtypes = [P, P, L, I, I, I, P]
    lib.probe_init_partial.argtypes = [I, I, I, P, P, L, L, ctypes.c_float,
                                       P]
    for f in (lib.probe_elementwise, lib.probe_tma_copy,
              lib.probe_init_partial):
        f.restype = ctypes.c_int
    lib.probe_error_string.argtypes = [ctypes.c_int]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build_probe(build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def ok(rc, what):
        if rc:
            raise RuntimeError(f"{what}: {lib.probe_error_string(rc).decode()}")

    gen = torch.Generator(device="cuda").manual_seed(21)
    xs = [torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(3)]
    o = torch.empty_like(xs[0])
    nvec = o.numel() // 4
    # name, inputs, the plain result (each product rounded before the add)
    ops = {1: ("copy", 1, lambda: xs[0]),
           4: ("stream_triad", 2, lambda: xs[0] + S * xs[1]),
           5: ("schoenauer", 3, lambda: xs[0] + xs[1] * xs[2])}
    lib_calls = {1: lambda: o.copy_(xs[0]),
                 4: lambda: torch.add(xs[0], xs[1], alpha=S, out=o),
                 5: lambda: torch.addcmul(xs[0], xs[1], xs[2], out=o)}

    def occupancy(op, nt, u, nc, chunked, threads):
        occ = ctypes.c_int(0)
        ok(lib.probe_elementwise(op, nt, u, nc, chunked, 0, threads,
                                 ctypes.addressof(occ), None, None, None, None,
                                 0, 0.0, None), "occupancy")
        return occ.value

    variants = []   # (label, fn, want or None, arrays moved)
    # (U, ld.global.nc, chunked, threads, grid): the parent's body (one
    # load a thread a step, grid capped at 32 blocks an SM), the resident
    # grid, and one tile a block (no loop; PyTorch's own layout at U=1)
    cases = [(1, 0, 0, 256, "4 waves (parent)"),
             (1, 0, 0, 256, "a tile a block"), (1, 0, 0, 128, "a tile a block"),
             (2, 0, 0, 256, "a tile a block"), (4, 0, 0, 256, "a tile a block"),
             (1, 1, 0, 256, "a tile a block"), (2, 1, 0, 128, "a tile a block"),
             (4, 0, 0, 256, "resident"), (4, 1, 0, 256, "resident"),
             (4, 0, 1, 256, "resident"), (8, 0, 0, 256, "resident")]
    for op, (name, k, want) in ops.items():
        variants.append((f"{name}: PyTorch call", lib_calls[op], None,
                         k + 1))
        for nt in ((0, 1) if op == 1 else (0,)):
            for u, nc, chunked, threads, grid_kind in cases:
                tiles = nvec // (threads * u)
                if grid_kind == "4 waves (parent)":
                    grid = min(-(-nvec // threads), 32 * sms)
                elif grid_kind == "resident":
                    grid = min(tiles, sms * occupancy(op, nt, u, nc, chunked,
                                                      threads))
                else:
                    grid = tiles
                ptrs = [x.data_ptr() for x in xs[:k]] + [None] * (3 - k)

                def fn(op=op, nt=nt, u=u, nc=nc, chunked=chunked, grid=grid,
                       threads=threads, ptrs=ptrs):
                    ok(lib.probe_elementwise(op, nt, u, nc, chunked, grid,
                                             threads, None, *ptrs,
                                             o.data_ptr(), nvec, S, stream()),
                       "elementwise")
                variants.append((f"{name}: nt={nt} U={u} nc={nc} "
                                 f"{'chunked' if chunked else 'tile-strided'}"
                                 f" {threads} threads grid={grid} "
                                 f"({grid_kind})", fn, want, k + 1))
    for chunk, stages, per_sm in ((16384, 4, 2), (32768, 4, 1),
                                  (16384, 8, 1), (8192, 4, 4)):
        grid = per_sm * sms

        def fn(chunk=chunk, stages=stages, grid=grid):
            ok(lib.probe_tma_copy(xs[0].data_ptr(), o.data_ptr(),
                                  o.numel() * 4, chunk, stages, grid,
                                  stream()), "tma copy")
        variants.append((f"copy: TMA bulk, {chunk // 1024} KiB x {stages} "
                         f"stages, {per_sm} block(s) an SM, grid={grid}", fn,
                         lambda: xs[0], 2))
    m, n = SHAPE
    variants.append(("init_partial: PyTorch fill_", lambda: o.fill_(S),
                     None, 1))
    modes = {0: "a warp a block, resident grid, 16-byte stores",
             1: "a warp a block, one pass, 16-byte stores",
             2: "a 7-warp thread block a block, a warp a row, 16-byte stores",
             3: "a (32, 7) thread block a block, 4-byte stores (parent)"}
    occ = ctypes.c_int(0)
    for cols in (100, 104):
        ok(lib.probe_init_partial(cols, 0, 0, ctypes.addressof(occ), None, 0,
                                  0, 0.0, None), "occupancy")
        for mode, what in modes.items():
            def fn(cols=cols, mode=mode, grid=occ.value * sms):
                ok(lib.probe_init_partial(cols, mode, grid, None,
                                          o.data_ptr(), m, n, S, stream()),
                   "init_partial")
            variants.append((f"init_partial: 7 x {cols} blocks "
                             f"({cols * 4} B rows), {what}", fn,
                             lambda: torch.full(SHAPE, S, device="cuda"), 1))

    wrong = set()
    for label, fn, want, _ in variants:
        if want is not None:
            o.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            if not torch.equal(o, want()):
                wrong.add(label)
    readings = {label: [] for label, _, _, _ in variants}
    for order in (variants, variants[::-1]) * 2:
        for label, fn, _, arrays in order:
            bound_us = arrays * o.numel() * 4 / chip_smoke.HBM_BYTES_PER_S * 1e6
            readings[label].append(chip_smoke.timed(
                torch, fn, 10, bound=(label[:40], bound_us, "hbm")) * 1e3)
    for label, _, _, _ in variants:
        us = readings[label]
        print(f"probe: {label}: mean {sum(us) / len(us):.1f} us, passes "
              + " / ".join(f"{x:.1f}" for x in us)
              + " (device time by profiler)"
              + (" OUTPUT DIFFERS" if label in wrong else ""))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
