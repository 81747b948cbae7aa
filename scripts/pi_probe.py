#!/usr/bin/env python3
"""Checks and design probes of ``pi_integration``'s kernel on one NVIDIA
H100.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/pi_probe.py [terms] [variants]

(both when none is named).

- ``terms``: builds ``scripts/pi_probe.cu``, which includes
  ``csrc/stream.cu`` and so runs the shipped ``pi_rcp`` and
  ``pi_quotient``. It holds ``pi_rcp`` against ``__frcp_rn`` on every
  float in [1, 2], and every point's index, quotient and term of the
  kernel's arithmetic against the IEEE divisions for each n of
  ``TERM_NS`` (2^28, 262143 and 3 * 2^20 + 7, all points; also 2^24 - 1,
  outside the reciprocal route's proof, where the kernel divides). It
  counts the points on which the plain version on the card, which
  divides by n as a product with RN(1/n), differs from IEEE division,
  and prints the kernel's and the plain version's distance from the
  float64 sum of the IEEE terms.
- ``variants``: patched copies of ``csrc/stream.cu`` (accumulators a
  lane, blocks an SM, chunk length, partials a warp or a block,
  ``__frcp_rn`` for ``pi_rcp``, IEEE division for the quotient or for
  both divisions), built at once, each timed at n = 2^28 in four rounds
  (forward and reverse), held within 1e-5 of the plain version, with
  ptxas's registers and spills and the instructions a point of its hot
  loop's SASS (``cuobjdump``).

Device times are chip_smoke's (``chip_smoke.timed``: torch.profiler).
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

TERM_NS = (2 ** 28, 262143, 3 * 2 ** 20 + 7, 2 ** 24 - 1)
N = 2 ** 28

_RCP = '''  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);'''
_BLOCK_PARTS = '''  __shared__ float warp_parts[kWarps];
  __shared__ int last_s;
  if (lane == 0) warp_parts[warp] = wsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = warp_parts[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a = __fadd_rn(a, warp_parts[w]);
    parts[blockIdx.x] = a;
    __threadfence();
    const bool last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
    if (last) *counter = 0;  // every block has counted
    __threadfence();
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  float v = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)'''
_WARP_PARTS = '''  __shared__ int last_s;
  if (threadIdx.x == 0) last_s = 0;
  __syncthreads();
  if (lane == 0) {
    parts[blockIdx.x * kWarps + warp] = wsum;
    __threadfence();
    if (atomicAdd(counter, 1) == static_cast<int>(gridDim.x) * kWarps - 1) {
      *counter = 0;
      __threadfence();
      last_s = 1;
    }
  }
  __syncthreads();
  if (!last_s) return;
  float v = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x) * kWarps; b += kThreads)'''


def _const(name: str, old: int, new: int) -> tuple:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


#: label: (replacements in csrc/stream.cu, blocks an SM, reciprocal
#: route); the first is the kernel as shipped
VARIANTS = {
    "shipped: 4 accumulators, 4 blocks an SM, chunks of 32, block "
    "partials, MUFU.RCP + Newton": ((), 4, True),
    "8 accumulators": ((_const("kPiAcc", 4, 8),), 4, True),
    "16 accumulators": ((_const("kPiAcc", 4, 16),), 4, True),
    "2 blocks an SM": ((_const("kPiBlocksPerSm", 4, 2),), 2, True),
    "6 blocks an SM": ((_const("kPiBlocksPerSm", 4, 6),), 6, True),
    "8 blocks an SM": ((_const("kPiBlocksPerSm", 4, 8),), 8, True),
    "chunks of 16": ((_const("kPiChunk", 32, 16),), 4, True),
    "warp partials": (((_BLOCK_PARTS, _WARP_PARTS),), 4, True),
    "__frcp_rn": (((_RCP, "  return __frcp_rn(d);"),), 4, True),
    "IEEE quotient (the route of n outside the proof)": ((), 4, False),
    "two IEEE divisions": (((_RCP, "  return __fdiv_rn(1.0f, d);"),), 4,
                           False),
}


def replaced(src: str, pairs) -> str:
    """``src`` with each (old, new) replaced; raises if an old is absent."""
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"probe: {old[:60]!r} not found in the source")
        src = src.replace(old, new)
    return src


def build_all(build, sources: dict) -> dict:
    """``{name: (library path, compiler output)}`` for ``{name: path of
    a .cu}``, compiled by one ``nvcc`` each, all started together."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, cu in sources.items():
        so = build.BUILD_DIR / f"probe_pi_{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe: {name} failed to build:\n{log}")
        out[name] = (so, log)
    return out


def ptxas_pi(log: str) -> str:
    """Registers and spills of the pi kernels in ptxas's -v output."""
    got = []
    for entry in log.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        if "pi_kernel" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        got.append(f"{'RECIP' if 'ILb1E' in name else 'IEEE'}: "
                   f"{regs.group(1) if regs else '?'} registers, "
                   f"{spill.group(1) if spill else '?'}/"
                   f"{spill.group(2) if spill else '?'} bytes spilled")
    return "; ".join(got)


def issue_per_point(build, so) -> str:
    """Instructions a point in each pi kernel's fastest loop (SASS)."""
    import chip_smoke
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    got = []
    for tag, fn in (("RECIP", "pi_kernelILb1E"), ("IEEE", "pi_kernelILb0E")):
        loops = chip_smoke.sass_loops(sass, fn)
        fast = [(n / r, n, r) for n, r in loops if r >= 16]
        got.append(f"{tag}: " + (f"{min(fast)[0]:.2f} a point "
                                 f"({min(fast)[1]} instructions, "
                                 f"{min(fast)[2]} MUFU.RCP)" if fast else
                                 f"no loop of a chunk found ({loops})"))
    return "; ".join(got)


def probe_terms(torch, build, SR) -> None:
    (so, log), = build_all(build, {"terms": os.path.join(
        HERE, "pi_probe.cu")}).values()
    lib = ctypes.CDLL(str(so))
    lib.probe_pi_rcp.argtypes = [_P, _P]
    lib.probe_pi_terms.argtypes = [_L, _P, _P, _P]
    lib.probe_error_string.argtypes = [_I]
    lib.probe_error_string.restype = ctypes.c_char_p
    stream = torch.cuda.current_stream().cuda_stream

    def ok(rc, what):
        if rc:
            raise RuntimeError(f"{what}: {lib.probe_error_string(rc).decode()}")

    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    ok(lib.probe_pi_rcp(bad.data_ptr(), stream), "rcp")
    print(f"terms: pi_rcp against __frcp_rn on all {2 ** 23 + 1} floats in "
          f"[1, 2]: {int(bad.item())} differ")
    from repro_torch.kernels.stream import kernels as SK
    from repro_torch.kernels.stream import ops as SO
    for n in TERM_NS:
        counts = torch.zeros(4, dtype=torch.int64, device="cuda")
        s64 = torch.zeros(1, dtype=torch.float64, device="cuda")
        ok(lib.probe_pi_terms(n, counts.data_ptr(), s64.data_ptr(), stream),
           "terms")
        c = counts.tolist()
        i = torch.arange(n, dtype=torch.float32, device="cuda")
        x_ieee = (i + 0.5) / torch.full_like(i, float(n))
        x_plain = (i + 0.5) / n   # as ref.pi_integration divides
        plain_x = int((x_plain != x_ieee).sum().item())
        del i, x_ieee, x_plain
        ref = s64.item() / n
        got = SO.pi_integration(n, device="cuda").item()
        plain = SR.pi_integration(n, device="cuda").item()
        print(f"terms: n={n} (reciprocal route "
              f"{SK.pi_quotient_by_reciprocal(n)}), all {n} points against "
              f"IEEE division: index differs on {c[0]}, RN(a * RN(1/n)) "
              f"alone on {c[1]}, the corrected quotient on {c[2]}, the term "
              f"4 * pi_rcp(1 + x * x) on {c[3]}; the plain version on the "
              f"card's x on {plain_x}. Against the float64 sum of the IEEE "
              f"terms ({ref!r}): kernel {got!r} off by {abs(got - ref):.3g}, "
              f"plain {plain!r} off by {abs(plain - ref):.3g}; pi - kernel "
              f"{math.pi - got:.3g}")
        torch.cuda.empty_cache()


def probe_variants(torch, build, SK, SR) -> None:
    import chip_smoke
    src = (build.CSRC / "stream.cu").read_text()
    sources, libs = {}, {}
    for k, (label, (pairs, _, _)) in enumerate(VARIANTS.items()):
        cu = build.BUILD_DIR / f"probe_pi_v{k}.cu"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(replaced(src, pairs))
        sources[f"v{k}"] = cu
    for name, (so, log) in build_all(build, sources).items():
        lib = ctypes.CDLL(str(so))
        lib.stream_pi.argtypes = SK._STREAM_SIGNATURES["stream_pi"]
        lib.stream_pi.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, so, log)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    parts = torch.empty(8 * 8 * sms, dtype=torch.float32, device="cuda")
    out = torch.empty((), dtype=torch.float32, device="cuda")
    want = SR.pi_integration(N, device="cuda").item()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for k, (label, (_, per_sm, recip)) in enumerate(VARIANTS.items()):
        lib, so, log = libs[f"v{k}"]
        blocks = min(per_sm * sms, -(-(-(-N // SK.PI_BLOCK)) // SK.PI_WARPS))

        def call(lib=lib, blocks=blocks, recip=recip):
            build.check(lib, lib.stream_pi(N, int(recip), parts.data_ptr(),
                                           blocks, counter.data_ptr(),
                                           out.data_ptr(), stream), "probe pi")
        call()
        torch.cuda.synchronize()
        got = out.item()
        calls[label] = call
        print(f"variant: {label}: grid {blocks}, pi {got!r} (plain {want!r}"
              f", {'within' if abs(got - want) <= 1e-5 * want else 'NOT within'}"
              f" rtol 1e-5); ptxas {ptxas_pi(log)}; SASS "
              f"{issue_per_point(build, so)}")
    bound_us = N * chip_smoke.PI_OPS_PER_POINT / chip_smoke.FP32_FLOPS * 1e6
    readings = {label: [] for label in calls}
    order = list(calls.items())
    for rnd in (order, order[::-1]) * 2:
        for label, fn in rnd:
            readings[label].append(chip_smoke.timed(
                torch, fn, 10, bound=(label[:40], bound_us, "operations"))
                * 1e3)
    for label, us in readings.items():
        print(f"variant: {label}: mean {sum(us) / len(us):.1f} us, rounds "
              + " / ".join(f"{x:.1f}" for x in us)
              + " (device time by profiler)")
    print(f"variant: SM clock now / max {chip_smoke.sm_clocks_mhz()} MHz")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pi_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from repro_torch.kernels import build
    from repro_torch.kernels.stream import kernels as SK
    from repro_torch.kernels.stream import ref as SR

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    what = sys.argv[1:] or ["terms", "variants"]
    if "terms" in what:
        probe_terms(torch, build, SR)
    if "variants" in what:
        probe_variants(torch, build, SK, SR)
    return 0


if __name__ == "__main__":
    sys.exit(main())
