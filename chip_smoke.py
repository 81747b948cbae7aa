#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the ``repro`` package and builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc`` itself.
Phases, each printed on its own line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the five kernel sources compiled in parallel with ``nvcc``,
   one line of ptxas's register and spill report for each;
2a. the stream suite (``repro_torch.kernels.stream.ops``, impl="auto"):
   each of its 16 kernels against its plain version at an aligned and a
   ragged shape (the elementwise family in f32, bit for bit, and in
   bf16, within one bf16 ulp of the plain version computed in fp32; the
   NT flavors through ``flavor="nt"``); then its main path, every kernel
   once at HBM-resident sizes (2^28 f32 an array, pi at n = 2^28, Jacobi
   at (16386, 16384) and (514, 512, 1024), Gauss-Seidel at (4098, 4096)
   with 2 sweeps; its checks also run Gauss-Seidel on rows of 20000 and
   40002 columns), launch counts zeroed before and read after, each
   output held against its plain version; then each kernel's time
   beside its bound, its plain version's and one PyTorch call's, the
   three INITs' GB/s, standard against NT stores, and copy, add and
   triad at 2^21 f32 an array (L2-resident). Its buffers are freed
   before the serving phases;
3. the split-KV decode kernel against its plain PyTorch version at
   yi-9b's head shapes (B=8, H=32, Hkv=4, Dh=128, bf16): Skv 4096 and
   4095, per-slot positions spread over the cache, Sq 1 and 4, no window
   and a 256-row window, one split and the default split count; and a
   2048-row cache read up to the serving path's occupancy bounds (kv_len
   472 and 301, rounded up to 128-row blocks, and 301 unrounded); and
   in bf16 and fp32 gemma3-4b's heads (H=8, Hkv=4, Dh=256) and G=16 at
   Sq 1 and 4 (16 and 64 packed rows: one and two row groups). At each
   shape both the per-split partials (merged by ``combine_splits``) and
   the finished output (splits merged inside the kernel, in q's dtype)
   against the plain partials merged and cast (:func:`finished_ok`); the
   split counters all 0 after each call, a repeated call bit-identical,
   and one ``ops.flash_decode`` call one kernel event in a profiler
   window;
3a. the paged decode kernel against its plain version at the same head
   shapes: pages of 8, 16 and 256 rows under a randomly permuted table,
   dead table columns naming a NaN scratch page, Sq 1 and 4, no window
   and 256, one and the default split count, a kv_len cut below the
   horizon; against the dense kernel on the same logical cache; and the
   Dh=256 and 64-packed-row shapes of phase 3; partials and finished
   output, counters, repeats and one ``ops.flash_decode_paged`` event as
   in phase 3;
3b. the flash-attention kernel against its plain version at yi-9b
   prefill shapes (B=1, H=32, Hkv=4, Dh=128), S 512, 2048 and 509,
   causal and causal with a 256-row window, in fp32 and bf16, and at
   gemma3-4b's heads (H=8, Hkv=4, Dh=256), S 509 and 2048;
4. the KV row writer against its plain version, both store flavors,
   byte for byte, with a clamped overshoot row, in place;
5. the full-width 48-layer yi-9b ``ServeEngine`` (random weights from a
   seeded generator on the card): 16 greedy requests, prompts of 128 to
   512 tokens, 64 new tokens each, 8 slots, a 2048-row horizon, 8-token
   chunks. Kernel launch counts are zeroed just before the run and read
   just after. One decode step's logits through the kernels are held
   against the same step with ``impl="ref"`` for four prompt sets, and a
   smoke-size fp32 engine's greedy streams on the card against the same
   engine on the CPU;
5b. the flash-attention entry point (``ops.flash_attention_bshd``) on
   layer 0's queries, keys and values of a 2048-token prompt, launch
   counts zeroed before and read after;
5c. the full-width ``PagedServeEngine`` with the same weights: page 16,
   320 pages, 16 greedy requests sharing a 256-token prefix (plus 0-256
   tokens each, 64 new), one forked after its first chunk and one
   cancelled. Launch counts zeroed before and read after, the pool
   checked after every round; then one decode step through the paged
   kernel against the dense kernel on the same prompts, and a smoke-size
   fp32 paged engine's greedy streams on the card against the CPU and
   against the dense engine;
6. per kernel its time at the path's shapes, its bound, its plain
   version's time and a library call's time (none for the paged kernel:
   no single PyTorch call reads a paged cache), with the achieved GB/s
   (decode) or TFLOP/s (flash attention) and their share of the card's
   peak. The decode rows time the finished ``ops.flash_decode`` and
   ``ops.flash_decode_paged`` (one launch each, a finished output as
   sdpa's), with the partials-only launch beside them, and the paged
   kernel at 4 splits (one block an SM) beside its default 5; their
   bound counts the finished output's bytes (:func:`decode_bound`). The
   three attention kernels at gemma3-4b's heads (Dh=256) beside their
   bounds and sdpa; then, for the dense and the paged engine, two
   full-width decode dispatches of the same 8 requests timed once on the
   wall clock and once under the profiler: the device's busy time and
   kernel launches per step, its idle share and where the time goes; the
   ``kernels`` JSON line (all 20 kernels, phase 2a's among them) comes
   last but one.

Every timing is device time from ``torch.profiler``. A profiler window
that reads a call under a bound that is a true floor (the bytes of an
HBM-resident working set, or any operation count; ``under_bound``) is
taken again and named, as an empty window is; the L2 rung and the decode
kernels, whose working sets fit the 50 MB L2, are not held to their byte
bounds.

TF32 is switched off for matmuls and cuDNN, so fp32 references on the
card run in full fp32. Any failed phase raises and the script exits
non-zero; so does a machine without a CUDA device, or a directory
without the repository's ``src/repro_torch``. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 on the tensor cores

# yi-9b head shapes of the serving path
B, H, HKV, DH = 8, 32, 4, 128
# tolerances. The decode kernel and its plain version both compute in
# fp32 from the same bf16 inputs; they differ only in summation order and
# exp rounding, so the normalized fp32 outputs agree to ~1e-6.
DECODE_TOL = 1e-4
# the router's bf16 output against the fp32 dense oracle: one bf16
# rounding (half an ulp, at most 2**-6 for the magnitudes below 8 that
# softmax-weighted unit normals take)
BF16_OUT_TOL = 2 ** -6
# one decode step at full width, kernels vs impl="ref" (their plain
# versions): both attention paths sum in fp32 in different orders, so a
# layer's bf16 attention output can differ by one ulp where the sums
# straddle a rounding boundary, and 48 random-weight layers amplify such
# flips. Held as max |diff| over max |logit|, for each of four prompt
# sets. On an H100 the served prompts read 0.0204 and 0.0236 in two
# runs; the limit leaves twice that room for other prompt sets (their
# spread is recorded in PERF.md). A wrong occupancy bound or split is
# caught at 1e-4 by the kernel cases of phase 3, not here.
LOGITS_REL_TOL = 5e-2
LOGITS_SEEDS = (11, 12, 13)       # prompt sets beside the served prompts
# flash attention in fp32 against its plain version: both sum the same
# products in fp32 in different orders over up to 2048 keys; the outputs
# (weighted means of unit normals) agree to ~1e-6
FLASH_F32_TOL = 1e-4
PROFILE_ATTEMPTS = 3              # profiler windows before a timing fails
#: kinds of bound under which no reading can fall: the bytes of a working
#: set that lives in device memory (far larger than the 50 MB L2), and
#: any operation count. A bound of kind "l2" (the bytes of a working set
#: that can stay in L2 between timed calls: the L2 rung, the decode
#: kernels' ~6 MB of live rows) is no floor and is not checked.
FLOOR_KINDS = ("hbm", "operations")


class PhaseError(RuntimeError):
    """A smoke phase failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def device_us(prof, counts: dict | None = None) -> dict:
    """Device microseconds by name: every kernel, copy and fill the
    profile saw on the card (host-side operator rows are left out, so
    no kernel is counted twice). ``counts``, when given, gets the number
    of events by name.

    Read from the profiler's raw Kineto events, filtered and named as
    ``prof.events()`` names them: building that Python event tree costs
    seconds for a window of tens of thousands of launches, and these
    sums need none of it."""
    from torch._C import _demangle
    from torch.autograd import DeviceType
    out, names = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA \
                or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        raw = ev.name()
        if raw not in names:
            names[raw] = _demangle(raw)
        out[names[raw]] = out.get(names[raw], 0.0) + ev.duration_ns() / 1e3
        if counts is not None:
            counts[names[raw]] = counts.get(names[raw], 0) + 1
    return out


def under_bound(by_name_us: dict, bounds_us: dict) -> list:
    """The readings that fall under a bound that is a true floor.

    ``by_name_us`` maps a kernel (or call) to its reading in µs;
    ``bounds_us`` maps it to ``(bound µs, kind)``, kind one of
    :data:`FLOOR_KINDS` or ``"l2"``. Returns ``[(name, reading, bound)]``
    for every name read under a bound of a kind in :data:`FLOOR_KINDS`,
    in the order of ``bounds_us``; a name without a reading is skipped.
    """
    return [(name, by_name_us[name], bound)
            for name, (bound, kind) in bounds_us.items()
            if kind in FLOOR_KINDS and name in by_name_us
            and by_name_us[name] < bound]


def profiled(torch, run, what: str, setup=None, counts=None,
             faults=None) -> dict:
    """Device microseconds by name over one ``run()``, under
    ``torch.profiler``; ``setup()``, when given, runs before each window,
    outside it. ``counts``, when given, gets the window's events by name.

    Rarely a profile on the card records no device event at all (seen
    once on an H100); such a window is taken again, up to
    ``PROFILE_ATTEMPTS`` windows in all, and said so. So is a window for
    which ``faults(by_name, counts)``, when given, returns a non-empty
    list of what is wrong with it (a reading under its bound; see
    :func:`timed`), each named. If no window is free of both the phase
    fails: there is no fallback to another clock.
    """
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if setup is not None:
            setup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if counts is not None:
            counts.clear()
        by_name = device_us(prof, counts)
        if sum(by_name.values()) <= 0:
            print(f"{what}: the profiler saw no device time in window "
                  f"{attempt}")
            continue
        wrong = faults(by_name, counts) if faults is not None else []
        if wrong:
            print(f"{what}: window {attempt} taken again: "
                  + "; ".join(wrong))
            continue
        if attempt > 1:
            print(f"{what}: measured in window {attempt}")
        return by_name
    raise PhaseError(f"{what}: no usable profiler window in "
                     f"{PROFILE_ATTEMPTS} (none saw device time, or every "
                     f"one read under a bound)")


def timed(torch, fn, iters: int, warmup: int = 3, bound=None) -> float:
    """Milliseconds of device work per ``fn()`` call.

    The device time of every kernel, copy and fill that ``iters`` calls
    launch, from ``torch.profiler`` (see :func:`profiled`): host launch
    overhead between calls does not count. The profiler on the H100
    misses some of a window's events (seen: 477 of 480 decode launches in
    every window, 4 of 5 of one elementwise kernel, three 1 GiB copies
    summing to one copy's time), so each name counts its mean event time
    times its events a call (its count over ``iters``, rounded, at least
    1), not its sum over ``iters``. A name that misses more than a tenth
    of its events is said so.

    ``bound``, when given, is ``(name, µs, kind)`` for the work of one
    call (see :func:`under_bound`): a window that reads the call under a
    bound that is a true floor is taken again, as an empty one is, and
    named with its reading; if every window reads under, the phase fails.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    def per_call_us(by_name, counts, say=False):
        us = 0.0
        for name, total in by_name.items():
            a_call = max(1, round(counts[name] / iters))
            if say and counts[name] < 0.9 * a_call * iters:
                print(f"timing: the profiler recorded {counts[name]} of "
                      f"{a_call * iters} events of {name[:60]}")
            us += total / counts[name] * a_call
        return us

    def faults(by_name, counts):
        name, bound_us, kind = bound
        return [f"{n} read {r:.2f} us, under its {kind} bound {b:.2f} us"
                for n, r, b in under_bound(
                    {name: per_call_us(by_name, counts)},
                    {name: (bound_us, kind)})]

    counts = {}
    by_name = profiled(torch, run, "timing", counts=counts,
                       faults=None if bound is None else faults)
    return per_call_us(by_name, counts, say=True) / 1e3


# --- phase 1: device -------------------------------------------------------

def phase_device(torch) -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


# --- phase 2: build --------------------------------------------------------

def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    dt = time.perf_counter() - t0
    print(f"build: compiled {built or 'nothing (up to date)'} in {dt:.1f} s")
    for name in build.SOURCES:
        log = build.library_path(name).with_name(
            build.library_path(name).name + ".log").read_text()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)] or [0]
        print(f"build: {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes of spill stores and loads, at most "
              f"{max(smem)} bytes of static shared memory (ptxas -v)")


# --- phase 2a: the stream suite --------------------------------------------

STREAM_CHECK_SHAPES = ((256, 512), (253, 484))   # aligned and ragged
STREAM_HBM_SHAPE = (16384, 16384)    # 2^28 f32 = 1 GiB an array, >> L2
STREAM_L2_SHAPE = (2048, 1024)       # 2^21 f32 = 8 MiB an array, in L2
JACOBI_2D_SHAPE = (16386, 16384)
JACOBI_3D_SHAPE = (514, 512, 1024)
GS_SHAPE, GS_SWEEPS = (4098, 4096), 2
PI_N = 2 ** 28
STREAM_S = 2.0                       # the UPDATE and triad scalar
STREAM_SUM_RTOL = 1e-5
STENCIL_TOL = 1e-6
PI_OPS_PER_POINT = 6                 # +0.5, /n, x*x, 1+, 4/, the sum
STREAM_KPY = "src/repro/kernels/stream/kernels.py"
# name: (line of its pallas_call or function in STREAM_KPY, CUDA source)
STREAM_KERNELS = {
    "init_store": (94, "stream"), "init_partial": (112, "stream"),
    "init_nt": (120, "stream"), "copy_nt": (136, "stream"),
    "update_nt": (170, "stream"), "stream_triad_nt": (191, "stream"),
    "copy": (146, "stream"), "add": (160, "stream"),
    "update": (180, "stream"), "stream_triad": (202, "stream"),
    "schoenauer_triad": (218, "stream"), "sum_reduction": (233, "stream"),
    "pi_integration": (252, "stream"), "jacobi_2d5pt": (283, "stencil"),
    "jacobi_3d7pt": (313, "stencil"), "gauss_seidel_2d5pt": (347, "stencil"),
}


def bf16_ulp(torch, x):
    """The bf16 ulp at |x|, for bf16 values held in fp32."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_ulps(torch, got, want_f32) -> float:
    """max |got - want| in bf16 ulps at |want|, ``want`` the fp32 result
    rounded once to bf16."""
    want = want_f32.bfloat16().float()
    return ((got.float() - want).abs() / bf16_ulp(torch, want)).max().item()


#: the PyTorch call timed beside each elementwise kernel (NT and standard)
STREAM_LIBRARY = {"copy": "copy_", "add": "torch.add(out=)",
                  "update": "torch.mul(out=)",
                  "stream_triad": "torch.add(alpha=, out=)",
                  "schoenauer_triad": "torch.addcmul(out=)"}


def stream_elementwise(torch, SO, SR) -> dict:
    """name: (inputs, call through ``ops``, plain version, library call
    into ``out``, fp32 operations an element) for the elementwise family
    with tensor inputs."""
    s = STREAM_S
    return {
        "copy": (1, lambda x: SO.copy(x[0]), lambda x: SR.copy(x[0]),
                 lambda x, o: o.copy_(x[0]), 0),
        "copy_nt": (1, lambda x: SO.copy(x[0], flavor="nt"),
                    lambda x: SR.copy(x[0]), lambda x, o: o.copy_(x[0]), 0),
        "add": (2, lambda x: SO.add(x[0], x[1]),
                lambda x: SR.add(x[0], x[1]),
                lambda x, o: torch.add(x[0], x[1], out=o), 1),
        "update": (1, lambda x: SO.update(x[0], s),
                   lambda x: SR.update(x[0], s),
                   lambda x, o: torch.mul(x[0], s, out=o), 1),
        "update_nt": (1, lambda x: SO.update(x[0], s, flavor="nt"),
                      lambda x: SR.update(x[0], s),
                      lambda x, o: torch.mul(x[0], s, out=o), 1),
        "stream_triad": (2, lambda x: SO.stream_triad(x[0], x[1], s),
                         lambda x: SR.stream_triad(x[0], x[1], s),
                         lambda x, o: torch.add(x[0], x[1], alpha=s, out=o),
                         2),
        "stream_triad_nt": (2, lambda x: SO.stream_triad(x[0], x[1], s,
                                                         flavor="nt"),
                            lambda x: SR.stream_triad(x[0], x[1], s),
                            lambda x, o: torch.add(x[0], x[1], alpha=s,
                                                   out=o), 2),
        "schoenauer_triad": (3, lambda x: SO.schoenauer_triad(*x[:3]),
                             lambda x: SR.schoenauer_triad(*x[:3]),
                             lambda x, o: torch.addcmul(x[0], x[1], x[2],
                                                        out=o), 2),
    }


def stream_inits(SO) -> dict:
    """name: call (shape, dtype) through ``ops`` for the three INITs."""
    return {
        "init_store": lambda sh, dt: SO.init(sh, STREAM_S, dt,
                                             device="cuda"),
        "init_partial": lambda sh, dt: SO.init_partial(sh, STREAM_S, dt,
                                                       device="cuda"),
        "init_nt": lambda sh, dt: SO.init(sh, STREAM_S, dt, flavor="nt",
                                          device="cuda"),
    }


def phase_stream_check(torch, K, SO, SR) -> dict:
    """Every stream kernel through ``ops`` (impl="auto") on CUDA tensors
    at an aligned and a ragged shape, against its plain version: f32
    elementwise bit for bit, bf16 within one bf16 ulp of the plain
    version computed in fp32 from the same bf16 inputs (the kernels round
    once), sums at rtol 1e-5 (bf16 against the fp32-accumulated plain
    sum), stencils at 1e-6, each also on a view whose data start 4 bytes
    past a 16-byte boundary, Gauss-Seidel also with one interior row,
    more than one sweep and rows wider than 16,384 interior columns (20000
    and 40002). Launch counts zeroed before, read after.
    Returns the largest absolute error by kernel."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20)
    errs = {}

    def note(name, err, ok, what):
        check(ok, f"stream: {name} {what}: error {err:.3g}")
        errs[name] = max(errs.get(name, 0.0), err)

    K.reset_launches()
    elementwise = stream_elementwise(torch, SO, SR)
    for shape in STREAM_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(3)]
            for name, (n, call, plain, _, _) in elementwise.items():
                got = call(xs[:n])
                check(got.dtype == dtype and tuple(got.shape) == shape,
                      f"stream: {name} returned {got.dtype} {got.shape}")
                if dtype == torch.float32:
                    want = plain(xs[:n])
                    err = (got - want).abs().max().item()
                    note(name, err, torch.equal(got, want),
                         f"f32 {shape} not bit-identical to plain")
                else:
                    want = plain([x.float() for x in xs[:n]])
                    ulps = bf16_ulps(torch, got, want)
                    note(name, (got.float() - want).abs().max().item(),
                         ulps <= 1.0, f"bf16 {shape} {ulps:.2f} ulp")
            for name, call in stream_inits(SO).items():
                got = call(shape, dtype)
                want = SR.init(shape, STREAM_S, dtype, "cuda")
                note(name, (got.float() - want.float()).abs().max().item(),
                     torch.equal(got, want), f"{dtype} {shape} differs")
            got = SO.sum_reduction(xs[0])
            want = SR.sum_reduction(xs[0].float())
            err = (got - want).abs().item()
            note("sum_reduction", err, got.dtype == torch.float32 and
                 err <= STREAM_SUM_RTOL * want.abs().item(),
                 f"{dtype} {shape}")
    for n in (262144, 262143):
        got = SO.pi_integration(n, device="cuda")
        want = SR.pi_integration(n, device="cuda")
        err = (got - want).abs().item()
        note("pi_integration", err, err <= STREAM_SUM_RTOL * want.item()
             and abs(got.item() - math.pi) < 1e-4 * math.pi, f"n={n}")
    for name, shape, args in (
            ("jacobi_2d5pt", (258, 514), ()), ("jacobi_2d5pt", (253, 484), ()),
            ("jacobi_3d7pt", (18, 34, 130), ()),
            ("jacobi_3d7pt", (17, 29, 101), ()),
            ("gauss_seidel_2d5pt", (34, 128), (2,)),
            ("gauss_seidel_2d5pt", (33, 101), (1,)),
            ("gauss_seidel_2d5pt", (3, 2500), (2,)),   # one interior row
            ("gauss_seidel_2d5pt", (3, 101), (3,)),
            # wider than the 16,384 interior columns held in registers:
            # the rest of each row is staged in the scratch row
            ("gauss_seidel_2d5pt", (6, 20000), (2,)),
            ("gauss_seidel_2d5pt", (5, 40002), (1,))):
        # the grid itself, then a contiguous view at an offset that is no
        # multiple of 16 bytes (the stencils load one float at a time)
        base = torch.randn((shape[0] + 1,) + shape[1:], generator=gen,
                           device="cuda")
        for u, what in ((base[:-1], f"{shape}"),
                        (base[1:], f"{shape} view at a 4-byte offset")):
            got = getattr(SO, name)(u, *args)
            want = getattr(SR, name)(u, *args)
            err = (got - want).abs().max().item()
            note(name, err, got.shape == want.shape and err <= STENCIL_TOL,
                 what)
    torch.cuda.synchronize()
    moved = {n: K.LAUNCHES[n] for n in STREAM_KERNELS}
    check(all(moved.values()), f"stream: kernels never launched: "
          f"{[n for n, c in moved.items() if not c]}")
    print(f"stream kernels: 16 kernels through ops (impl='auto') vs plain "
          f"at {STREAM_CHECK_SHAPES[0]} and {STREAM_CHECK_SHAPES[1]} "
          f"(stencils and pi at their own aligned and ragged sizes): f32 "
          f"elementwise bit-identical, bf16 within 1 ulp of the fp32 plain "
          f"result, sums rtol {STREAM_SUM_RTOL}, stencils {STENCIL_TOL}; "
          f"launches {moved}")
    print("stream kernels: max abs err " + ", ".join(
        f"{n} {e:.3g}" for n, e in errs.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    return errs


def phase_stream(torch, K, SO, SR, errs) -> list:
    """The suite's main path at HBM-resident sizes: each of the 16
    kernels once through ``ops`` (impl="auto"), launch counts zeroed
    before and read after, each output held against its plain version;
    then each kernel's device time beside its bound, its plain version's
    and one PyTorch call's, the three INITs' GB/s, standard against NT
    stores, and copy, add and triad at an L2-resident size."""
    t0 = time.perf_counter()
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(21)
    xs = [torch.randn(STREAM_HBM_SHAPE, generator=gen, device="cuda")
          for _ in range(3)]
    n_el = xs[0].numel()
    j2 = torch.randn(JACOBI_2D_SHAPE, generator=gen, device="cuda")
    j3 = torch.randn(JACOBI_3D_SHAPE, generator=gen, device="cuda")
    gs = torch.randn(GS_SHAPE, generator=gen, device="cuda")
    elementwise = stream_elementwise(torch, SO, SR)
    inits = stream_inits(SO)
    stencils = {"jacobi_2d5pt": (j2, ()), "jacobi_3d7pt": (j3, ()),
                "gauss_seidel_2d5pt": (gs, (GS_SWEEPS,))}

    # the main path: every kernel once, launch counts zeroed before
    K.reset_launches()
    outs = {n: call(xs[:k]) for n, (k, call, _, _, _) in elementwise.items()}
    outs.update((n, call(STREAM_HBM_SHAPE, torch.float32))
                for n, call in inits.items())
    outs["sum_reduction"] = SO.sum_reduction(xs[0])
    outs["pi_integration"] = SO.pi_integration(PI_N, device="cuda")
    outs.update((n, getattr(SO, n)(u, *a)) for n, (u, a) in stencils.items())
    torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in STREAM_KERNELS}
    check(all(c == 1 for c in launches.values()),
          f"stream: main path launches {launches}, expected 1 each")
    for n, (k, _, plain, _, _) in elementwise.items():
        check(torch.equal(outs.pop(n), plain(xs[:k])),
              f"stream: {n} at {STREAM_HBM_SHAPE} not bit-identical")
    full = SR.init(STREAM_HBM_SHAPE, STREAM_S, torch.float32, "cuda")
    for n in inits:
        check(torch.equal(outs.pop(n), full), f"stream: {n} at "
              f"{STREAM_HBM_SHAPE} differs")
    del full
    for n, want in (("sum_reduction", SR.sum_reduction(xs[0])),
                    ("pi_integration", SR.pi_integration(PI_N,
                                                         device="cuda"))):
        err = (outs.pop(n) - want).abs().item()
        check(err <= STREAM_SUM_RTOL * abs(want.item()),
              f"stream: {n} main path error {err:.3g}")
    for n, (u, a) in stencils.items():
        err = (outs.pop(n) - getattr(SR, n)(u, *a)).abs().max().item()
        check(err <= STENCIL_TOL, f"stream: {n} main path error {err:.3g}")
        errs[n] = max(errs[n], err)
    print(f"stream main path: 16 kernels through ops (impl='auto') at "
          f"2^{int(math.log2(n_el))} f32 an array {STREAM_HBM_SHAPE}, pi "
          f"n=2^{int(math.log2(PI_N))}, jacobi "
          f"{JACOBI_2D_SHAPE} and {JACOBI_3D_SHAPE}, gauss-seidel "
          f"{GS_SHAPE} x {GS_SWEEPS} sweeps: every output held against its "
          f"plain version; launches {launches}")

    # timings
    o = torch.empty_like(xs[0])
    rows, ms_of = [], {}

    def row(name, kern, plain, library, lib_name, n_bytes, n_ops, *,
            iters=10, plain_iters=3, plain_warmup=3, what=""):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / FP32_FLOPS * 1e3
        # every array here lives in device memory (>> L2): the bound is a
        # floor for the kernel, its plain version and the library call
        bound = (name, max(t_bytes, t_ops) * 1e3,
                 "hbm" if t_bytes >= t_ops else "operations")
        ms = timed(torch, kern, iters, bound=bound)
        plain_ms = timed(torch, plain, plain_iters, warmup=plain_warmup,
                         bound=bound)
        lib_ms = None if library is None else timed(torch, library, iters,
                                                    bound=bound)
        line, src = STREAM_KERNELS[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"{STREAM_KPY}:{line}", "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
        ms_of[name] = ms
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f} us"
        rate = (f"{n_bytes / ms / 1e6:.0f} GB/s" if t_bytes >= t_ops else
                f"{n_ops / ms / 1e9:.0f} GFLOP/s")
        print(f"timing: {name} {what}: {ms * 1e3:.1f} us = {rate}, bound "
              f"{rows[-1]['bound_ms'] * 1e3:.1f} us "
              f"({rows[-1]['bound_by']}), plain {plain_ms * 1e3:.1f} us, "
              f"{lib_name} {lib} (device time by profiler)")

    for name, call in inits.items():
        row(name, lambda c=call: c(STREAM_HBM_SHAPE, torch.float32),
            lambda: SR.init(STREAM_HBM_SHAPE, STREAM_S, torch.float32,
                            "cuda"), lambda: o.fill_(STREAM_S), "fill_",
            n_el * 4, 0, what=f"f32 {STREAM_HBM_SHAPE}")
    for name, (k, call, plain, lib, flops) in elementwise.items():
        row(name, lambda c=call, k=k: c(xs[:k]),
            lambda p=plain, k=k: p(xs[:k]),
            lambda f=lib, k=k: f(xs[:k], o),
            STREAM_LIBRARY[name.removesuffix("_nt")],
            n_el * 4 * (k + 1), n_el * flops, what=f"f32 {STREAM_HBM_SHAPE}")
    row("sum_reduction", lambda: SO.sum_reduction(xs[0]),
        lambda: SR.sum_reduction(xs[0]), lambda: torch.sum(xs[0]),
        "torch.sum", n_el * 4, n_el, what=f"f32 {STREAM_HBM_SHAPE}")
    row("pi_integration", lambda: SO.pi_integration(PI_N, device="cuda"),
        lambda: SR.pi_integration(PI_N, device="cuda"), None,
        "no single PyTorch call:", -(-PI_N // 4096) * 4,   # its partials
        PI_N * PI_OPS_PER_POINT, what=f"n={PI_N} ({PI_OPS_PER_POINT} fp32 "
        f"operations a point)")
    w2 = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                       [0.0, 0.25, 0.0]], device="cuda")[None, None]
    w3 = torch.zeros(1, 1, 3, 3, 3, device="cuda")
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w3[(0, 0) + idx] = 1.0 / 6.0
    h, w = JACOBI_2D_SHAPE
    row("jacobi_2d5pt", lambda: SO.jacobi_2d5pt(j2),
        lambda: SR.jacobi_2d5pt(j2), lambda: F.conv2d(j2[None, None], w2),
        "conv2d", (h * w + (h - 2) * (w - 2)) * 4, (h - 2) * (w - 2) * 4,
        what=f"{JACOBI_2D_SHAPE}")
    d, h, w = JACOBI_3D_SHAPE
    row("jacobi_3d7pt", lambda: SO.jacobi_3d7pt(j3),
        lambda: SR.jacobi_3d7pt(j3), lambda: F.conv3d(j3[None, None], w3),
        "conv3d", (d * h * w + (d - 2) * (h - 2) * (w - 2)) * 4,
        (d - 2) * (h - 2) * (w - 2) * 6, iters=5,
        what=f"{JACOBI_3D_SHAPE}")
    h, w = GS_SHAPE
    row("gauss_seidel_2d5pt", lambda: SO.gauss_seidel_2d5pt(gs, GS_SWEEPS),
        lambda: SR.gauss_seidel_2d5pt(gs, GS_SWEEPS), None,
        "no single PyTorch call:", h * w * 4 * 2,
        (h - 2) * (w - 2) * 4 * GS_SWEEPS, iters=3, plain_iters=1,
        plain_warmup=0,   # its ~41,000 launches ran once in the check above
        what=f"{GS_SHAPE} x {GS_SWEEPS} sweeps")
    print(f"timing: gauss_seidel_2d5pt: "
          f"{ms_of['gauss_seidel_2d5pt'] * 1e6 / ((h - 2) * GS_SWEEPS):.0f} "
          f"ns a row step of the one-block wavefront (its measured time over "
          f"{h - 2} rows x {GS_SWEEPS} sweeps)")

    gbs = {n: n_el * 4 / ms_of[n] / 1e6 for n in inits}
    print(f"stream: INIT at {n_el} f32 ({n_el * 4 / 2**30:g} GiB "
          f"written), effective GB/s: "
          f"init_store {gbs['init_store']:.0f}, init_partial "
          f"{gbs['init_partial']:.0f} (7 x 100 blocks, half of them "
          f"sector-misaligned), init_nt {gbs['init_nt']:.0f}; bound "
          f"{HBM_BYTES_PER_S / 1e9:.0f}")
    print("stream: standard vs NT (st.global.cs) stores, device us: "
          + ", ".join(f"{n} {ms_of[n] * 1e3:.1f} vs {ms_of[nt] * 1e3:.1f}"
                      for n, nt in (("init_store", "init_nt"),
                                    ("copy", "copy_nt"),
                                    ("update", "update_nt"),
                                    ("stream_triad", "stream_triad_nt"))))
    del o, j2, j3, gs
    ls = [x[:STREAM_L2_SHAPE[0] * STREAM_L2_SHAPE[1]].reshape(
        STREAM_L2_SHAPE).clone() for x in (xs[0].view(-1), xs[1].view(-1))]
    del xs
    lo = torch.empty_like(ls[0])
    n_l2 = ls[0].numel()
    rung = []
    for name, k, lib in (("copy", 1, lambda: lo.copy_(ls[0])),
                         ("add", 2, lambda: torch.add(ls[0], ls[1], out=lo)),
                         ("stream_triad", 2, lambda: torch.add(
                             ls[0], ls[1], alpha=STREAM_S, out=lo))):
        call = elementwise[name][1]
        ms = timed(torch, lambda c=call, k=k: c(ls[:k]), 200)
        lib_ms = timed(torch, lib, 200)
        b = n_l2 * 4 * (k + 1)
        rung.append(f"{name} {ms * 1e3:.2f} us = {b / ms / 1e6:.0f} GB/s "
                    f"(library {lib_ms * 1e3:.2f} us = "
                    f"{b / lib_ms / 1e6:.0f} GB/s)")
    print(f"stream: L2 rung, {n_l2} f32 ({n_l2 * 4 / 2**20:g} MiB) an "
          f"array, back to back: "
          + "; ".join(rung))
    del ls, lo
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"stream phase: {time.perf_counter() - t0:.1f} s")
    return rows


# --- phase 3: decode kernel ------------------------------------------------

# (B, H, Hkv, Dh, Sq values) checked beside yi-9b's heads: gemma3-4b's
# head_dim 256, and G = 16 (qwen3-moe-235b) at Sq = 4, 64 packed rows
WIDE_DECODE_SHAPES = ((4, 8, 4, 256, (1, 4)), (2, 64, 4, 128, (1, 4)))


def finished_ok(torch, got, want_f32) -> tuple:
    """``(ok, max abs err)`` of a finished decode output in q's dtype
    against the plain version's fp32 output (partials merged by
    ``combine_splits``). fp32: within DECODE_TOL, as the partials. bf16:
    within one bf16 ulp of the plain output rounded to bf16 (what
    ``.to(torch.bfloat16)`` gives), plus DECODE_TOL: both sides round an
    fp32 value once, and the two fp32 values, their sums taken in other
    orders, differ by up to DECODE_TOL."""
    want = want_f32.to(got.dtype).float()
    err = (got.float() - want).abs()
    lim = DECODE_TOL
    if got.dtype == torch.bfloat16:
        lim = bf16_ulp(torch, want) + DECODE_TOL
    return bool((err <= lim).all()), err.max().item()


def same_bits(torch, a, b) -> bool:
    """Whether two tensors of one dtype and shape hold the same bits."""
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def check_finished(torch, D, call, want_f32, what: str) -> float:
    """The finished output of ``call()`` (one kernel launch) against the
    plain version's fp32 output (:func:`finished_ok`), a second call's
    bits against the first's, and the split counters all 0 after each;
    returns the max abs err."""
    got = call()
    torch.cuda.synchronize()
    counters = D.split_counters(got.device)
    check(not counters.any(), f"{what}: split counters not 0 after a call")
    again = call()
    torch.cuda.synchronize()
    check(not counters.any(), f"{what}: split counters not 0 after a call")
    check(same_bits(torch, got, again), f"{what}: two calls differ")
    ok, err = finished_ok(torch, got, want_f32)
    check(ok, f"{what}: finished output err {err:.3g} over one "
          f"{'bf16 ulp + ' if got.dtype == torch.bfloat16 else ''}"
          f"{DECODE_TOL}")
    return err


#: the decode kernels' names as the profiler demangles them (the bf16 and
#: fp32 bodies, each with PAGED = false and true; also their former names,
#: decode_partials_*, so a trace of an older checkout groups them alike)
DECODE_KERNEL = re.compile(r"\bdecode_(partials_)?(f32_)?kernel<")


def one_kernel_event(torch, call, what: str) -> None:
    """One ``call()`` (warm, its counters made) puts exactly one device
    event, the decode kernel, in a profiler window."""
    call()
    torch.cuda.synchronize()
    counts = {}
    profiled(torch, call, what, counts=counts)
    check(sum(counts.values()) == 1 and all(
        DECODE_KERNEL.search(n) for n in counts),
        f"{what}: one call put {counts} on the card, not one decode kernel")
    print(f"{what}: one call is one kernel event ({next(iter(counts))[:60]})")


def decode_bound(b: int, h: int, hkv: int, dh: int, live: int, elt: int,
                 table_entries: int = 0) -> tuple:
    """``(bound ms, "bytes" or "operations", bytes)`` of one finished
    decode call at Sq = 1: q read once (``elt`` bytes an element), K and
    V of each of the ``live`` rows its slots read once, pos and the block
    table's entries read (4 bytes each), and the (B, 1, H, Dh) output
    written once in q's dtype; against 4 * Dh operations for each (query
    head, live row) pair at the fp32 rate."""
    n_bytes = (2 * b * h * dh * elt + live * hkv * dh * 2 * elt + b * 4
               + table_entries * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = live * h * dh * 4 / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes)


def phase_decode(torch, D, ops) -> float:
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = worst_fin = 0.0
    cases = 0

    def case(q, k, v, pos, window, bound, split_len, n, what):
        nonlocal worst, worst_fin, cases
        dense = D.ref_decode(q.float(), k.float(), v.float(), pos,
                             window=window, kv_len=bound)
        kw = dict(window=window, split_len=split_len, n_splits=n,
                  bound=bound)
        ok_, mk, lk = D.decode_partials(q, k, v, pos, impl="cuda", **kw)
        orf, mr, lr = D.decode_partials(q, k, v, pos, impl="ref", **kw)
        torch.cuda.synchronize()
        got = D.combine_splits(ok_, mk, lk)
        ref = D.combine_splits(orf, mr, lr)
        err = (got - ref).abs().max().item()
        err_dense = (got - dense.float()).abs().max().item()
        where = f"{what} bound={bound} n_splits={n}"
        check(torch.equal(lk == 0, lr == 0), f"decode: dead splits differ "
              f"({where})")
        check(err <= DECODE_TOL and err_dense <= DECODE_TOL,
              f"decode: max err {err:.3g} (dense {err_dense:.3g}) > "
              f"{DECODE_TOL} at {where}")
        fin = check_finished(torch, D, lambda: D.decode_finished(
            q, k, v, pos, impl="cuda", **kw), ref, f"decode {where}")
        worst = max(worst, err)
        worst_fin = max(worst_fin, fin)
        cases += 1

    for skv in (4096, 4095):
        k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
        for sq in (1, 4):
            # per-slot positions spread over the whole cache
            pos = torch.linspace(0, skv - sq, B, device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen, device="cuda").bfloat16()
            for window in (None, 256):
                for ns in (1, None):
                    bound, split_len, n = D.split_plan(B, HKV, skv, 128, ns,
                                                       None)
                    case(q, k, v, pos, window, bound, split_len, n,
                         f"skv={skv} sq={sq} window={window}")
    # the served path's cut: a 2048-row horizon read only up to the
    # occupancy bound, as ops.flash_decode rounds it (472 -> 512 and
    # 301 -> 384), and one bound left ragged inside a 128-row block
    skv = 2048
    k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    for kv_len, rounded in ((472, True), (301, True), (301, False)):
        bound = min(-(-kv_len // 128) * 128, skv) if rounded else kv_len
        for sq in (1, 4):
            pos = torch.linspace(0, kv_len - sq, B, device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen, device="cuda").bfloat16()
            bound_, split_len, n = D.split_plan(B, HKV, skv, 128, None, bound)
            check(bound_ == bound, f"decode: split_plan bound {bound_}")
            case(q, k, v, pos, None, bound, split_len, n,
                 f"skv={skv} kv_len={kv_len} sq={sq}")
            if rounded:
                # the router's own rounding reaches the same bound
                got = ops.flash_decode(q, k, v, pos, kv_len=kv_len,
                                       impl="cuda").float()
                want = D.ref_decode(q.float(), k.float(), v.float(), pos,
                                    kv_len=bound)
                err = (got - want).abs().max().item()
                check(err <= BF16_OUT_TOL, f"decode: ops.flash_decode err "
                      f"{err:.3g} > {BF16_OUT_TOL} at kv_len={kv_len}")
    one_kernel_event(torch, lambda: ops.flash_decode(
        q, k, v, pos, kv_len=kv_len, impl="cuda"), "decode: ops.flash_decode")
    # the head shapes past yi-9b's: gemma3-4b's Dh = 256 (8 heads over 4
    # KV heads) and qwen3-moe-235b's G = 16 at Sq = 4 (64 packed rows, two
    # row groups), in bf16 and fp32
    for b, h, hkv, dh, sqs in WIDE_DECODE_SHAPES:
        skv = 1000
        for dtype in (torch.bfloat16, torch.float32):
            k = torch.randn(b, skv, hkv, dh, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(b, skv, hkv, dh, generator=gen,
                            device="cuda").to(dtype)
            for sq in sqs:
                pos = torch.linspace(0, skv - sq, b,
                                     device="cuda").round().int()
                q = torch.randn(b, sq, h, dh, generator=gen,
                                device="cuda").to(dtype)
                for window in (None, 256):
                    for ns in (1, None):
                        bound, split_len, n = D.split_plan(b, hkv, skv, 128,
                                                           ns, None)
                        case(q, k, v, pos, window, bound, split_len, n,
                             f"H={h} Hkv={hkv} Dh={dh} {dtype} sq={sq} "
                             f"window={window}")
    print(f"decode kernel: {cases} cases vs plain version, max abs err "
          f"{worst:.3g} (tol {DECODE_TOL}, partials merged in fp32), "
          f"finished output {worst_fin:.3g} (fp32 within {DECODE_TOL}, "
          f"bf16 within one ulp + {DECODE_TOL}; counters 0 after every "
          f"call, repeats bit-identical), incl. occupancy bounds 512, 384 "
          f"and 301 of a 2048-row cache, Dh=256 and G*Sq=64 packed rows in "
          f"bf16 and fp32")
    return worst_fin


# --- phase 4: KV row writer ------------------------------------------------

def phase_stores(torch, S_) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4)
    s = 2048
    for sq in (1, 4):
        # slot 7 overshoots the horizon: its start clamps to s - sq
        pos = torch.tensor([0, 5, 100, 1000, 2047 - sq, s - sq, 2046, 2047 + 3],
                           dtype=torch.int32, device="cuda")
        kn = torch.randn(B, sq, HKV, DH, generator=gen, device="cuda").bfloat16()
        vn = torch.randn(B, sq, HKV, DH, generator=gen, device="cuda").bfloat16()
        for flavor in ("standard", "nt"):
            kc = torch.randn(B, s, HKV, DH, generator=gen, device="cuda").bfloat16()
            vc = torch.randn(B, s, HKV, DH, generator=gen, device="cuda").bfloat16()
            kr, vr = kc.clone(), vc.clone()
            ptrs = (kc.data_ptr(), vc.data_ptr())
            S_.kv_row_update(kc, vc, kn, vn, pos, flavor=flavor, impl="cuda")
            S_.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor, impl="ref")
            torch.cuda.synchronize()
            check((kc.data_ptr(), vc.data_ptr()) == ptrs,
                  "stores: cache storage moved")
            check(torch.equal(kc.view(torch.int16), kr.view(torch.int16))
                  and torch.equal(vc.view(torch.int16), vr.view(torch.int16)),
                  f"stores: {flavor} sq={sq} not byte-identical to plain")
            check(torch.equal(kc[7, s - sq:].view(torch.int16),
                              kn[7].view(torch.int16)),
                  "stores: overshoot row not clamped to the last rows")
    print("kv writer: standard and nt byte-identical to plain version "
          "(sq 1 and 4, clamped overshoot, in place)")


# --- phase 5: full-width serving -------------------------------------------

def phase_engine(torch, np, cfg_mod, M, K, serve):
    cfg = cfg_mod.get_config("yi-9b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"engine: yi-9b {cfg.n_layers} layers d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    lens = rng.integers(128, 513, size=16)
    reqs = [serve.Request(f"r{i}", tuple(int(t) for t in
                                         rng.integers(0, cfg.vocab_size, n)), 64)
            for i, n in enumerate(lens)]
    eng = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048, chunk=8,
                            device="cuda")
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = eng.stats()
    n_tok = sum(len(v) for v in res.values())
    check(sorted(res) == sorted(r.rid for r in reqs)
          and all(len(v) == 64 for v in res.values()),
          "engine: not every request got its 64 tokens")
    check(all(int(v.min()) >= 0 and int(v.max()) < cfg.vocab_size
              for v in res.values()), "engine: token id out of vocab")
    steps = st["decode_tokens"]
    print(f"engine: {len(res)} requests, {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tok/s; prefill {st['prefill_s']:.2f} s "
          f"({st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.2f} s ({st['decode_dispatches']} dispatches, "
          f"{steps} steps, {st['decode_s'] / steps * 1e3:.2f} ms/step)")
    print(f"engine: launches {launches} (expected {cfg.n_layers} x {steps} "
          f"= {cfg.n_layers * steps} each)")
    for name in ("flash_decode", "kv_row_update"):
        check(launches[name] == cfg.n_layers * steps > 0,
              f"engine: {name} launched {launches[name]} times, expected "
              f"{cfg.n_layers * steps}")
    check(st["quarantined"] == 0, "engine: non-finite logits quarantined")

    # one decode step through the kernels against impl="ref", from the
    # served requests' first 8 prompts and from three more prompt sets
    sets = [[r.prompt for r in reqs[:8]]]
    for seed in LOGITS_SEEDS:
        g = np.random.default_rng(seed)
        sets.append([tuple(int(t) for t in g.integers(0, cfg.vocab_size, n))
                     for n in g.integers(128, 513, size=8)])
    readings = [_one_step_logits(torch, cfg, M, params, p) for p in sets]
    print("engine: one decode step, kernels vs impl='ref', max |diff| / "
          "max |logit| (greedy argmax agreement) per prompt set: "
          + ", ".join(f"{rel:.4g} ({agree:.3f})" for rel, agree in readings)
          + f"; tol {LOGITS_REL_TOL}")
    worst = max(rel for rel, _ in readings)
    check(worst <= LOGITS_REL_TOL, f"engine: kernel logits vs impl='ref' "
          f"rel err {worst:.3g} > {LOGITS_REL_TOL}")
    _small_engine_check(torch, np, cfg_mod, M, serve)
    return eng, reqs, launches


def _one_step_logits(torch, cfg, M, params, prompts) -> tuple:
    """Prefill ``prompts`` into 8 slots of a 2048-row cache, then one
    decode step through the kernels and one with ``impl="ref"`` on a copy
    of the cache. Returns (max |diff| / max |logit|, argmax agreement)."""
    from repro_torch.serve.slots import insert
    from repro_torch.train.serve import make_prefill_step
    fresh = M.init_cache(cfg, 8, 2048, "cuda")
    prefill = make_prefill_step(cfg, cache_len=2048)
    toks = []
    for i, p in enumerate(prompts):
        lg, one = prefill(params, {"tokens": torch.tensor(
            [p], dtype=torch.int64, device="cuda")})
        insert(fresh, one, i)
        toks.append(int(lg[0, -1].argmax()))
    del one
    tok = torch.tensor(toks, dtype=torch.int64, device="cuda")[:, None]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    kv_len = int(pos.max()) + 1
    ref_cache = {"scan": {"0": {n: t.clone() for n, t in
                                fresh["scan"]["0"].items()}}, "tail": {}}
    lk, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                         cache=fresh, pos=pos, impl="auto", kv_len=kv_len)
    lr, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                         cache=ref_cache, pos=pos, impl="ref", kv_len=kv_len)
    lk, lr = lk.float(), lr.float()
    check(bool(torch.isfinite(lk).all()), "engine: non-finite logits")
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    agree = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
    return rel, agree


def _small_engine_check(torch, np, cfg_mod, M, serve) -> None:
    """Smoke-size fp32 engine: greedy streams on the card == on the CPU."""
    cfg = dataclasses.replace(cfg_mod.get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [serve.Request(str(i), tuple(int(t) for t in
                                        rng.integers(0, cfg.vocab_size, n)), m)
            for i, (n, m) in enumerate([(9, 12), (17, 5), (4, 1), (12, 9),
                                        (30, 7)])]
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        eng = serve.ServeEngine(cfg, p, max_slots=2, max_len=40, chunk=3,
                                device=dev)
        out[dev] = eng.run(reqs)
    check(all(out["cpu"][r.rid].tolist() == out["cuda"][r.rid].tolist()
              for r in reqs), "engine: smoke fp32 streams differ card vs CPU")
    print("engine: smoke-size fp32 greedy streams identical on the card and "
          "the CPU (5 requests, 2 slots, chunk 3)")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# --- phase 6: kernel timings -----------------------------------------------

def phase_timings(torch, np, D, ops, S_, eng, reqs, launches,
                  decode_err) -> list:
    F = torch.nn.functional
    cache = eng.cache["scan"]["0"]
    n_layers, skv = cache["k"].shape[0], cache["k"].shape[2]
    # mid-decode positions of the first 8 requests: prompt + 32 tokens
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:B]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    # the split plan ops.flash_decode makes of kv_len (rounded up to 128)
    bound, split_len, n_splits = D.split_plan(
        B, HKV, skv, 128, None, min(-(-kv_len // 128) * 128, skv))
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(B, 1, H, DH, generator=gen, device="cuda").bfloat16()
    kw = dict(window=None, split_len=split_len, n_splits=n_splits,
              bound=bound)
    # cycle over the 48 layers' caches so every call reads cold KV rows,
    # as the decode step does
    layer = [0]

    def next_kv():
        i = layer[0] = (layer[0] + 1) % n_layers
        return cache["k"][i], cache["v"][i]

    def kern():
        # the router's finished output, as the decode step calls it: one
        # launch, the splits merged inside the kernel
        k, v = next_kv()
        ops.flash_decode(q, k, v, pos, kv_len=kv_len, impl="cuda")

    def partials():
        k, v = next_kv()
        D.decode_partials(q, k, v, pos, impl="cuda", **kw)

    def plain():
        k, v = next_kv()
        D.decode_finished(q, k, v, pos, impl="ref", **kw)

    mask = (torch.arange(bound, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]          # (B, 1, 1, bound)
    qt = q.transpose(1, 2)

    def library():
        k, v = next_kv()
        F.scaled_dot_product_attention(
            qt, k[:, :bound].transpose(1, 2), v[:, :bound].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    ms = timed(torch, kern, 480)
    part_ms = timed(torch, partials, 480)
    plain_ms = timed(torch, plain, 48)
    lib_ms = timed(torch, library, 480)
    live = (pos + 1).clamp(max=bound).sum().item()       # KV rows read
    bound_ms, bound_by, n_bytes = decode_bound(B, H, HKV, DH, live, 2)
    decode_row = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/attention/decode.py:179",
        "launches": launches["flash_decode"], "max_abs_err": decode_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}
    print(f"timing: flash_decode (ops.flash_decode, finished output, one "
          f"launch) at B={B} Sq=1 kv_len={kv_len} n_splits={n_splits} "
          f"({live} live rows): {ms * 1e3:.2f} us = "
          f"{n_bytes / ms / 1e6:.0f} GB/s ({bound_ms / ms:.3f} of the "
          f"{bound_by} bound {bound_ms * 1e3:.2f} us), plain (partials + "
          f"combine_splits + cast) {plain_ms * 1e3:.1f} us, sdpa "
          f"{lib_ms * 1e3:.2f} us; the partials alone (no merge) "
          f"{part_ms * 1e3:.2f} us (device time by profiler)")

    # KV writer: one layer's K and V rows per launch, at a decode position
    kn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    flat = [c.view(n_layers, -1, HKV, DH) for c in (cache["k"], cache["v"])]
    rows = (torch.arange(B, device="cuda") * cache["k"].shape[2]
            + pos).long()

    def wkern():
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="cuda")

    def wplain():
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="ref")

    def wlib():
        i = layer[0] = (layer[0] + 1) % n_layers
        flat[0][i].index_copy_(0, rows, kn[:, 0])
        flat[1][i].index_copy_(0, rows, vn[:, 0])

    wms = timed(torch, wkern, 960)
    wplain_ms = timed(torch, wplain, 96)
    wlib_ms = timed(torch, wlib, 960)
    w_bytes = 2 * 2 * B * HKV * DH * 2 + B * 4
    writer_row = {
        "name": "kv_row_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stores.cu",
        "replaces": "src/repro/kernels/stores.py:235",
        "launches": launches["kv_row_update"], "max_abs_err": 0.0,
        "ms": wms, "plain_ms": wplain_ms,
        "bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": wlib_ms}
    print(f"timing: kv_row_update at B={B} Sq=1: {wms * 1e3:.2f} us, bound "
          f"{writer_row['bound_ms'] * 1e3:.4f} us, plain "
          f"{wplain_ms * 1e3:.1f} us, index_copy_ x2 {wlib_ms * 1e3:.2f} us "
          f"(device time by profiler)")
    return [decode_row, writer_row]


# --- phase 3a: paged decode kernel ----------------------------------------

def _paged_pools(torch, k, v, ps, gen):
    """The slot caches k, v (B, S, Hkv, Dh) as page pools under a randomly
    permuted block table, plus a scratch page of NaN at the end (the page
    dead table columns name; never read)."""
    b, skv, hkv, dh = k.shape
    nb = -(-skv // ps)
    perm = torch.randperm(b * nb, generator=gen, device="cuda")
    pad = (0, 0, 0, 0, 0, nb * ps - skv)
    pools = []
    for x in (k, v):
        pool = torch.full((b * nb + 1, ps, hkv, dh), float("nan"),
                          dtype=x.dtype, device="cuda")
        pool[perm] = torch.nn.functional.pad(x, pad).reshape(b * nb, ps, hkv,
                                                             dh)
        pools.append(pool)
    return pools[0], pools[1], perm.reshape(b, nb).int()


def phase_paged_decode(torch, D, ops) -> float:
    gen = torch.Generator(device="cuda").manual_seed(8)
    skv = 2048
    k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    worst, worst_dense, worst_fin, cases = 0.0, 0.0, 0.0, 0
    for ps in (8, 16, 256):
        kp, vp, table = _paged_pools(torch, k, v, ps, gen)
        for sq in (1, 4):
            pos = torch.linspace(0, skv - 600 - sq, B,
                                 device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen,
                            device="cuda").bfloat16()
            # dead columns past each slot's last live row name the scratch
            bt = table.clone()
            for i, last in enumerate((pos + sq - 1).tolist()):
                bt[i, last // ps + 1:] = kp.shape[0] - 1
            full = bt.shape[1]
            cut = -(-(int(pos.max()) + sq) // ps)         # a kv_len bound
            for window in (None, 256):
                for ns, n_blocks in ((1, full), (None, full), (None, cut)):
                    bound, split_len, n = D.paged_split_plan(
                        B, HKV, ps, n_blocks, ns)
                    kw = dict(window=window, split_len=split_len,
                              n_splits=n, bound=bound)
                    ok_, mk, lk = D.decode_paged_partials(
                        q, kp, vp, bt, pos, impl="cuda", **kw)
                    orf, mr, lr = D.decode_paged_partials(
                        q, kp, vp, bt, pos, impl="ref", **kw)
                    torch.cuda.synchronize()
                    got = D.combine_splits(ok_, mk, lk)
                    ref = D.combine_splits(orf, mr, lr)
                    err = (got - ref).abs().max()
                    what = (f"page={ps} sq={sq} window={window} "
                            f"n_splits={n} bound={bound}")
                    check(torch.equal(lk == 0, lr == 0),
                          f"paged decode: dead splits differ ({what})")
                    check(err.item() <= DECODE_TOL, f"paged decode: max err "
                          f"{err.item():.3g} > {DECODE_TOL} at {what}")
                    worst_fin = max(worst_fin, check_finished(
                        torch, D, lambda: D.decode_paged_finished(
                            q, kp, vp, bt, pos, impl="cuda", **kw), ref,
                        f"paged decode {what}"))
                    worst = max(worst, err.item())
                    cases += 1
                # the same logical cache through the dense kernel
                b_, sl, nd = D.split_plan(B, HKV, skv, 128, None, None)
                dense = D.combine_splits(*D.decode_partials(
                    q, k, v, pos, window=window, split_len=sl, n_splits=nd,
                    bound=b_, impl="cuda"))
                paged = D.combine_splits(*D.decode_paged_partials(
                    q, kp, vp, bt, pos, impl="cuda", window=window,
                    **dict(zip(("bound", "split_len", "n_splits"),
                               D.paged_split_plan(B, HKV, ps, full,
                                                  None)))))
                err = (paged - dense).abs().max().item()
                check(err <= DECODE_TOL, f"paged decode vs dense kernel: "
                      f"{err:.3g} > {DECODE_TOL} at page={ps} sq={sq}")
                worst_dense = max(worst_dense, err)
        # the router's page bound reaches the same result
        got = ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=cut * ps - 3,
                                     impl="cuda").float()
        want = D.ref_decode(q.float(), k.float(), v.float(), pos)
        err = (got - want).abs().max().item()
        check(err <= BF16_OUT_TOL, f"paged decode: ops.flash_decode_paged "
              f"err {err:.3g} > {BF16_OUT_TOL} at page={ps}")
    one_kernel_event(torch, lambda: ops.flash_decode_paged(
        q, kp, vp, bt, pos, kv_len=cut * ps - 3, impl="cuda"),
        "paged decode: ops.flash_decode_paged")
    # Dh = 256 and 64 packed rows, pages of 16, in bf16 and fp32
    for b, h, hkv, dh, sqs in WIDE_DECODE_SHAPES:
        skv, ps = 1000, 16
        for dtype in (torch.bfloat16, torch.float32):
            kd = torch.randn(b, skv, hkv, dh, generator=gen,
                             device="cuda").to(dtype)
            vd = torch.randn(b, skv, hkv, dh, generator=gen,
                             device="cuda").to(dtype)
            kp, vp, table = _paged_pools(torch, kd, vd, ps, gen)
            for sq in sqs:
                pos = torch.linspace(0, skv - sq, b,
                                     device="cuda").round().int()
                q = torch.randn(b, sq, h, dh, generator=gen,
                                device="cuda").to(dtype)
                for window in (None, 256):
                    bound, split_len, n = D.paged_split_plan(
                        b, hkv, ps, table.shape[1], None)
                    kw = dict(window=window, split_len=split_len,
                              n_splits=n, bound=bound)
                    got = D.combine_splits(*D.decode_paged_partials(
                        q, kp, vp, table, pos, impl="cuda", **kw))
                    want = D.combine_splits(*D.decode_paged_partials(
                        q, kp, vp, table, pos, impl="ref", **kw))
                    err = (got - want).abs().max().item()
                    what = (f"H={h} Hkv={hkv} Dh={dh} {dtype} sq={sq} "
                            f"window={window}")
                    check(err <= DECODE_TOL, f"paged decode: max err "
                          f"{err:.3g} > {DECODE_TOL} at {what}")
                    worst_fin = max(worst_fin, check_finished(
                        torch, D, lambda: D.decode_paged_finished(
                            q, kp, vp, table, pos, impl="cuda", **kw), want,
                        f"paged decode {what}"))
                    worst = max(worst, err)
                    cases += 1
    print(f"paged decode kernel: {cases} cases vs plain version (pages 8, "
          f"16, 256; permuted tables, dead columns on a NaN scratch page; "
          f"Sq 1/4; window none/256; one/default splits; a kv_len cut; "
          f"Dh=256 and G*Sq=64 in bf16 and fp32), max "
          f"abs err {worst:.3g}; vs the dense kernel on the same logical "
          f"cache {worst_dense:.3g} (tol {DECODE_TOL}, partials merged in "
          f"fp32); finished output {worst_fin:.3g} (fp32 within "
          f"{DECODE_TOL}, bf16 within one ulp + {DECODE_TOL}; counters 0 "
          f"after every call, repeats bit-identical)")
    return worst_fin


# --- phase 3b: flash attention kernel --------------------------------------

def phase_flash(torch, ops, R) -> float:
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for s in (512, 2048, 509):
        q = torch.randn(1, H, s, DH, generator=gen, device="cuda")
        k = torch.randn(1, HKV, s, DH, generator=gen, device="cuda")
        v = torch.randn(1, HKV, s, DH, generator=gen, device="cuda")
        for window in (None, 256):
            want = R.attention(q, k, v, window=window)
            got = ops.flash_attention(q, k, v, window=window, impl="cuda")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= FLASH_F32_TOL, f"flash: fp32 err {err:.3g} > "
                  f"{FLASH_F32_TOL} at S={s} window={window}")
            worst = max(worst, err)
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            want = R.attention(qb.float(), kb.float(), vb.float(),
                               window=window)
            got = ops.flash_attention(qb, kb, vb, window=window,
                                      impl="cuda").float()
            err = (got - want).abs().max().item()
            check(err <= BF16_OUT_TOL, f"flash: bf16 err {err:.3g} > "
                  f"{BF16_OUT_TOL} at S={s} window={window}")
    # gemma3-4b's heads: 8 over 4 KV heads, Dh = 256
    for s in (509, 2048):
        q = torch.randn(1, 8, s, 256, generator=gen, device="cuda")
        k = torch.randn(1, 4, s, 256, generator=gen, device="cuda")
        v = torch.randn(1, 4, s, 256, generator=gen, device="cuda")
        for window in (None, 256):
            want = R.attention(q, k, v, window=window)
            got = ops.flash_attention(q, k, v, window=window, impl="cuda")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= FLASH_F32_TOL, f"flash: fp32 err {err:.3g} > "
                  f"{FLASH_F32_TOL} at Dh=256 S={s} window={window}")
            worst = max(worst, err)
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            want = R.attention(qb.float(), kb.float(), vb.float(),
                               window=window)
            got = ops.flash_attention(qb, kb, vb, window=window,
                                      impl="cuda").float()
            err = (got - want).abs().max().item()
            check(err <= BF16_OUT_TOL, f"flash: bf16 err {err:.3g} > "
                  f"{BF16_OUT_TOL} at Dh=256 S={s} window={window}")
    print(f"flash attention kernel: S 512/2048/509, causal and window 256, "
          f"B=1 H={H} Hkv={HKV} Dh={DH}, and S 509/2048 at H=8 Hkv=4 "
          f"Dh=256: fp32 max abs err {worst:.3g} (tol "
          f"{FLASH_F32_TOL}); bf16 within {BF16_OUT_TOL} of the fp32 plain "
          f"result")
    return worst


# --- phase 5b: prefill attention through the flash entry point -------------

def phase_prefill_attention(torch, np, cfg, M, L, K, ops, R, params) -> dict:
    """Layer 0's queries, keys and values of a 2048-token prompt on the
    full-width model, in the model's (B, S, H, Dh) layout, through
    ``ops.flash_attention_bshd``: the kernel's own entry point (the
    model's prefill keeps ``chunked_causal_attention``, as the
    reference's does). Launch counts are zeroed before and read after."""
    s = 2048
    toks = torch.tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (1, s)), device="cuda")
    p = {n: t[0] for n, t in params["scan"]["0"].items()
         if not isinstance(t, dict)}
    mix = {n: t[0] for n, t in params["scan"]["0"]["mixer"].items()}
    x = L.rms_norm(params["tok_embed"][toks], p["ln1"], cfg.norm_eps)
    rope = L.rope_tables(torch.arange(s, device="cuda")[None],
                         cfg.head_dim_eff, cfg.rope_theta)
    q = L.rotate(M._project(x, mix["wq"]), *rope)
    k = L.rotate(M._project(x, mix["wk"]), *rope)
    v = M._project(x, mix["wv"])
    K.reset_launches()
    out = ops.flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches["flash_attention"] == 1, f"prefill attention: "
          f"flash_attention launched {launches['flash_attention']} times")
    check(tuple(out.shape) == tuple(q.shape) and out.dtype == q.dtype
          and bool(torch.isfinite(out).all()),
          "prefill attention: bad output")
    want = R.attention(*(t.transpose(1, 2).float() for t in (q, k, v)))
    err = (out.transpose(1, 2).float() - want).abs().max().item()
    check(err <= BF16_OUT_TOL, f"prefill attention: err {err:.3g} > "
          f"{BF16_OUT_TOL}")
    print(f"prefill attention: yi-9b layer 0, S={s}, through "
          f"ops.flash_attention_bshd: launches {launches['flash_attention']}"
          f", max abs err {err:.3g} vs fp32 plain (tol {BF16_OUT_TOL})")
    return launches


# --- phase 5c: full-width paged serving -------------------------------------

def serve_schedule(eng, reqs, *, fork: bool, cancel_after: int,
                   on_round=None) -> dict:
    """Serve ``reqs``: all but one slot admitted, one chunk, then (paged
    engines, ``fork``) the first request forked into the free slot;
    admissions as slots free; ``reqs[1]`` cancelled after
    ``cancel_after`` more dispatches. Returns {rid: token list}, the
    cancelled stream included. ``on_round(eng)`` runs after every
    admission round and dispatch."""
    pending = list(reqs)
    out = {}
    for _ in range(eng.max_slots - 1):
        eng.admit(pending.pop(0))
    if on_round:
        on_round(eng)
    out.update((r, t.tolist()) for r, t in eng.step())
    if fork:
        eng.fork(reqs[0].rid, f"{reqs[0].rid}-fork")
    rounds = 0
    while pending or any(s is not None for s in eng.slots):
        for slot in eng.free_slots():
            if pending:
                eng.admit(pending.pop(0), slot)
        if on_round:
            on_round(eng)
        out.update((r, t.tolist()) for r, t in eng.step())
        if on_round:
            on_round(eng)
        rounds += 1
        if rounds == cancel_after:
            got = eng.cancel(reqs[1].rid)
            check(got is not None, "serve: the request to cancel retired")
            out[reqs[1].rid] = got.tolist()
    return out


def paged_requests(np, serve, vocab: int, n: int, seed: int, system: int,
                   suffix: int, new: int) -> list:
    """``n`` requests sharing a ``system``-token prefix, each with its own
    0..``suffix``-token tail and ``new`` tokens to generate."""
    rng = np.random.default_rng(seed)
    prefix = tuple(int(t) for t in rng.integers(0, vocab, system))
    return [serve.Request(f"p{i}", prefix + tuple(
        int(t) for t in rng.integers(0, vocab, m)), new)
        for i, m in enumerate(rng.integers(0, suffix + 1, n))]


def phase_paged_engine(torch, np, cfg_mod, M, K, serve, PG, params,
                       dense_st):
    cfg = cfg_mod.get_config("yi-9b")
    n_pages, ps = 320, 16
    reqs = paged_requests(np, serve, cfg.vocab_size, 16, 5, 256, 256, 64)
    eng = serve.PagedServeEngine(cfg, params, page_size=ps, n_pages=n_pages,
                                 max_slots=8, max_len=2048, chunk=8,
                                 device="cuda")
    peak = [0]

    def held(e):
        peak[0] = max(peak[0], sum(1 for rc in e.pool.refcount if rc))
        e.check_pool()

    K.reset_launches()
    t0 = time.perf_counter()
    res = serve_schedule(eng, reqs, fork=True, cancel_after=4,
                         on_round=held)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st, pool = eng.stats(), dict(eng.pool.stats)
    steps = st["decode_tokens"]
    eng.check_pool()
    done = [r for r in res if r != reqs[1].rid]
    check(len(res) == 17 and all(len(res[r]) == 64 for r in done)
          and len(res[reqs[1].rid]) < 64,
          "paged engine: not every request got its tokens")
    check(all(0 <= min(t) and max(t) < cfg.vocab_size for t in res.values()),
          "paged engine: token id out of vocab")
    check(res[reqs[0].rid] == res[f"{reqs[0].rid}-fork"],
          "paged engine: the greedy fork diverged from its parent")
    check(launches["flash_decode_paged"] == cfg.n_layers * steps > 0
          and launches["flash_decode"] == 0
          and launches["kv_row_update"] == 0,
          f"paged engine: launches {launches}, expected flash_decode_paged "
          f"{cfg.n_layers} x {steps} and no dense kernel")
    check(pool["shared_maps"] > 0 and pool["cow_copies"] >= 1
          and pool["recycled_allocs"] > 0,
          f"paged engine: pool stats {pool}")
    check(st["quarantined"] == 0, "paged engine: non-finite logits")
    n_tok = sum(len(v) for v in res.values())
    page_bytes = PG.paged_kv_bytes(cfg, 1, ps)
    print(f"paged engine: yi-9b, page {ps}, {n_pages} + 1 pages "
          f"({PG.paged_kv_bytes(cfg, n_pages + 1, ps) / 2**20:.1f} MiB pool "
          f"vs {PG.dense_kv_bytes(cfg, 8, 2048) / 2**20:.1f} MiB dense 8 x "
          f"2048 cache); 16 requests of a shared 256-token prefix + 0-256 "
          f"tokens, 64 new each, one forked after its first chunk, one "
          f"cancelled")
    print(f"paged engine: peak pages held {peak[0]} = "
          f"{peak[0] * page_bytes / 2**20:.1f} MiB (dense_kv_bytes "
          f"{PG.dense_kv_bytes(cfg, 8, 2048) / 2**20:.1f} MiB); pool stats "
          f"{pool}; gather_pages {eng.gather_pages}")
    print(f"paged engine: {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tok/s; prefill {st['prefill_s']:.2f} s "
          f"({st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.2f} s ({st['decode_dispatches']} dispatches, "
          f"{steps} steps, {st['decode_s'] / steps * 1e3:.2f} ms/step) vs "
          f"dense {dense_st['decode_s'] / dense_st['decode_tokens'] * 1e3:.2f}"
          f" ms/step")
    print(f"paged engine: launches {launches} (expected flash_decode_paged "
          f"{cfg.n_layers} x {steps} = {cfg.n_layers * steps})")
    rel, agree = _paged_vs_dense_logits(torch, cfg, M, PG, params,
                                        [r.prompt for r in reqs[:8]])
    print(f"paged engine: one decode step, paged kernel vs dense kernel on "
          f"the same prompts, max |diff| / max |logit| {rel:.4g} (greedy "
          f"argmax agreement {agree:.3f}); tol {LOGITS_REL_TOL}")
    check(rel <= LOGITS_REL_TOL, f"paged engine: paged vs dense logits "
          f"{rel:.3g} > {LOGITS_REL_TOL}")
    _small_paged_check(torch, np, cfg_mod, M, serve)
    return eng, launches


def _paged_vs_dense_logits(torch, cfg, M, PG, params, prompts) -> tuple:
    """The prompts prefilled into a dense 8 x 2048 cache and into page
    pools under a shuffled table, then one decode step through each
    layout's kernels. Returns (max |diff| / max |logit|, argmax
    agreement)."""
    from repro_torch.serve.slots import insert
    from repro_torch.train.serve import make_prefill_step
    ps = 16
    nb = 2048 // ps
    dense = M.init_cache(cfg, 8, 2048, "cuda")
    pools = PG.init_paged_cache(cfg, 8 * nb + 1, ps, "cuda")
    perm = torch.randperm(8 * nb, generator=torch.Generator().manual_seed(12))
    bt = perm.reshape(8, nb).int().cuda()
    pre_dense = make_prefill_step(cfg, cache_len=2048)
    pre_exact = make_prefill_step(cfg, cache_len=None)
    toks = []
    for i, p in enumerate(prompts):
        t = torch.tensor([p], dtype=torch.int64, device="cuda")
        lg, one = pre_dense(params, {"tokens": t})
        insert(dense, one, i)
        _, one = pre_exact(params, {"tokens": t})
        npg = -(-len(p) // ps)
        PG.paged_insert(pools, one, bt[i, :npg].long(),
                        torch.arange(npg, device="cuda"))
        toks.append(int(lg[0, -1].argmax()))
    del one
    tok = torch.tensor(toks, dtype=torch.int64, device="cuda")[:, None]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    kv_len = int(pos.max()) + 1
    ld, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                         cache=dense, pos=pos, kv_len=kv_len)
    lp, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                         cache=pools, pos=pos, kv_len=kv_len,
                         block_tables=bt)
    ld, lp = ld.float(), lp.float()
    check(bool(torch.isfinite(lp).all()), "paged engine: non-finite logits")
    rel = ((lp - ld).abs().max() / ld.abs().max()).item()
    agree = (lp.argmax(-1) == ld.argmax(-1)).float().mean().item()
    return rel, agree


def _small_paged_check(torch, np, cfg_mod, M, serve) -> None:
    """Smoke-size fp32 paged engine on the card: greedy streams equal to
    the paged engine on the CPU (fork and cancel on the way) and to the
    dense engine on the card (the same schedule without the fork)."""
    cfg = dataclasses.replace(cfg_mod.get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    reqs = paged_requests(np, serve, cfg.vocab_size, 6, 7, 8, 12, 12)
    kw = dict(max_slots=3, max_len=40, chunk=3)

    def paged(dev, fork):
        eng = serve.PagedServeEngine(cfg, _to(params, dev), page_size=4,
                                     device=dev, **kw)
        out = serve_schedule(eng, reqs, fork=fork, cancel_after=2)
        eng.check_pool()
        check(eng.pool.stats["shared_maps"] > 0,
              "paged engine: smoke run shared no prefix")
        return out

    card = paged("cuda", True)
    check(card == paged("cpu", True),
          "paged engine: smoke fp32 streams differ card vs CPU")
    dense = serve_schedule(serve.ServeEngine(cfg, _to(params, "cuda"),
                                             device="cuda", **kw),
                           reqs, fork=False, cancel_after=2)
    check(paged("cuda", False) == dense,
          "paged engine: smoke fp32 paged streams differ from dense")
    print("paged engine: smoke-size fp32 greedy streams identical on the "
          "card and the CPU (6 requests sharing a prefix, 3 slots, chunk 3, "
          "a fork and a cancel) and paged == dense on the card")


def phase_new_timings(torch, D, ops, R, peng, reqs, paged_launches, paged_err,
                      flash_launches, flash_err) -> list:
    """The paged decode kernel at page 16 and the dense timing's live rows,
    and the flash-attention kernel at yi-9b prefill shapes."""
    F = torch.nn.functional
    pool = peng.cache["scan"]["0"]
    n_layers, n_pages, ps = pool["k"].shape[:3]
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:B]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    n_blocks = -(-kv_len // ps)
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(13))
    bt = perm[:B * n_blocks].reshape(B, n_blocks).int().cuda()
    bound, split_len, n_splits = D.paged_split_plan(B, HKV, ps, n_blocks,
                                                    None)
    gen = torch.Generator(device="cuda").manual_seed(14)
    q = torch.randn(B, 1, H, DH, generator=gen, device="cuda").bfloat16()
    kw = dict(window=None, split_len=split_len, n_splits=n_splits,
              bound=bound)
    layer = [0]

    def next_pool():
        i = layer[0] = (layer[0] + 1) % n_layers
        return pool["k"][i], pool["v"][i]

    def kern():
        # the router's finished output: one launch
        kp, vp = next_pool()
        ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=kv_len,
                               impl="cuda")

    def partials():
        kp, vp = next_pool()
        D.decode_paged_partials(q, kp, vp, bt, pos, impl="cuda", **kw)

    def plain():
        kp, vp = next_pool()
        D.decode_paged_finished(q, kp, vp, bt, pos, impl="ref", **kw)

    ms = timed(torch, kern, 480)
    part_ms = timed(torch, partials, 480)
    plain_ms = timed(torch, plain, 48)
    # the same rows cut into 128-row splits: B*Hkv*4 = 128 blocks, one an
    # SM, where the default 5 splits put two blocks on 28 of the 132 SMs
    b4, sl4, n4 = D.paged_split_plan(B, HKV, ps, n_blocks, 4)
    ms4 = timed(torch, lambda: D.decode_paged_finished(
        q, *next_pool(), bt, pos, window=None, split_len=sl4, n_splits=n4,
        bound=b4, impl="cuda"), 480)
    live_b = (pos + 1).clamp(max=bound)
    live = live_b.sum().item()
    n_table = ((live_b + ps - 1) // ps).sum().item()       # entries read
    bound_ms, bound_by, n_bytes = decode_bound(B, H, HKV, DH, live, 2,
                                               n_table)
    paged_row = {
        "name": "flash_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/attention/decode.py:267",
        "launches": paged_launches["flash_decode_paged"],
        "max_abs_err": paged_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    print(f"timing: flash_decode_paged (ops.flash_decode_paged, finished "
          f"output, one launch) at B={B} Sq=1 page={ps} kv_len={kv_len} "
          f"({n_blocks} table columns, permuted) n_splits={n_splits} "
          f"({live} live rows, {n_table} table entries): {ms * 1e3:.2f} us "
          f"= {n_bytes / ms / 1e6:.0f} GB/s ({bound_ms / ms:.3f} of the "
          f"{bound_by} bound {bound_ms * 1e3:.2f} us), plain (partials + "
          f"combine_splits + cast) {plain_ms * 1e3:.1f} us; no single "
          f"PyTorch call reads a paged cache, so no library time; the "
          f"partials alone {part_ms * 1e3:.2f} us; at {n4} splits of {sl4} "
          f"rows ({B * HKV * n4} blocks) {ms4 * 1e3:.2f} us (device time by "
          f"profiler)")

    rows = []
    for s in (512, 2048):
        q = torch.randn(1, H, s, DH, generator=gen, device="cuda").bfloat16()
        k = torch.randn(1, HKV, s, DH, generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn(1, HKV, s, DH, generator=gen,
                        device="cuda").bfloat16()
        n_bytes = (2 * H + 2 * HKV) * s * DH * 2
        flops = 4 * (s * (s + 1) // 2) * H * DH
        tb = n_bytes / HBM_BYTES_PER_S * 1e3
        to = flops / BF16_FLOPS * 1e3
        # the operations are a floor; the bytes (a few MB, in L2) are not
        floor = ("flash_attention", to * 1e3, "operations")
        fk = timed(torch, lambda: ops.flash_attention(q, k, v, impl="cuda"),
                   20, bound=floor)
        fp = timed(torch, lambda: R.attention(q, k, v), 5, bound=floor)
        fl = timed(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 50, bound=floor)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash.cu",
            "replaces": "src/repro/kernels/attention/flash.py:115",
            "launches": flash_launches["flash_attention"],
            "max_abs_err": flash_err, "ms": fk, "plain_ms": fp,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": fl})
        print(f"timing: flash_attention at B=1 S={s} H={H} Hkv={HKV} "
              f"Dh={DH} bf16 causal: {fk * 1e3:.1f} us = "
              f"{flops / fk / 1e9:.1f} TFLOP/s ({to / fk:.3f} of "
              f"{BF16_FLOPS / 1e12:.0f}), bound "
              f"{max(tb, to) * 1e3:.2f} us ({'bytes' if tb >= to else 'ops'}"
              f"; {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
              f"{BF16_FLOPS / 1e12:.0f} TFLOP/s), plain {fp * 1e3:.1f} us, "
              f"sdpa {fl * 1e3:.2f} us (device time by profiler)")
    return [paged_row, rows[-1]]


def phase_wide_timings(torch, D, ops, R, reqs) -> None:
    """The three attention kernels at gemma3-4b's head shapes (H=8, Hkv=4,
    Dh=256, bf16), beside their bounds and sdpa: decode, dense and paged
    (page 16), at B=8 over the dense timing's live rows, the caches of 16
    layers cycled so every call reads cold rows; flash attention at B=1,
    S=2048, causal. Printed only: the ``kernels`` line keeps the served
    shapes."""
    from repro_torch.kernels.attention import flash as FL
    F = torch.nn.functional
    b, h, hkv, dh, n_layers, skv, ps = 8, 8, 4, 256, 16, 2048, 16
    gen = torch.Generator(device="cuda").manual_seed(15)
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:b]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    kc = torch.randn(n_layers, b, skv, hkv, dh, generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn_like(kc)
    q = torch.randn(b, 1, h, dh, generator=gen, device="cuda").bfloat16()
    bound, split_len, n_splits = D.split_plan(b, hkv, skv, 128, None, kv_len)
    # the same rows as page pools under a shuffled table
    kp = kc.view(n_layers, b * skv // ps, ps, hkv, dh)
    vp = vc.view(n_layers, b * skv // ps, ps, hkv, dh)
    nb = -(-kv_len // ps)
    bt = torch.randperm(kp.shape[1], generator=torch.Generator().manual_seed(
        16))[:b * nb].reshape(b, nb).int().cuda()
    pbound, psl, pns = D.paged_split_plan(b, hkv, ps, nb, None)
    layer = [0]

    def nxt():
        layer[0] = (layer[0] + 1) % n_layers
        return layer[0]

    mask = (torch.arange(bound, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    dkw = dict(window=None, split_len=split_len, n_splits=n_splits,
               bound=bound)
    pkw = dict(window=None, split_len=psl, n_splits=pns, bound=pbound)
    # finished output (one launch), then the partials alone
    dense_ms = [timed(torch, lambda f=f: f(
        q, kc[nxt()], vc[layer[0]], pos, impl="cuda", **dkw), 480)
        for f in (D.decode_finished, D.decode_partials)]
    paged_ms = [timed(torch, lambda f=f: f(
        q, kp[nxt()], vp[layer[0]], bt, pos, impl="cuda", **pkw), 480)
        for f in (D.decode_paged_finished, D.decode_paged_partials)]
    sdpa_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        qt, kc[nxt()][:, :bound].transpose(1, 2),
        vc[layer[0]][:, :bound].transpose(1, 2), attn_mask=mask,
        enable_gqa=True), 480)
    live = (pos + 1).clamp(max=bound).sum().item()
    for name, (ms, part_ms), ns, entries in (
            ("flash_decode", dense_ms, n_splits, 0),
            ("flash_decode_paged", paged_ms, pns,
             ((pos + 1 + ps - 1) // ps).sum().item())):
        bound_ms, bound_by, n_bytes = decode_bound(b, h, hkv, dh, live, 2,
                                                   entries)
        print(f"timing: {name} at gemma3-4b heads (B={b} H={h} Hkv={hkv} "
              f"Dh={dh} bf16, {live} live rows, n_splits={ns}), finished "
              f"output: {ms * 1e3:.2f} us = {n_bytes / ms / 1e6:.0f} GB/s, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}), sdpa "
              f"{sdpa_ms * 1e3:.2f} us; the partials alone "
              f"{part_ms * 1e3:.2f} us (device time by profiler)")
    del kc, vc, kp, vp
    s = 2048
    fq = torch.randn(1, h, s, dh, generator=gen, device="cuda").bfloat16()
    fk = torch.randn(1, hkv, s, dh, generator=gen, device="cuda").bfloat16()
    fv = torch.randn(1, hkv, s, dh, generator=gen, device="cuda").bfloat16()
    n_bytes = (2 * h + 2 * hkv) * s * dh * 2
    flops = 4 * (s * (s + 1) // 2) * h * dh
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = flops / BF16_FLOPS * 1e3
    floor = ("flash_attention", to * 1e3, "operations")
    fk_ms = timed(torch, lambda: ops.flash_attention(fq, fk, fv, impl="cuda"),
                  20, bound=floor)
    fp_ms = timed(torch, lambda: R.attention(fq, fk, fv), 5, bound=floor)
    fl_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        fq, fk, fv, is_causal=True, enable_gqa=True), 50, bound=floor)
    tiles = {bk: timed(torch, lambda bk=bk: ops.flash_attention(
        fq, fk, fv, bk=bk, impl="cuda"), 20, bound=floor)
        for bk in FL.KERNEL_KEY_TILES}
    print(f"timing: flash_attention at gemma3-4b heads (B=1 S={s} H={h} "
          f"Hkv={hkv} Dh={dh} bf16 causal), default "
          f"{FL.default_bk(torch.bfloat16, dh)}-key tiles: "
          f"{fk_ms * 1e3:.1f} us = "
          f"{flops / fk_ms / 1e9:.1f} TFLOP/s ({to / fk_ms:.3f} of "
          f"{BF16_FLOPS / 1e12:.0f}), bound {max(tb, to) * 1e3:.2f} us "
          f"({'bytes' if tb >= to else 'operations'}), plain "
          f"{fp_ms * 1e3:.1f} us, sdpa {fl_ms * 1e3:.2f} us; by key tile "
          + ", ".join(f"{bk} keys {ms * 1e3:.1f} us" for bk, ms in
                      tiles.items()) + " (device time by profiler)")


def phase_trace(torch, serve, eng, reqs, label: str) -> None:
    """Where a full-width decode step's device time goes, and the
    device's idle share over the same steps.

    The same 8 requests are served twice from an idle engine: once to
    take the wall time of two chunked dispatches, once under the
    profiler to take the device's busy time in the same two dispatches.
    Greedy decoding repeats the same tokens, positions and occupancy
    bounds, so both passes do the same work. Prints the kernel launches
    a step beside the copies and fills, as the profiler counts them.
    """
    check(not any(eng.slots), f"{label}: engine not idle")

    def admit_and_warm(tag):
        # 1 token from the prefill and 3 chunks: the warm dispatch, then
        # the two that are measured, after which the requests retire
        for r in reqs[:8]:
            eng.admit(serve.Request(f"{tag}-{r.rid}", r.prompt,
                                    1 + 3 * eng.chunk))
        eng.step()
        torch.cuda.synchronize()

    steps = 2 * eng.chunk
    admit_and_warm("wall")
    t0 = time.perf_counter()
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    check(not any(eng.slots), f"{label}: requests did not retire")
    passes = []

    def run():
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) / steps * 1e3)

    # a window taken again serves the requests once more, from idle
    counts = {}
    by_name = profiled(torch, run, label, setup=lambda: admit_and_warm(
        f"trace{len(passes)}"), counts=counts)
    check(not any(eng.slots), f"{label}: requests did not retire")
    prof_wall_ms = passes[-1]
    total = sum(by_name.values())
    groups = {"flash_decode": 0.0, "flash_decode_paged": 0.0,
              "kv_row_update": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if DECODE_KERNEL.search(name):
            # one kernel body, instantiated with PAGED = false and true
            paged = ", true>(" in name
            groups["flash_decode_paged" if paged else "flash_decode"] += us
        elif "kv_rows_kernel" in name:
            groups["kv_row_update"] += us
        elif any(t in low for t in ("gemm", "gemv", "cutlass", "sm90_",
                                    "nvjet", "matmul", "splitk")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    dev_ms = total / 1e3 / steps
    print(f"{label}: full-width decode step, 8 slots (2 dispatches of "
          f"{eng.chunk} tokens, same requests twice): device busy "
          f"{dev_ms:.2f} ms/step (profiled pass) of {wall_ms:.2f} ms/step "
          f"wall (unprofiled pass), idle share {1 - dev_ms / wall_ms:.3f}; "
          f"under the profiler {prof_wall_ms:.2f} ms/step wall")
    copies = sum(n for name, n in counts.items()
                 if name.startswith(("Memcpy", "Memset")))
    print(f"{label}: kernel launches a step "
          f"{(sum(counts.values()) - copies) / steps:.1f}, plus "
          f"{copies / steps:.1f} copies and fills (profiler events; it "
          f"drops a few)")
    print(f"{label}: device time by group: " + ", ".join(
        f"{g} {us / 1e3 / steps:.3f} ms/step ({us / total:.3f})"
        for g, us in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        print(f"{label}: {us / 1e3 / steps:8.3f} ms/step  {name[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the repository root (src/repro_torch "
              "not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch import serve
    from repro_torch.kernels import build, stores as S_
    from repro_torch.kernels.attention import decode as D, ops, ref as R
    from repro_torch.kernels.stream import ops as SO, ref as SR
    from repro_torch.models import layers as L, model as M
    from repro_torch.serve import pages as PG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = phase_device(torch)
    phase_build(build)
    decode_err = phase_decode(torch, D, ops)
    paged_err = phase_paged_decode(torch, D, ops)
    flash_err = phase_flash(torch, ops, R)
    phase_stores(torch, S_)
    stream_rows = phase_stream(torch, K, SO, SR,
                               phase_stream_check(torch, K, SO, SR))
    eng, reqs, launches = phase_engine(torch, np, cfg_mod, M, K, serve)
    flash_launches = phase_prefill_attention(torch, np, eng.cfg, M, L, K,
                                             ops, R, eng.params)
    peng, paged_launches = phase_paged_engine(
        torch, np, cfg_mod, M, K, serve, PG, eng.params, eng.stats())
    rows = phase_timings(torch, np, D, ops, S_, eng, reqs, launches,
                         decode_err)
    rows += phase_new_timings(torch, D, ops, R, peng, reqs, paged_launches,
                              paged_err, flash_launches, flash_err)
    rows += stream_rows
    phase_wide_timings(torch, D, ops, R, reqs)
    phase_trace(torch, serve, eng, reqs, "trace")
    phase_trace(torch, serve, peng,
                paged_requests(np, serve, eng.cfg.vocab_size, 8, 5, 256,
                               256, 64), "paged trace")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
