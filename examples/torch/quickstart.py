"""Quickstart on the PyTorch port: the paper's workflow end-to-end on one
kernel, on the H100.

1. Write the kernel (STREAM triad) as a plain PyTorch function.
2. Lower it to its ATen trace on meta tensors and let the port model
   (OSACA-semantics TP/CP/LCD over the trace) produce a lower-bound
   runtime for the ``h100`` machine file AND the ubench-calibrated
   model of the card (``h100_measured``).
3. Run the hand-written ``stream_triad`` CUDA kernel
   (``kernels/csrc/stream.cu``), hold it against the plain version, and
   compare its measured time with both our model and the naive
   counts-over-peaks baseline (the LLVM-MCA stand-in): paper Fig. 3 in
   miniature.

The counterpart of ``examples/quickstart.py``. On the card the arrays
hold 2^28 f32 each (64x the reference's 2^22, whose 48 MB would fit the
H100's 50 MB L2); ``--device cpu`` keeps the reference's size and its
host path (the ``host_cpu`` calibration, the eager triad timed on the
host's clock). Without a card it exits 2 unless asked for the host.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from repro_torch.core import baseline, portmodel, trace, ubench
from repro_torch.core.machine import get_machine
from repro_torch.kernels.stream import ops as SO

N_HOST = 1 << 22        # the reference's size
N_CARD = 1 << 28        # 1 GiB an array: three of them far exceed L2
SCALAR = 2.5
REPEATS = 5


@trace.kernel
def triad(b, c):
    """``b + 2.5 * c``: one kernel in a lowering (its inputs read once,
    its output written once), as XLA fuses the reference's triad."""
    return b + SCALAR * c


def triad_trace(n: int) -> trace.Trace:
    """The plain triad lowered on meta tensors of ``n`` f32 each."""
    b, c = (torch.empty(n, dtype=torch.float32, device="meta")
            for _ in range(2))
    return trace.lower_call(triad, (b, c))


def _best_seconds(fn, device: torch.device) -> float:
    """Best of :data:`REPEATS` calls after a warm-up: CUDA events on the
    card, the host's clock on the CPU."""
    fn()
    if device.type != "cuda":
        best = math.inf
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize(device)
    times = []
    for _ in range(REPEATS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    return min(times)


def run(device: torch.device, n: int) -> dict:
    """Price, predict and measure the triad at ``n`` f32 an array on
    ``device``; returns every figure printed (seconds, bytes, RPEs)."""
    tr = triad_trace(n)

    # --- target machine: the H100's spec-derived machine file ---
    spec = get_machine("h100")
    rep = portmodel.analyze(tr, spec)

    # --- the device: calibrate, predict, measure ---
    model = ubench.calibrated_host_model(device=device)
    rep_m = portmodel.analyze(tr, model)
    ws = 2 * 4 * n
    t_pred = max(rep_m.seconds_incore(model),
                 rep_m.bytes_hbm / ubench.tier_bw(ws, device))
    meta = [torch.empty(n, dtype=torch.float32, device="meta")
            for _ in range(2)]
    counts = baseline.step_counts(triad, *meta)
    t_naive = baseline.predict(counts, model,
                               *ubench.host_peaks(device)).seconds

    b = torch.randn(n, generator=torch.Generator(device).manual_seed(0),
                    device=device)
    c = torch.randn(n, generator=torch.Generator(device).manual_seed(1),
                    device=device)
    if device.type == "cuda":
        def call():
            return SO.stream_triad(b, c, SCALAR, impl="cuda")
        what = "stream_triad kernel (csrc/stream.cu)"
    else:
        def call():
            return triad(b, c)
        what = "eager triad"
    out = call()
    want = triad(b, c)
    max_err = (out - want).abs().max().item()
    if max_err > 0.0:
        raise RuntimeError(f"{what} differs from the plain triad by "
                           f"{max_err:.3g}")
    del out, want
    best = _best_seconds(call, device)
    return {"spec": spec.name, "model": model.name, "what": what, "n": n,
            "flops": rep.flops, "bytes_hbm": rep.bytes_hbm,
            "t_incore": rep.bound_incore_cycles / spec.clock_hz,
            "t_spec": rep.seconds(spec), "bottleneck": rep.bottleneck(),
            "t_measured": best, "t_pred": t_pred, "t_naive": t_naive,
            "max_abs_err": max_err,
            "rpe_spec": (best - rep.seconds(spec)) / best,
            "rpe_pred": (best - t_pred) / best,
            "rpe_naive": (best - t_naive) / best}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to measure on (default: cuda; the host "
                         "only when asked with --device cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("quickstart: no CUDA device; pass --device cpu to measure "
              "the host", file=sys.stderr)
        return 2
    n = N_CARD if device.type == "cuda" else N_HOST
    r = run(device, n)
    print(f"== {r['spec']} (target, machine file) : triad of 2^"
          f"{int(math.log2(n))} f32 ==")
    print(f"  flops={r['flops']:.3e}  hbm_bytes={r['bytes_hbm']:.3e}")
    print(f"  in-core bound: {r['t_incore']*1e6:.2f} us"
          f"   full bound: {r['t_spec']*1e6:.2f} us"
          f"   bottleneck: {r['bottleneck']}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "host"
    print(f"== {where} ({r['model']}): {r['what']}, measured vs "
          f"predicted ==")
    print(f"  measured     : {r['t_measured']*1e6:9.1f} us  (best of "
          f"{REPEATS}; max abs err vs plain {r['max_abs_err']:.1e})")
    if device.type == "cuda":        # the machine file is the card's
        print(f"  {r['spec']} bound   : {r['t_spec']*1e6:9.1f} us  "
              f"(rpe {r['rpe_spec']:+.2f})")
    print(f"  port model   : {r['t_pred']*1e6:9.1f} us  "
          f"(rpe {r['rpe_pred']:+.2f}; >=0 means lower bound held)")
    print(f"  naive (MCA~) : {r['t_naive']*1e6:9.1f} us  "
          f"(rpe {r['rpe_naive']:+.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
