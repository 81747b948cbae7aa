"""The paper's Fig. 3 harness: relative-prediction-error validation of the
in-core port model vs the naive baseline over 13 streaming kernels x 8
lowering variants x 4 sizes = 416 test blocks.

The counterpart of ``repro/core/rpe.py``. The paper varied compilers and
flags; the JAX package varies the lowering; the port varies the eager
PyTorch program:

* ``eager``    — the plain version (``kernels/stream/ref.py``), one
  kernel an ATen op (JAX: ``jnp``);
* ``bf16``     — the inputs in bfloat16;
* ``chunked``  — four strided quarters, concatenated (sums added);
* ``unroll2``  — two halves, concatenated (sums added);
* ``loop``     — a loop over 64 rows (``utils.loops.repeat``: a Python loop
  that lowers to one loop region, as JAX's ``fori`` to one ``while``);
* ``inplace``  — UPDATE written into its input (JAX: ``donated``),
  fresh clones made outside the timing; other kernels run plain;
* ``reversed`` — the inputs flipped along their first axis and the
  output flipped back;
* ``kernel``   — the hand-written kernel (``kernels/stream/ops.py``) on
  the card, the plain version on the CPU (JAX: ``pallas``, which calls
  the ops with ``impl="ref"``). ``jacobi_3d11pt`` and ``jacobi_3d27pt``
  have no kernel in either package and run plain (``PLAIN_KERNELS``).

Predictions: ``t_port`` (``tp_bound``) and ``t_mca`` (``mca_sched``) from
``portmodel.analyze`` of the block's ATen trace (``trace.lower_step``,
lowered on meta tensors: no memory, no device), each the larger of its
in-core time and the memory term (the trace's HBM bytes over the
machine's rate at the working set's tier); the ``kernel`` variant lowers
through a ``trace.kernel`` region, priced by the bytes that enter and
leave it (no CUDA wrapper is called on meta). ``t_naive`` is the naive
roofline (``core/baseline.py``) of ``baseline.step_counts``.

RPE convention (matches the paper's histogram): rpe = (t_meas - t_pred)
/ t_meas. Positive => prediction FASTER than measurement (the lower-bound
side, right of the red line); negative => prediction slower; <= -1.0 =>
off by more than 2x (the left bucket).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from repro_torch.core import baseline as baseline_lib
from repro_torch.core import portmodel
from repro_torch.core import trace as trace_lib
from repro_torch.kernels.stream import ref as R
from repro_torch.utils.loops import repeat

SIZES = {                   # streaming-regime working sets (f32 elements)
    "S": 1 << 18,           # 1 MiB
    "M": 1 << 20,           # 4 MiB
    "L": 1 << 22,           # 16 MiB
    "XL": 1 << 23,          # 32 MiB
}
#: the card's sizes: SIZES x 64 (S 64 MiB ... XL 2 GiB an array), each
#: past the card's 50 MB L2 as SIZES sit past a host's caches (every
#: size of SIZES is L2-resident on the card)
CARD_SIZES = {k: v * 64 for k, v in SIZES.items()}

VARIANTS = ("eager", "bf16", "chunked", "unroll2", "loop", "inplace",
            "reversed", "kernel")
#: kernels with no hand-written kernel in either package: their
#: ``kernel`` variant runs the plain version, as the reference's does
PLAIN_KERNELS = ("jacobi_3d11pt", "jacobi_3d27pt")


def sizes_for(device) -> dict:
    """The size table of a device: ``CARD_SIZES`` on the card, ``SIZES``
    elsewhere."""
    return CARD_SIZES if torch.device(device).type == "cuda" else SIZES


def _dims2(n):
    rows = max(8, int(np.sqrt(n)) // 128 * 128)
    return rows, max(128, n // rows)


def _dims3(n):
    side = max(8, int(round(n ** (1 / 3))))
    return side, side, max(8, n // (side * side))


def input_shapes(kernel: str, n: int) -> tuple:
    """Shapes of one suite kernel's input tensors at size n (none for
    ``init`` and ``pi_integration``)."""
    if kernel in ("jacobi_2d5pt", "gauss_seidel_2d5pt"):
        return (_dims2(n),)
    if kernel in ("jacobi_3d7pt", "jacobi_3d11pt", "jacobi_3d27pt"):
        return (_dims3(n),)
    if kernel in ("init", "pi_integration"):
        return ()
    vecs = {"copy": 1, "update": 1, "sum_reduction": 1, "add": 2,
            "stream_triad": 2, "schoenauer_triad": 3}[kernel]
    return ((n,),) * vecs


def make_inputs(kernel: str, n: int, dtype=torch.float32,
                device="cuda") -> tuple:
    """Deterministic input tensors for one suite kernel at size n (a
    generator seeded 42 on ``device``; on meta, tensors without data)."""
    shapes = input_shapes(kernel, n)
    if torch.device(device).type == "meta":
        return tuple(torch.empty(s, dtype=dtype, device="meta")
                     for s in shapes)
    gen = torch.Generator(device=device).manual_seed(42)
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in shapes)


def base_fn(kernel: str, n: int, device="cuda"):
    """The plain callable for one suite kernel."""
    if kernel == "init":
        return lambda: R.init((n,), device=device)
    if kernel == "pi_integration":
        return lambda: R.pi_integration(n, device=device)
    return getattr(R, kernel)


def _kernel_fn(kernel: str, n: int, device):
    """The ``kernel`` variant's callable: the ops entry point (its
    hand-written kernel on a CUDA tensor, the plain version elsewhere) as
    one ``trace.kernel`` region; None for ``PLAIN_KERNELS``."""
    from repro_torch.kernels.stream import ops as K
    if kernel in PLAIN_KERNELS:
        return None
    if kernel == "init":
        def init():
            return K.init(_dims2(n), device=device)
        return trace_lib.kernel(init)
    if kernel == "pi_integration":
        def pi_integration():
            return K.pi_integration(n, device=device)
        return trace_lib.kernel(pi_integration)
    return trace_lib.kernel(getattr(K, kernel))


def build_variant(kernel: str, variant: str, n: int, device="cuda",
                  args: tuple | None = None):
    """Returns (callable, args) for one test block on ``device``
    (``"meta"`` to lower it). ``args`` replaces :func:`make_inputs`'."""
    fn = base_fn(kernel, n, device)
    if args is None:
        args = make_inputs(kernel, n, device=device)
    if kernel in ("init", "pi_integration"):
        args = ()

    if variant == "bf16":
        args = tuple(a.to(torch.bfloat16) for a in args)
        if kernel == "init":
            return (lambda: R.init((n,), dtype=torch.bfloat16,
                                   device=device)), ()
    if variant == "chunked" and args and args[0].ndim == 1:
        def chunked(*xs):
            parts = [tuple(x[i::4] for x in xs) for i in range(4)]
            if kernel == "sum_reduction":
                return sum(fn(*p) for p in parts)
            return torch.cat([fn(*p) for p in parts])
        return chunked, args
    if variant == "unroll2" and args and args[0].ndim == 1:
        def unroll2(*xs):
            h = xs[0].shape[0] // 2
            lo = fn(*(x[:h] for x in xs))
            hi = fn(*(x[h:] for x in xs))
            if lo.ndim == 0:
                return lo + hi
            return torch.cat([lo, hi])
        return unroll2, args
    if variant == "loop" and args and args[0].ndim == 1:
        rows = 64

        def loop(*xs):
            xs2 = tuple(x[: (x.shape[0] // rows) * rows].reshape(rows, -1)
                        for x in xs)
            x0 = xs2[0]
            if kernel == "sum_reduction":   # a sum, carried through the rows
                acc = [torch.zeros((), dtype=x0.dtype, device=x0.device)]

                def step(i):
                    acc[0] = acc[0] + fn(*(x[i] for x in xs2))
                repeat(rows, step)
                return acc[0]
            out = torch.empty(x0.shape, dtype=x0.dtype, device=x0.device)

            def row(i):
                out[i] = fn(*(x[i] for x in xs2))
            repeat(rows, row)
            return out
        return loop, args
    if variant == "inplace" and args and kernel == "update":
        def update_inplace(a):
            return a.mul_(2.0)
        return update_inplace, args
    if variant == "reversed" and args and args[0].ndim >= 1:
        def rev(*xs):
            out = fn(*(torch.flip(x, dims=(0,)) for x in xs))
            return torch.flip(out, dims=(0,)) if out.ndim else out
        return rev, args
    if variant == "kernel":
        kfn = _kernel_fn(kernel, n, device)
        if kfn is not None:
            return kfn, args
    # default: the plain version
    return fn, args


def _sync(args, out=None) -> None:
    for x in tuple(args) + (out,):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            return


def measure(fn, args, reps: int = 5, inner: int = 3,
            consumes_args: bool = False) -> float:
    """Best-of-``reps`` wall time of one call (seconds), each read between
    device synchronizations, averaged over ``inner`` calls a reading.

    ``consumes_args`` handles a call that writes into its input: fresh
    clones are made outside the timed region and the inner-loop
    amortization is skipped.
    """
    if consumes_args:
        best = float("inf")
        for _ in range(reps + 1):
            fresh = tuple(a.clone() for a in args)
            _sync(fresh)
            t0 = time.perf_counter()
            out = fn(*fresh)
            _sync(fresh, out)
            best = min(best, time.perf_counter() - t0)
        return best
    out = fn(*args)
    _sync(args, out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        _sync(args, out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


@dataclasses.dataclass
class RpeRecord:
    """One Fig. 3 data point: measured vs per-backend predicted runtimes.

    ``t_port`` is the analytical ``tp_bound`` backend (the OSACA side of
    the paper's comparison), ``t_mca`` the ``mca_sched`` cycle simulator
    (the LLVM-MCA side), ``t_naive`` the naive roofline baseline.
    Records lacking ``t_mca`` load as NaN (the fig3 harness re-runs
    them)."""

    kernel: str
    variant: str
    size: str
    t_meas: float
    t_port: float
    t_naive: float
    t_mca: float = float("nan")

    @property
    def rpe_port(self) -> float:
        """Relative prediction error of the port model (+ = under)."""
        return (self.t_meas - self.t_port) / self.t_meas

    @property
    def rpe_naive(self) -> float:
        """Relative prediction error of the naive baseline (+ = under)."""
        return (self.t_meas - self.t_naive) / self.t_meas

    @property
    def rpe_mca(self) -> float:
        """Relative prediction error of the MCA simulator (+ = under)."""
        return (self.t_meas - self.t_mca) / self.t_meas


def record_from_dict(d: dict) -> RpeRecord:
    """Rebuild a record from JSON, mapping null timings back to NaN."""
    return RpeRecord(**{k: (float("nan")
                            if v is None and k.startswith("t_") else v)
                        for k, v in d.items()})


def load_records(path: str) -> list:
    """Load cached records; a corrupt/truncated cache reads as empty
    (it is regenerable) rather than wedging every later run."""
    import json
    try:
        with open(path) as f:
            recs = [record_from_dict(d) for d in json.load(f)]
    except (json.JSONDecodeError, TypeError, KeyError):
        return []
    return [r for r in recs
            if all(isinstance(getattr(r, k), str)
                   for k in ("kernel", "variant", "size"))]


def save_records(records: list, path: str) -> None:
    """Persist records as strict JSON (non-finite floats become null).
    Writes atomically so an interrupted run cannot truncate the cache."""
    import json
    import os
    rows = []
    for r in records:
        d = dict(r.__dict__)
        for k, v in d.items():
            if isinstance(v, float) and not np.isfinite(v):
                d[k] = None
        rows.append(d)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rows, f, indent=1, allow_nan=False)
    os.replace(tmp, path)


def _naive_peaks(machine) -> tuple:
    """(peak FLOP/s, bytes/s) of the naive roofline: the calibrated host's
    measured matmul rate and stream (as the reference's ``host_peaks``),
    else the machine's chip (``h100_measured``'s chip carries its
    measured rates)."""
    if machine.name == "host_cpu":
        from repro_torch.core.ubench import host_peaks
        return host_peaks("cpu")
    return None, None


def predict(kernel: str, variant: str, n: int, machine) -> tuple:
    """``(t_port, t_mca, t_naive)`` seconds of one block on a machine,
    lowered on meta tensors (module docstring)."""
    from repro_torch.core.machine import get_machine
    from repro_torch.core.ubench import machine_tier_bw
    machine = get_machine(machine)
    fn, args = build_variant(kernel, variant, n, device="meta")
    tr = trace_lib.lower_step(fn, *args)
    # one mca_sched report carries BOTH predictions: the simulator runs
    # the analytic walk first and keeps its TP/LCD fields intact
    rep = portmodel.analyze(tr, machine, "mca_sched")
    ws = sum(4 * a.numel() for a in args) or 4 * n
    t_mem = rep.bytes_hbm / machine_tier_bw(machine, float(ws))
    t_incore_tp = max(rep.tp_incore_cycles,
                      rep.serial_cycles) / machine.clock_hz
    t_port = max(t_incore_tp, t_mem)
    t_mca = max(rep.seconds_incore(machine), t_mem)
    peak, bw = _naive_peaks(machine)
    counts = baseline_lib.step_counts(fn, *args)
    t_naive = baseline_lib.predict(counts, machine, peak, bw).seconds
    return t_port, t_mca, t_naive


def default_machine(device="cuda"):
    """The device's calibrated model (``core/ubench.py``): ``host_cpu``
    on the CPU, ``h100_measured`` on the card."""
    from repro_torch.core.ubench import calibrated_host_model
    return calibrated_host_model(device=device)


def run_block_machines(kernel: str, variant: str, size: str, machines,
                       device="cuda", sizes: dict | None = None,
                       reps: int = 5, inner: int = 3) -> list:
    """Measure one (kernel, variant, size) block once on ``device``
    (:func:`measure`'s ``reps`` and ``inner``) and predict it on each of
    ``machines``: one record a machine."""
    n = (sizes or sizes_for(device))[size]
    fn, args = build_variant(kernel, variant, n, device=device)
    t_meas = measure(fn, args, reps=reps, inner=inner,
                     consumes_args=(variant == "inplace"))
    del fn, args
    out = []
    for m in machines:
        t_port, t_mca, t_naive = predict(kernel, variant, n, m)
        out.append(RpeRecord(kernel, variant, size, t_meas, t_port,
                             t_naive, t_mca))
    return out


def run_block(kernel: str, variant: str, size: str, machine=None,
              device="cuda", sizes: dict | None = None) -> RpeRecord:
    """Measure + model one (kernel, variant, size) block on ``device``;
    ``machine`` defaults to the device's calibrated model."""
    machine = machine if machine is not None else default_machine(device)
    return run_block_machines(kernel, variant, size, (machine,), device,
                              sizes)[0]


def run_suite(kernels=None, variants=VARIANTS, sizes=None, progress=None,
              machines=None, device="cuda", cached=None) -> dict:
    """Run the Fig. 3 grid on ``device``: each block measured once and
    predicted on each of ``machines`` (the device's calibrated model by
    default). Returns ``{machine: records}``, in grid order.

    A block that raises becomes NaN records (its error on stderr), so
    the suite finishes. ``sizes`` are size names (all of the device's
    table by default). ``cached(key)`` may return a block's records, one
    a machine, to skip running it; ``progress(key, records)`` is called
    after each block that ran (``key`` is ``(kernel, variant, size)``)."""
    kernels = kernels or R.KERNELS_13
    sizes = tuple(sizes or sizes_for(device))
    machines = tuple(machines or (default_machine(device),))
    names = [getattr(m, "name", m) for m in machines]
    out = {m: [] for m in names}
    for k in kernels:
        for v in variants:
            for s in sizes:
                key = (k, v, s)
                recs = cached(key) if cached else None
                if recs is None:
                    try:
                        recs = run_block_machines(k, v, s, machines, device)
                    except Exception as e:  # noqa: BLE001 — must finish
                        print(f"fig3: {k}/{v}/{s} failed: {e!r}",
                              file=sys.stderr)
                        nan = float("nan")
                        recs = [RpeRecord(k, v, s, nan, nan, nan)
                                for _ in machines]
                    if progress:
                        progress(key, recs)
                for m, r in zip(names, recs):
                    out[m].append(r)
    return out


def summarize(records: list) -> dict:
    """Fig. 3 summary stats per prediction engine (NaN-safe).

    Keys: ``port_model`` (tp_bound backend), ``mca_sched`` (cycle
    simulator backend), ``naive_baseline`` (naive roofline).
    Non-finite RPEs (failed blocks, records without ``t_mca``) are
    filtered per engine before any mean, so one NaN record cannot poison
    a summary."""
    def stats(rpes):
        r = np.array([x for x in rpes if np.isfinite(x)])
        if r.size == 0:
            return {}
        return {
            "n": int(r.size),
            "right_of_zero_pct": float((r >= 0).mean() * 100),
            "within10_pct": float(((r >= 0) & (r < 0.10)).mean() * 100),
            "within20_pct": float(((r >= 0) & (r < 0.20)).mean() * 100),
            "abs_within10_pct": float((np.abs(r) < 0.10).mean() * 100),
            "factor2_off": int((r <= -1.0).sum()),
            "mean_rpe": float(r.mean()),
            "mean_underpred_rpe": float(r[r >= 0].mean()) if (r >= 0).any()
            else float("nan"),
            "mean_abs_rpe": float(np.abs(r).mean()),
        }
    return {
        "port_model": stats([x.rpe_port for x in records]),
        "mca_sched": stats([x.rpe_mca for x in records]),
        "naive_baseline": stats([x.rpe_naive for x in records]),
        "n_blocks": len(records),
    }


_HIST_WHICH = {"port": "rpe_port", "mca": "rpe_mca", "naive": "rpe_naive"}


def histogram(records: list, which: str = "port", width: float = 0.10):
    """Bucketized RPE histogram (paper Fig. 3 bars) for one engine
    (``port`` / ``mca`` / ``naive``)."""
    vals = [getattr(r, _HIST_WHICH.get(which, "rpe_naive"))
            for r in records]
    vals = [v for v in vals if np.isfinite(v)]
    buckets: dict = {}
    for v in vals:
        if v <= -1.0:
            key = "<=-1.0"
        else:
            b = np.floor(v / width) * width
            key = f"{b:+.1f}"
        buckets[key] = buckets.get(key, 0) + 1
    return dict(sorted(buckets.items()))


def nan_records(records: list) -> list:
    """Records whose measurement or a prediction is not finite."""
    return [r for r in records
            if not all(math.isfinite(x) for x in
                       (r.t_meas, r.t_port, r.t_mca, r.t_naive))]
