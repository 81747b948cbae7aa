"""The comparison model — our LLVM-MCA stand-in.

The counterpart of ``repro/core/baseline.py``. LLVM-MCA predicts from a
generic scheduling model without measured port data; here the naive
two-term roofline does: raw FLOPs and bytes pushed through peak-rate
ceilings, with no port structure, no latency chains and no loop-trip
awareness, so the Fig. 3 harness can score both models on identical
inputs. The JAX package reads the counts from XLA's ``cost_analysis``;
the port counts a PyTorch function itself (:func:`step_counts`): the
matrix products' FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
(as PyTorch counts them), every other op's FLOPs and transcendentals by
XLA's rule (:func:`xla_op_counts`), and bytes from the function's ATen
trace (``core/trace.py``: every non-view op reads its inputs and writes
its outputs once). ``predict`` takes the counts as the JAX package's
takes ``cost_analysis``: a dict (or a list of dicts, or None).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.machine import MachineModel


@dataclasses.dataclass
class BaselineReport:
    """Naive two-term roofline prediction from raw FLOP/byte counts."""

    flops: float
    bytes_hbm: float
    transcendentals: float
    t_compute: float
    t_memory: float

    @property
    def seconds(self) -> float:
        """Predicted runtime: the slower of the two roofline terms."""
        return max(self.t_compute, self.t_memory)

    def bottleneck(self) -> str:
        """Which term dominates — "compute" or "memory"."""
        return "compute" if self.t_compute >= self.t_memory else "memory"


def normalize_cost_analysis(cost_analysis: dict | list | None) -> dict:
    """Collapse a counts dict, a (possibly empty) list of them, or None
    to a plain dict: a list to its first entry, empty and None to ``{}``
    (lookups then give 0.0). Keys: ``"flops"``, ``"bytes accessed"``,
    ``"transcendentals"``, as XLA names them."""
    if isinstance(cost_analysis, (list, tuple)):
        cost_analysis = cost_analysis[0] if cost_analysis else {}
    return cost_analysis or {}


def predict(cost_analysis: dict | list | None, machine: MachineModel,
            peak_flops: float | None = None,
            mem_bw: float | None = None) -> BaselineReport:
    """Naive roofline from a counts dict (per-device numbers)."""
    cost_analysis = normalize_cost_analysis(cost_analysis)
    chip = machine.chip
    if peak_flops is None:
        peak_flops = chip.bf16_flops if chip else 1e11
    if mem_bw is None:
        mem_bw = chip.hbm_bw if chip else 2e10
    flops = float(cost_analysis.get("flops", 0.0) or 0.0)
    byts = float(cost_analysis.get("bytes accessed", 0.0) or 0.0)
    trans = float(cost_analysis.get("transcendentals", 0.0) or 0.0)
    return BaselineReport(
        flops=flops, bytes_hbm=byts, transcendentals=trans,
        t_compute=flops / peak_flops, t_memory=byts / mem_bw)


def predict_from_counts(flops: float, byts: float, machine: MachineModel,
                        peak_flops: float | None = None,
                        mem_bw: float | None = None) -> BaselineReport:
    """`predict` for callers that already hold raw FLOP/byte counts."""
    return predict({"flops": flops, "bytes accessed": byts}, machine,
                   peak_flops, mem_bw)


#: elementwise ops XLA counts two FLOPs an output element for (a product
#: and a sum, or a difference and a product)
_TWO_FLOP_OPS = {"addcmul", "addcdiv", "lerp"}
#: ops that move or make data: no FLOPs (XLA's copy, slice, concatenate,
#: pad, broadcast, iota, gather, scatter, dynamic-update-slice)
_NO_FLOP_OPS = {"clone", "copy", "contiguous", "cat", "stack", "fill",
                "zero", "zeros", "ones", "full", "zeros_like", "ones_like",
                "full_like", "arange", "linspace", "scalar_tensor",
                "constant_pad_nd", "pad", "repeat", "flip", "roll",
                "index_copy", "index_put", "_index_put_impl", "scatter",
                "slice_scatter", "select_scatter", "diagonal_scatter",
                "as_strided_scatter", "masked_scatter", "index_fill",
                "embedding", "index_select", "gather", "index", "take",
                "uniform", "normal", "bernoulli", "rand", "randn",
                "randint", "random", "exponential"}


def xla_op_counts(opcode: str, ins: list, outs: list) -> tuple:
    """``(flops, transcendentals)`` of one non-view ATen op as XLA's
    ``cost_analysis`` counts its HLO: one FLOP an output element for an
    elementwise op (arithmetic, compare, select, a dtype convert), a
    transcendental in place of the FLOP for exp, log, tanh, sqrt and
    their kin, ``n_in - n_out`` FLOPs for a reduction (``mean`` adds its
    division), nothing for data movement. ``ins``/``outs`` are the op's
    tensors as ``isa.Operand``; matrix products count 0 here
    (:func:`step_counts` takes them from ``FlopCounterMode``)."""
    from repro_torch.core import isa
    name = isa.base_name(opcode)
    e = float(sum(o.elems for o in outs))
    if (name in isa.MATMUL_OPS or name in isa.ALLOC_OPS
            or name in _NO_FLOP_OPS):
        return 0.0, 0.0
    if name in ("_to_copy", "to"):       # a convert only across dtypes
        same = ins and outs and ins[0].itemsize == outs[0].itemsize
        return (0.0 if same else e), 0.0
    if name in isa.SOFTMAX_OPS:
        return 3.0 * e, e
    if name in isa.REDUCE_OPS and ins and ins[0].elems > e:
        n_in = float(ins[0].elems)
        return n_in - e + (e if name == "mean" else 0.0), 0.0
    if name in isa.XLU_OPS:
        return 0.0, e
    if name in _TWO_FLOP_OPS:
        return 2.0 * e, 0.0
    return e, 0.0


def step_counts(fn, *args, **kwargs) -> dict:
    """FLOPs and bytes of ``fn(*args, **kwargs)`` as :func:`predict` takes
    them, counted as XLA's ``cost_analysis`` counts a compiled function:
    ``"flops"`` the matrix products' from ``FlopCounterMode`` plus every
    other ATen op's by :func:`xla_op_counts`, ``"transcendentals"`` (only
    when there are any, as XLA's dict), ``"bytes accessed"`` the ATen
    trace's HBM bytes (``trace.lower_step``, loop bodies times their
    trips; pass meta tensors to count without memory or a device). The
    function runs once, lowered.

    The counts follow the ops the card runs, one kernel an op: where XLA
    fuses, folds or rewrites an op away, the two differ (``tests/
    test_torch_analysis.py`` names each such difference). A loop
    (``utils.loops.repeat``) counts its body's FLOPs once, as XLA's
    ``cost_analysis`` visits a ``while`` body once: the naive baseline
    does not see trip counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import trace as trace_lib

    tally = [0.0, 0.0]

    def count(opcode, ins, outs):
        f, t = xla_op_counts(opcode, ins, outs)
        tally[0] += f
        tally[1] += t
    with FlopCounterMode(display=False) as fc:
        tr = trace_lib.lower_call(fn, args, kwargs, on_op=count)
    out = {"flops": float(fc.get_total_flops()) + tally[0],
           "bytes accessed": _trace_bytes(tr.entry)}
    if tally[1]:
        out["transcendentals"] = tally[1]
    return out
def _trace_bytes(region) -> float:
    """HBM bytes of a trace region: its ops' boundary bytes, loop bodies
    times their trips."""
    total = 0.0
    for op in region.ops:
        if op.dma_bytes is not None:
            total += op.dma_bytes
        if op.kind == "loop" and op.region is not None:
            total += op.trips * _trace_bytes(op.region)
    return total
