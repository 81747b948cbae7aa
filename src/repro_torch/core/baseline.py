"""The comparison model — our LLVM-MCA stand-in.

The counterpart of ``repro/core/baseline.py``. LLVM-MCA predicts from a
generic scheduling model without measured port data; here the naive
two-term roofline does: raw FLOPs and bytes pushed through peak-rate
ceilings, with no port structure, no latency chains and no loop-trip
awareness, so the Fig. 3 harness can score both models on identical
inputs. The JAX package reads the counts from XLA's ``cost_analysis``;
the port counts a PyTorch function itself (:func:`step_counts`): FLOPs
from ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
attention, as PyTorch counts them) and bytes from the function's ATen
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


def step_counts(fn, *args, **kwargs) -> dict:
    """FLOPs and bytes of ``fn(*args, **kwargs)`` as :func:`predict` takes
    them: ``"flops"`` from ``FlopCounterMode``, ``"bytes accessed"`` the
    ATen trace's HBM bytes (``trace.lower_step``; pass meta tensors to
    count without memory or a device). The function runs twice."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import trace as trace_lib

    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    tr = trace_lib.lower_step(fn, *args, **kwargs)
    return {"flops": float(fc.get_total_flops()),
            "bytes accessed": _trace_bytes(tr.entry)}


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
