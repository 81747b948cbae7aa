"""Analyze one (architecture x shape) cell like the dry run does, on a
reduced config so it runs anywhere: lower a train step to its ATen trace
on meta tensors, run the port model and the WA analyzer on the trace,
and print the three roofline terms at the H100's rates.

The counterpart of ``examples/analyze_arch.py``. Nothing is allocated
and no device is needed: the step (autograd, AdamW) runs on meta
tensors under ``core.trace.lower_call``. The terms use the ``h100``
machine file's chip (dense bf16 peak, HBM rate, NVLink one direction):
every figure is a model price, not a measurement.

Run:  PYTHONPATH=src python examples/torch/analyze_arch.py \\
          --arch jamba-v0.1-52b
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import portmodel, roofline, trace, wa
from repro_torch.core.machine import get_machine
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as step_lib

MACHINE = "h100"


def lower_train_step(arch: str, seq: int, batch: int) -> trace.Trace:
    """The smoke config's train step (one microbatch) lowered on meta
    tensors, with its stores."""
    cfg = get_smoke_config(arch)
    shape = ShapeSpec("example", seq, batch, "train")
    fn = step_lib.make_train_step(cfg, OptConfig(), 1)
    state = step_lib.train_state_shapes(cfg)
    batch_ = step_lib.batch_shapes(cfg, shape)
    return trace.lower_call(fn, (state, batch_), stores=True)


def roofline_terms(rep, war: dict, machine) -> dict:
    """The three roofline terms in seconds at ``machine``'s chip rates:
    FLOPs over the dense bf16 peak, WA-adjusted HBM bytes over the HBM
    rate, collective wire bytes over the links."""
    peak, link_bw, links = roofline.chip_rates(machine)
    return {"compute": rep.flops / peak,
            "memory": rep.bytes_hbm * war["wa_ratio"] / machine.chip.hbm_bw,
            "collective": roofline.collective_seconds(rep.coll_bytes,
                                                      link_bw, links)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b",
                    choices=list(ARCH_IDS))
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)

    tr = lower_train_step(args.arch, args.seq, args.batch)
    m = get_machine(MACHINE)
    rep = portmodel.analyze(tr, m)
    war = wa.analyze_trace_stores(tr)
    t = roofline_terms(rep, war, m)
    print(f"arch={args.arch} (smoke) shape={args.seq}x{args.batch}, "
          f"priced on {MACHINE}")
    print(f"  flops/step      : {rep.flops:.3e}")
    print(f"  hbm bytes/step  : {rep.bytes_hbm:.3e}  (wa_ratio "
          f"{war['wa_ratio']:.2f})")
    print(f"  T_compute       : {t['compute']*1e6:10.1f} us")
    print(f"  T_compute(port) : {rep.seconds_incore(m)*1e6:10.1f} us")
    print(f"  T_memory        : {t['memory']*1e6:10.1f} us")
    print(f"  T_collective    : {t['collective']*1e6:10.1f} us")
    print(f"  bottleneck      : {rep.bottleneck()}  "
          f"(serial/LCD cycles {rep.serial_cycles:.2e})")
    print(f"  loop trips seen : {dict(list(rep.trips_seen.items())[:6])}")
    print(f"  unknown ops     : {rep.unknown_ops}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
