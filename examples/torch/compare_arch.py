"""Cross-vendor comparison table (the paper's headline result) on the
PyTorch port: lower ONE step to its ATen trace and price it on the three
paper CPUs (Zen 4 / Genoa, Golden Cove / Sapphire Rapids, Neoverse V2 /
Grace) and the H100, side by side.

The counterpart of ``examples/compare_arch.py``. The step runs on meta
tensors, so nothing is allocated and no device is needed. For each
machine the registry fan-out (``portmodel.compare``) reports the in-core
bound, the bottleneck port, the tier-resolved bound with its bottleneck
memory tier (``core/memtier.py``), and the WA-adjusted store traffic
under that machine's write-allocate mode, reproducing the paper's
qualitative ordering: Grace (auto claim) <= SPR (SpecI2M) <= Zen 4
(explicit NT stores only). Every figure is a model price, not a
measurement.

The ATen trace stores every op's output, where the reference's scan
reads XLA's fusion outputs and dynamic-update-slices, so ``store MB``
differs from the JAX package's table (``tests/test_torch_examples.py``
names each difference); the modes, their ratios, the ordering and the
matrix products' FLOPs agree.

Run:  PYTHONPATH=src python examples/torch/compare_arch.py [--seq 128] [--nt]
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.core import portmodel, trace, wa
from repro_torch.core.machine import get_machine
from repro_torch.utils.loops import repeat

DEFAULT_MACHINES = ("zen4", "golden_cove", "neoverse_v2", "h100")


def workload_trace(seq: int, d_model: int, n_layers: int) -> trace.Trace:
    """A looped residual MLP block writing into a cache slot, lowered on
    meta tensors with its stores: enough structure to exercise matmul,
    transcendental, and store paths. The loop is one ``repeat`` region of
    ``n_layers`` trips, as the reference's ``lax.scan`` is one ``while``.
    """

    def step(x, w1, w2, cache):
        c = x.clone()           # the loop's carry, as XLA copies x into it

        def body(_):
            h = torch.tanh(c @ w1)
            c.addmm_(torch.softmax(h, dim=-1), w2)      # c = s @ w2 + c
        repeat(n_layers, body)
        cache[0] = c            # the dynamic_update_slice at (0, 0, 0)
        return c, cache

    meta = dict(dtype=torch.float32, device="meta")
    args = (torch.empty(seq, d_model, **meta),
            torch.empty(d_model, d_model, **meta),
            torch.empty(d_model, d_model, **meta),
            torch.empty(4, seq, d_model, **meta))
    return trace.lower_call(step, args, stores=True)


def compare_table(tr: trace.Trace, machines=DEFAULT_MACHINES,
                  nt_stores: bool = False,
                  backend: str = "tp_bound") -> list:
    """[(name, report, wa-dict)] for one trace across machines.

    ``backend`` picks the scheduling engine (``tp``/``mca``); the trace
    is lowered once regardless.
    """
    reports = portmodel.compare(tr, machines=machines, backends=backend)
    scan = wa.analyze_trace_stores(tr)      # machine-independent: once
    return [(name, rep, wa.apply_wa_mode(scan, name, nt_stores=nt_stores))
            for name, rep in reports.items()]


def ordering(rows: list) -> tuple | None:
    """``(ok, grace, spr, zen4)`` store traffic in bytes, or None when a
    paper CPU is missing from ``rows``."""
    traffic = {name: w["traffic_bytes"] for name, _, w in rows}
    if not all(k in traffic for k in ("neoverse_v2", "golden_cove", "zen4")):
        return None
    g, s, z = (traffic[k] for k in ("neoverse_v2", "golden_cove", "zen4"))
    return g <= s <= z, g, s, z


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--nt", action="store_true",
                    help="assume non-temporal stores")
    ap.add_argument("--backend", default="tp",
                    help="scheduling backend: tp (analytical bound) or "
                         "mca (cycle simulator)")
    args = ap.parse_args(argv)

    tr = workload_trace(args.seq, args.d_model, args.layers)
    rows = compare_table(tr, nt_stores=args.nt, backend=args.backend)

    hdr = (f"{'machine':<13} {'uarch':<22} {'clock':>6} {'bound cy':>12} "
           f"{'in-core cy':>12} {'t_bound':>9} {'t_tier':>9} "
           f"{'bottleneck':>12} {'tier':>5} "
           f"{'wa_mode':<16} {'wa x':>5} {'store MB':>9}")
    print(f"module: loop[{args.layers}] residual MLP, "
          f"{args.seq}x{args.d_model} f32, ATen trace on meta tensors"
          + (" (NT stores)" if args.nt else ""))
    print(hdr)
    print("-" * len(hdr))
    for name, rep, w in rows:
        m = get_machine(name)
        uarch = (m.notes.split(":")[0] if ":" in m.notes
                 else f"{m.vendor} {m.isa_name}".strip())[:22]
        print(f"{name:<13} {uarch:<22} "
              f"{m.clock_hz/1e9:>5.2f}G {rep.bound_cycles:>12.3e} "
              f"{rep.bound_incore_cycles:>12.3e} "
              f"{rep.seconds(m)*1e6:>7.1f}us "
              f"{rep.tier_bound_seconds(m)*1e6:>7.1f}us "
              f"{rep.bottleneck():>12} "
              f"{rep.bottleneck_tier or 'n/a':>5} "
              f"{w['wa_mode']:<16} {w['wa_ratio']:>5.2f} "
              f"{w['traffic_bytes']/1e6:>9.2f}")

    # the paper's qualitative ordering only applies to standard stores:
    # with NT stores Zen 4 evades fully and the ordering inverts
    order = ordering(rows)
    if not args.nt and order is not None:
        ok, g, s, z = order
        print(f"\nWA ordering Grace <= SPR <= Zen4 (no NT stores): "
              f"{'OK' if ok else 'VIOLATED'} "
              f"({g/1e6:.2f} <= {s/1e6:.2f} <= {z/1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
