"""Benchmark harness — one module per paper table/figure, on the port.

The counterpart of ``benchmarks/run.py``, with its CSV: prints
``name,us_per_call,derived`` lines, and each module ends with a
``_meta,<module>,<us>,ok|FAILED`` line. ``--only <tag>`` runs the modules
whose name holds the tag; ``--full`` runs the complete (slow) variants,
e.g. the 416-block Fig. 3 suite. The measured rows measure the CUDA card;
without one the runner refuses, unless ``--device cpu`` asks for the
host:

    python -m repro_torch.bench.run --only fig9 [--full]
    python -m repro_torch.bench.run --only fig4b --device cpu
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

MODULES = ("table1_machines", "table2_ports", "table3_instructions",
           "fig2_unitmix", "fig3_rpe", "fig4_wa", "fig4b_ntstore",
           "fig5_memladder", "fig6_serve", "fig7_decode", "fig8_paged",
           "fig9_load", "fig10_chaos")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run")
    ap.add_argument("--only", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the measured rows run on (default: cuda; "
                         "the host only when asked with --device cpu)")
    args = ap.parse_args(argv)
    import torch
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("repro_torch.bench.run: no CUDA device; pass --device cpu to "
              "measure the host", file=sys.stderr)
        return 2

    print("name,us_per_call,derived")
    failures = 0
    for mod_name in MODULES:
        if args.only and args.only not in mod_name:
            continue
        t0 = time.time()
        try:
            mod = importlib.import_module(f"repro_torch.bench.{mod_name}")
            for ln in mod.main(quick=not args.full, device=args.device):
                print(ln, flush=True)
            print(f"_meta,{mod_name},{(time.time()-t0)*1e6:.0f},ok",
                  flush=True)
        except Exception:
            failures += 1
            traceback.print_exc()
            print(f"_meta,{mod_name},{(time.time()-t0)*1e6:.0f},FAILED",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
