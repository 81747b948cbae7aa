"""Benchmark harness — one module per paper table/figure, on the port.

The counterpart of ``benchmarks/run.py``, with its CSV: prints
``name,us_per_call,derived`` lines, and each module ends with a
``_meta,<module>,<us>,ok|FAILED`` line. ``--only <tag>`` runs the modules
whose name holds the tag; ``--full`` runs the complete (slow) variants,
e.g. the 416-block Fig. 3 suite, or fig11's 15 timed pairs for 9;
``roofline_sweep`` reads the dry run's records (``results/dryrun_torch``,
``python -m repro_torch.launch.dryrun``) and measures nothing. The
measured rows measure the CUDA card; without one the runner refuses,
unless ``--device cpu`` asks for the host:

    python -m repro_torch.bench.run --only fig9 [--full]
    python -m repro_torch.bench.run --only fig4b --device cpu

Under a launcher of several ranks (``torchrun --nproc-per-node N``; fig9
shards its replicas over them) every rank runs the modules and rank 0
alone prints.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import traceback

MODULES = ("table1_machines", "table2_ports", "table3_instructions",
           "fig2_unitmix", "fig3_rpe", "fig4_wa", "fig4b_ntstore",
           "fig5_memladder", "fig6_serve", "fig7_decode", "fig8_paged",
           "fig9_load", "fig10_chaos", "fig11_overlap", "roofline_sweep")


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

    say("name,us_per_call,derived")
    failures = 0
    for mod_name in MODULES:
        if args.only and args.only not in mod_name:
            continue
        t0 = time.time()
        try:
            mod = importlib.import_module(f"repro_torch.bench.{mod_name}")
            for ln in mod.main(quick=not args.full, device=args.device):
                say(ln)
            say(f"_meta,{mod_name},{(time.time()-t0)*1e6:.0f},ok")
        except Exception:
            failures += 1
            traceback.print_exc()
            say(f"_meta,{mod_name},{(time.time()-t0)*1e6:.0f},FAILED")
    return 1 if failures else 0


def say(line: str) -> None:
    """Print ``line`` on rank 0 of the world (its process group, else the
    ``RANK`` a launcher sets); a single process is rank 0."""
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() \
        else int(os.environ.get("RANK", "0"))
    if rank == 0:
        print(line, flush=True)


if __name__ == "__main__":
    sys.exit(main())
