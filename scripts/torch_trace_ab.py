#!/usr/bin/env python3
"""Parent against change: a full-width yi-9b decode step on one card,
dense and paged, each checkout in a process of its own.

Run from the repository root of the change on a machine with the card
and ``nvcc``, with a checkout of the parent commit unpacked somewhere
(``git archive <parent> | tar -x -C <dir>``):

    python3 scripts/torch_trace_ab.py <dir>

Each run imports ``repro_torch`` from one checkout's ``src`` (its
kernels built from that checkout's ``csrc``), builds chip_smoke's
engines (yi-9b at full width, random weights from seed 0, 8 slots, a
2048-row horizon, 8-token chunks; the paged one with pages of 16 and
320 pages) and measures each with the change's ``chip_smoke.phase_trace``:
device busy ms a step, kernel launches a step, wall ms a step and the
idle share, over the same 8 requests. The runs go parent, change,
change, parent, and every line is printed with its side.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(src: str) -> int:
    """Both traces with ``repro_torch`` from ``src``."""
    sys.path[:0] = [ROOT, src]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import configs, serve
    from repro_torch.models import model as M

    cfg = configs.get_config("yi-9b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    rng = np.random.default_rng(5)
    reqs = [serve.Request(f"r{i}", tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, n)), 64)
        for i, n in enumerate(rng.integers(128, 513, size=8))]
    eng = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048, chunk=8,
                            device="cuda")
    chip_smoke.phase_trace(torch, serve, eng, reqs, "trace")
    del eng
    torch.cuda.empty_cache()
    peng = serve.PagedServeEngine(cfg, params, page_size=16, n_pages=320,
                                  max_slots=8, max_len=2048, chunk=8,
                                  device="cuda")
    chip_smoke.phase_trace(torch, serve, peng, chip_smoke.paged_requests(
        np, serve, cfg.vocab_size, 8, 5, 256, 256, 64), "paged trace")
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        return one(sys.argv[2])
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    srcs = {"parent": os.path.join(os.path.abspath(sys.argv[1]), "src"),
            "change": os.path.join(ROOT, "src")}
    for side in ("parent", "change", "change", "parent"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", srcs[side]], capture_output=True,
                             text=True)
        for line in run.stdout.splitlines():
            if "trace" in line:
                print(f"{side}: {line}")
        if run.returncode != 0:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
