"""Eager prefill and decode forwards of yi-9b at its published width
(48 layers, bf16, random weights from a seed) on the card, with no mesh:
the unsharded main path, timed end to end (host issue and device work,
each call closed by a synchronize). ``--device cpu`` times the host
alone: yi-9b's smoke widths at the same 48 layers, where the Python a
layer costs shows beside little compute.

The package it times is the one on ``PYTHONPATH``, so one script
compares two trees of the port on the same card; run them interleaved
in one run, e.g. parent, change, change, parent:

    PYTHONPATH=/path/to/other/src python scripts/eager_forward_ab.py \\
        --label parent
    PYTHONPATH=src python scripts/eager_forward_ab.py --label change \\
        [--reps 10]

Prints the card's name and power limit, then one JSON line: the label,
the package's path, and per forward the median and every rep's ms and
the Python function calls one call makes (``cProfile``'s count, after
the timed reps: the host work a forward costs, whatever the noise).
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import statistics
import subprocess
import time

BATCH, PROMPT, CACHE_LEN = 8, 256, 384
WARM = 2


def timed(torch, fn, reps: int, dev: str) -> list:
    """ms of each of ``reps`` calls of ``fn`` after ``WARM`` warm-ups."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    for _ in range(WARM):
        fn()
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def python_calls(fn) -> int:
    """Python function calls of one ``fn()``, as ``cProfile`` counts."""
    prof = cProfile.Profile()
    prof.runcall(fn)
    return pstats.Stats(prof).total_calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("eager_forward_ab: no CUDA device")
        return 2
    import repro_torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import serve as serve_lib
    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        cfg = get_config("yi-9b")
    else:
        torch.set_num_threads(1)
        cfg = dataclasses.replace(get_smoke_config("yi-9b"), n_layers=48)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    prefill = serve_lib.make_prefill_step(cfg, cache_len=CACHE_LEN)
    logits, cache = prefill(params, {"tokens": toks})
    tok = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev)

    def decode():
        # rewrites row PROMPT of every slot each call: the same work
        M.forward(cfg, params, {"tokens": tok}, mode="decode", cache=cache,
                  pos=pos, kv_len=CACHE_LEN)
    rec = {"label": args.label, "device": dev,
           "package": repro_torch.__file__}
    for name, fn in (("prefill", lambda: prefill(params, {"tokens": toks})),
                     ("decode", decode)):
        ms = timed(torch, fn, args.reps, dev)
        rec[name] = {"median_ms": statistics.median(ms), "ms": ms,
                     "py_calls": python_calls(fn)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
