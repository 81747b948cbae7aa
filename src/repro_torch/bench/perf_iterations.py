"""§Perf hill climbing on the port's dry run: a baseline and
hypothesis-driven variants for the chosen cells, each lowered and priced
again (the counterpart of ``benchmarks/perf_iterations.py``).

  H1 yi-9b ``train_4k`` (memory-bound): the base, ``remat="dots"``, big
     attention chunks (q 2048, kv 4096).
  H2 qwen1.5-110b ``decode_32k`` (collective-bound): FSDP ``gather``,
     the same with a 16-token decode loop, ``resident2d``.
  H3 jamba ``train_4k``: the Mamba scan unfused (the decay and input
     materialized a step) and fused.
  H4 qwen3-moe ``train_4k``: fp32 and int8 AdamW moments.

Records land in ``results/perf_torch/<tag>.json`` (a record already
there is read, not lowered again). Run on the card's host (the mesh's
device type the card's) or with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.bench.perf_iterations \\
        [--cell H1|H2|H3|H4] [--report] [--trajectory PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

OUT = "results/perf_torch"


def terms(rec: dict) -> dict:
    """The record's three roofline terms on the machine it was priced on:
    FLOPs over the chip's bf16 peak, WA-adjusted HBM bytes over its
    memory rate, wire bytes over its links (``core.roofline.chip_rates``)."""
    from repro_torch.core.machine import MACHINES
    from repro_torch.core.roofline import chip_rates
    from repro_torch.utils.hw import HBM_BW
    pm = rec["portmodel"]
    machine = MACHINES[pm.get("machine", "h100")]
    peak, link, links = chip_rates(machine)
    hbm = machine.chip.hbm_bw if machine.chip is not None else HBM_BW
    t_c = pm["flops"] / peak
    t_m = pm["bytes_hbm"] * rec["wa_ratio"] / hbm
    t_x = sum(pm["coll_bytes"].values()) / (link * links)
    return {"T_comp_s": t_c, "T_mem_s": t_m, "T_coll_s": t_x,
            "bound_s": max(t_c, t_m, t_x),
            "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
            "flops": pm["flops"], "bytes": pm["bytes_hbm"],
            "coll": pm["coll_bytes"], "wa": rec["wa_ratio"]}


def run(tag: str, out: str = OUT, **kw) -> dict:
    """The record of one iteration: read from ``out`` or lowered
    (``launch.dryrun.run_cell``) and written there with its terms."""
    from repro_torch.launch.dryrun import run_cell
    path = os.path.join(out, tag + ".json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    rec = run_cell(**kw)
    rec["_terms"] = terms(rec)
    os.makedirs(out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def iterations(cell: str = "all") -> list:
    """``(tag, run_cell keywords)`` of each iteration of ``cell``."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import OptConfig
    out = []
    if cell in ("all", "H1"):
        cfg = get_config("yi-9b")
        kw = dict(arch="yi-9b", shape_name="train_4k")
        out += [("H1_base", dict(kw, cfg=cfg)),
                # hypothesis: T_comp(port) -25 % (no forward recompute of
                # the products), peak memory up
                ("H1_it2_remat_dots",
                 dict(kw, cfg=dataclasses.replace(cfg, remat="dots"))),
                # hypothesis (to refute): score traffic is invariant to
                # the chunk sizes
                ("H1_it3_bigchunks",
                 dict(kw, cfg=dataclasses.replace(cfg, q_chunk=2048,
                                                  kv_chunk=4096)))]
    if cell in ("all", "H2"):
        cfg = get_config("qwen1.5-110b")
        kw = dict(arch="qwen1.5-110b", shape_name="decode_32k", cfg=cfg)
        out += [("H2_base", dict(kw, serve_variant="gather")),
                # hypothesis: the per-layer weight gather is loop-invariant
                ("H2_it1_loop16", dict(kw, decode_loop=16,
                                       serve_variant="gather")),
                # hypothesis: resident 2-D weights trade the weight
                # gathers (GBs) for activation all-reduces (MBs)
                ("H2_it2_resident2d", dict(kw, serve_variant="resident2d"))]
    if cell in ("all", "H3"):
        cfg = get_config("jamba-v0.1-52b")
        kw = dict(arch="jamba-v0.1-52b", shape_name="train_4k")
        out += [("H3_base_unfused",
                 dict(kw, cfg=dataclasses.replace(cfg, ssm_fuse=False))),
                ("H3_it1_fused",
                 dict(kw, cfg=dataclasses.replace(cfg, ssm_fuse=True)))]
    if cell in ("all", "H4"):
        cfg = get_config("qwen3-moe-235b-a22b")
        kw = dict(arch="qwen3-moe-235b-a22b", shape_name="train_4k", cfg=cfg)
        out += [("H4_base", kw),
                ("H4_it1_int8_moments",
                 dict(kw, oc=OptConfig(moments_dtype="int8")))]
    return out


def run_cells(cell: str = "all", out: str = OUT,
              device_type: str = "cuda") -> int:
    """Run the iterations of ``cell``; returns how many failed."""
    failures = 0
    for tag, kw in iterations(cell):
        try:
            rec = run(tag, out, device_type=device_type, **kw)
            t = rec["_terms"]
            print(f"[ok]   {tag}: Tc={t['T_comp_s']:.3f}s "
                  f"Tm={t['T_mem_s']:.3f}s Tx={t['T_coll_s']:.3f}s "
                  f"peak={t['peak_gb']:.2f}GB", flush=True)
        except Exception as e:  # noqa: BLE001 — count, go on
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    return failures


def write_trajectory(path: str, out: str = OUT) -> dict:
    """Every record under ``out`` grouped by cell (the tag up to its
    first ``_``), each with its terms and its bound over the cell's
    base's; written as JSON to ``path`` and returned."""
    cells: dict = {}
    for rec_path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(rec_path) as f:
            rec = json.load(f)
        t = rec.get("_terms")
        if not t:
            continue
        tag = os.path.basename(rec_path)[:-5]
        cells.setdefault(tag.split("_", 1)[0], []).append(
            {"tag": tag, "terms": t})
    for iters in cells.values():
        base = next((i for i in iters if "base" in i["tag"]), iters[0])
        b = max(base["terms"]["bound_s"], 1e-12)
        for i in iters:
            i["bound_vs_base"] = i["terms"]["bound_s"] / b
    payload = {"version": 1, "format": "repro-perf-trajectory",
               "n_cells": len(cells),
               "n_iterations": sum(len(v) for v in cells.values()),
               "cells": cells}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"trajectory: {payload['n_iterations']} iterations over "
          f"{payload['n_cells']} cells -> {path}")
    return payload


def report(out: str = OUT) -> list:
    """One line of terms a record under ``out``; printed and returned."""
    lines = []
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        t = rec.get("_terms")
        if not t:
            continue
        tag = os.path.basename(path)[:-5]
        lines.append(f"{tag:28s} Tc={t['T_comp_s']:8.3f}s "
                     f"Tm={t['T_mem_s']:9.3f}s Tx={t['T_coll_s']:7.3f}s "
                     f"peak={t['peak_gb']:6.2f}GB wa={t['wa']:.2f}")
    print("\n".join(lines))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.perf_iterations")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--trajectory", default="")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.report:
        report(args.out)
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.bench.perf_iterations: no CUDA device; pass "
              "--device cpu", file=sys.stderr)
        return 2
    failures = run_cells(args.cell, args.out, args.device)
    if args.trajectory:
        write_trajectory(args.trajectory, args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
