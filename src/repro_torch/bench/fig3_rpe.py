"""Paper Fig. 3: RPE histograms — both in-core prediction engines
(analytical ``tp_bound`` port model and the ``mca_sched`` cycle
simulator, the OSACA-vs-LLVM-MCA comparison) vs the naive roofline
baseline over the validation suite, on the port (``core/rpe.py``).

Default (quick): 13 kernels x 2 variants (eager, loop) x 2 sizes (S, L) =
52 blocks. --full: 13 x 8 x 4 = 416 blocks (the paper's count). Each
block is measured once on the device and predicted on each machine: the
device's calibrated model (``host_cpu``; on the card ``h100_measured``)
and, on the card, the spec-derived ``h100`` too. Records are cached per
machine (``results/torch_rpe_records.json`` for the calibrated model,
``results/torch_rpe_records.<machine>.json`` for another), so reruns are
incremental; a failed block is retried on the next run, never cached,
and counted in the ``nan_records`` line.
"""

from __future__ import annotations

import math
import os
import sys

import torch

from repro_torch.core import rpe
from repro_torch.kernels.stream.ref import KERNELS_13

CACHE = "results/torch_rpe_records.json"


def machines_for(device) -> tuple:
    """The machines a device's blocks are predicted on."""
    primary = rpe.default_machine(device).name
    if torch.device(device).type == "cuda":
        return (primary, "h100")
    return (primary,)


def cache_path(machine: str, primary: str, cache: str = CACHE) -> str:
    """The cache file of one machine's records."""
    if machine == primary:
        return cache
    root, ext = os.path.splitext(cache)
    return f"{root}.{machine}{ext}"


def _complete(r) -> bool:
    """A cache entry counts as done only when its measurement and its
    simulator prediction are finite."""
    return math.isfinite(r.t_meas) and math.isfinite(r.t_mca)


def run(full: bool = False, cache: str = CACHE, device="cuda",
        machines=None) -> dict:
    """Run (or resume) the Fig. 3 grid (``rpe.run_suite``); returns
    {machine: records}."""
    variants = rpe.VARIANTS if full else ("eager", "loop")
    sizes = tuple(rpe.sizes_for(device)) if full else ("S", "L")
    machines = tuple(machines or machines_for(device))
    primary = machines[0]
    done = {m: {} for m in machines}
    for m in machines:
        path = cache_path(m, primary, cache)
        if os.path.exists(path):
            for r in rpe.load_records(path):
                if _complete(r):
                    done[m][(r.kernel, r.variant, r.size)] = r
    ran = []

    def cached(key):
        if all(key in done[m] for m in machines):
            return [done[m][key] for m in machines]
        return None

    def progress(key, recs):
        for m, r in zip(machines, recs):
            if _complete(r):
                done[m][key] = r
                ran.append(key)
    out = rpe.run_suite(KERNELS_13, variants, sizes, progress, machines,
                        device, cached)
    if ran:
        for m in machines:
            rpe.save_records(sorted(done[m].values(), key=lambda r: (
                r.kernel, r.variant, r.size)), cache_path(m, primary, cache))
    return out


def summary_lines(records: list, tag: str = "") -> list:
    """The fig3 CSV lines of one machine's records: per-engine summaries
    and histograms."""
    s = rpe.summarize(records)
    pre = f"fig3{tag}"
    lines = []
    for model in ("port_model", "mca_sched", "naive_baseline"):
        st = s[model]
        if not st:          # every block failed — degrade, don't crash
            lines.append(f"{pre},{model},0,no_finite_records")
            continue
        lines.append(
            f"{pre},{model},0,"
            f"n={st['n']};right_of_zero={st['right_of_zero_pct']:.0f}%;"
            f"within10={st['within10_pct']:.0f}%;"
            f"within20={st['within20_pct']:.0f}%;"
            f"factor2_off={st['factor2_off']};"
            f"mean_rpe={st['mean_rpe']:.2f};"
            f"mean_underpred={st['mean_underpred_rpe']:.2f}")
    for which in ("port", "mca", "naive"):
        h = rpe.histogram(records, which)
        lines.append(f"{pre},hist_{which},0," +
                     ";".join(f"{k}:{v}" for k, v in h.items()))
    return lines


def main(quick: bool = True, device="cuda"):
    """Emit the fig3 CSV lines: the calibrated model's memory rates (per
    core or SM / shared), per machine the per-backend summaries and
    histograms and the count of NaN records, and the kernels whose
    ``kernel`` variant runs plain."""
    by_machine = run(full=not quick, device=device)
    m = rpe.default_machine(device)
    lines = [f"fig3,calibration,0,machine={m.name};"
             f"dma_gbs={m.clock_hz / m.table['dma'].cycles_per_unit / 1e9:.1f};"
             + ";".join(f"{t.name}={t.load_bw / 1e9:.1f}/"
                        f"{t.shared_bw / 1e9:.1f}GB/s"
                        for t in m.mem_tiers if t.shared_bw > 0)]
    for m, records in by_machine.items():
        lines += summary_lines(records, f"[{m}]")
        lines.append(f"fig3[{m}],nan_records,0,"
                     f"{len(rpe.nan_records(records))}")
    lines.append("fig3,kernel_variant_runs_plain,0,"
                 + ";".join(rpe.PLAIN_KERNELS))
    return lines


if __name__ == "__main__":
    print("\n".join(main(quick="--full" not in sys.argv)))
