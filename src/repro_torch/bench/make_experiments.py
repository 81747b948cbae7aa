"""Regenerate the data-driven tables of an experiments document from the
port's records; the counterpart of ``benchmarks/make_experiments.py``.

Replaces the blocks between ``<!--GEN:<name>-->`` and ``<!--END:<name>-->``
markers (``dryrun``, ``roofline``, ``fig3``, ``perf``) in the document at
``doc``, which is made with all four blocks when it does not exist:

    PYTHONPATH=src python -m repro_torch.bench.make_experiments \\
        --doc results/EXPERIMENTS_torch.md

It reads ``results/dryrun_torch`` (the dry run), ``results/perf_torch``
(``bench.perf_iterations``) and ``results/torch_rpe_records.json``
(``bench.fig3_rpe``), never the JAX package's directories.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

DOC = "results/EXPERIMENTS_torch.md"
DRYRUN_DIR = "results/dryrun_torch"
PERF_DIR = "results/perf_torch"
RPE_PATH = "results/torch_rpe_records.json"
BLOCKS = ("dryrun", "roofline", "fig3", "perf")


def gen_dryrun(dryrun_dir: str = DRYRUN_DIR) -> str:
    rows = ["| arch | shape | mesh | peak GB/dev | args+out GB/dev | "
            "flops/dev (model) | lower s |",
            "|---|---|---|---|---|---|---|"]
    for path in sorted(glob.glob(f"{dryrun_dir}/*.json")):
        with open(path) as f:
            r = json.load(f)
        m = r["memory"]
        steady = (m["argument_bytes"] + m["output_bytes"] -
                  m["alias_bytes"]) / 1e9
        pm = r.get("portmodel", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {m['peak_bytes']/1e9:.2f} | {steady:.2f} "
            f"| {pm.get('flops', 0):.3e} | {r['lower_s']:.0f} |")
    return "\n".join(rows)


def gen_roofline(dryrun_dir: str = DRYRUN_DIR) -> str:
    from repro_torch.bench.roofline_sweep import load_cells
    cells = load_cells(f"{dryrun_dir}/*.json")
    rows = ["| arch | shape | mesh | T_comp | T_comp(port) | T_mem | T_coll "
            "| dominant | MF/HLO | peak-frac | next lever |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    lever = {
        "memory": "flash-attn kernel / fusion (see §Perf H1)",
        "compute(port)": "tensor-core utilization (bigger per-card batch)",
        "collective": "resident-2D serve / compressed grads (§Perf H2)",
    }
    for c in sorted(cells, key=lambda c: (c.arch, c.shape, c.mesh)):
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {c.t_compute*1e3:.1f}ms "
            f"| {c.t_compute_port*1e3:.1f}ms | {c.t_memory*1e3:.1f}ms "
            f"| {c.t_collective*1e3:.1f}ms | {c.dominant} "
            f"| {c.useful_ratio:.2f} | {c.peak_fraction:.1%} "
            f"| {lever.get(c.dominant, '-')} |")
    return "\n".join(rows)


def gen_fig3(rpe_path: str = RPE_PATH) -> str:
    if not os.path.exists(rpe_path):
        return "(fig3 records not yet generated)"
    from repro_torch.core import rpe
    recs = rpe.load_records(rpe_path)
    s = rpe.summarize(recs)
    out = []
    for model in ("port_model", "mca_sched", "naive_baseline"):
        st = s[model]
        if not st:
            out.append(f"- **{model}**: (no finite records)")
            continue
        out.append(f"- **{model}**: n={st['n']}, "
                   f"right-of-zero {st['right_of_zero_pct']:.0f}%, "
                   f"within +10% {st['within10_pct']:.0f}%, "
                   f"within +20% {st['within20_pct']:.0f}%, "
                   f">2x off {st['factor2_off']}, "
                   f"mean under-prediction RPE "
                   f"{st['mean_underpred_rpe']:.2f}")
    for key, name in (("port", "port-model"), ("naive", "naive-baseline")):
        h = rpe.histogram(recs, key)
        out.append(f"- {name} histogram: " +
                   " ".join(f"{k}:{v}" for k, v in h.items()))
    return "\n".join(out)


def gen_perf(perf_dir: str = PERF_DIR) -> str:
    rows = ["| iteration | T_comp | T_mem | T_coll | peak GB/dev |",
            "|---|---|---|---|---|"]
    for path in sorted(glob.glob(f"{perf_dir}/H*.json")):
        with open(path) as f:
            r = json.load(f)
        t = r.get("_terms")
        if not t:
            continue
        tag = os.path.basename(path)[:-5]
        rows.append(f"| {tag} | {t['T_comp_s']:.2f}s | {t['T_mem_s']:.2f}s "
                    f"| {t['T_coll_s']:.3f}s | {t['peak_gb']:.2f} |")
    return "\n".join(rows)


def main(doc: str = DOC, dryrun_dir: str = DRYRUN_DIR,
         perf_dir: str = PERF_DIR, rpe_path: str = RPE_PATH) -> str:
    """Regenerate the blocks of ``doc`` in place; returns its text."""
    if os.path.exists(doc):
        with open(doc) as f:
            text = f.read()
    else:
        text = "# Experiments (the PyTorch port)\n\n" + "\n\n".join(
            f"## {b}\n\n<!--GEN:{b}-->\n<!--END:{b}-->" for b in BLOCKS) \
            + "\n"
    gens = {"dryrun": lambda: gen_dryrun(dryrun_dir),
            "roofline": lambda: gen_roofline(dryrun_dir),
            "fig3": lambda: gen_fig3(rpe_path),
            "perf": lambda: gen_perf(perf_dir)}
    for name, gen in gens.items():
        pat = re.compile(rf"(<!--GEN:{name}-->).*?(<!--END:{name}-->)", re.S)
        if pat.search(text):
            text = pat.sub(lambda m, g=gen: m.group(1) + "\n" + g() + "\n"
                           + m.group(2), text)
    os.makedirs(os.path.dirname(doc) or ".", exist_ok=True)
    with open(doc, "w") as f:
        f.write(text)
    print(f"{doc} tables regenerated from {dryrun_dir} and {perf_dir}")
    return text


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.make_experiments")
    ap.add_argument("--doc", default=DOC)
    ap.add_argument("--dryrun-dir", default=DRYRUN_DIR)
    ap.add_argument("--perf-dir", default=PERF_DIR)
    a = ap.parse_args()
    main(a.doc, a.dryrun_dir, a.perf_dir)
