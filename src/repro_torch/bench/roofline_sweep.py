"""§Roofline: the three-term table for every dry-run record under
``results/dryrun_torch`` (written by ``python -m
repro_torch.launch.dryrun --all --both-meshes``); the counterpart of
``benchmarks/roofline_sweep.py``.

Each record's port-model report is rebuilt from its ``portmodel`` field
and priced on the machine it was priced on (``h100`` by default), so
the compute and collective terms read that chip's rates
(``core.roofline.chip_rates``).
"""

from __future__ import annotations

import glob
import json

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import roofline
from repro_torch.core.machine import MACHINES
from repro_torch.core.report import Report

#: where the port's dry run writes its records
PATTERN = "results/dryrun_torch/*.json"


def report_of(pm: dict) -> Report:
    """A record's ``portmodel`` field as a :class:`Report`."""
    return Report(
        tp_cycles=pm["tp_cycles"], cp_cycles=pm["cp_cycles"],
        serial_cycles=pm["serial_cycles"],
        port_occupation=pm.get("top_ports", {}), flops=pm["flops"],
        bytes_hbm=pm["bytes_hbm"], coll_bytes=pm["coll_bytes"],
        n_instrs=pm["n_instrs"], unknown_ops=pm["unknown_ops"],
        trips_seen=pm.get("trips", {}),
        loop_bytes={k: tuple(v) for k, v in pm.get("loop_bytes", {}).items()})


def load_cells(pattern: str = PATTERN) -> list:
    """A :class:`~repro_torch.core.roofline.RooflineCell` for each record."""
    cells = []
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            rec = json.load(f)
        pm = rec.get("portmodel")
        machine = MACHINES[(pm or {}).get("machine", "h100")]
        cells.append(roofline.analyze_cell(
            rec, get_config(rec["arch"]), SHAPES[rec["shape"]],
            machine=machine, report=report_of(pm) if pm else None))
    return cells


def main(quick: bool = False, device: str = "cuda",
         pattern: str = PATTERN) -> list:
    """One CSV line a record (``roofline,<arch>.<shape>.<mesh>,<bound
    µs>,<terms>``); the records are read, nothing is measured, so
    ``device`` is unused."""
    del quick, device
    lines = []
    for c in sorted(load_cells(pattern), key=lambda c: (c.arch, c.shape,
                                                        c.mesh)):
        lines.append(
            f"roofline,{c.arch}.{c.shape}.{c.mesh},{c.bound*1e6:.0f},"
            f"Tc={c.t_compute*1e3:.2f}ms;Tc_port={c.t_compute_port*1e3:.2f}ms;"
            f"Tm={c.t_memory*1e3:.2f}ms;Tx={c.t_collective*1e3:.2f}ms;"
            f"dom={c.dominant};useful={c.useful_ratio:.2f};"
            f"peak_frac={c.peak_fraction:.3f};wa={c.wa_ratio:.2f}")
    if not lines:
        lines = ["roofline,no_records,0,run repro_torch.launch.dryrun first"]
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
