"""§Roofline: three-term analysis of one priced step.

    compute term    = FLOPs / peak FLOP/s of the machine's chip
    memory term     = tier-resolved ECM ladder term [WA/RMW-adjusted]
    collective term = wire bytes / the chip's link rate

The counterpart of ``repro/core/roofline.py``, taking a port
:class:`~repro_torch.core.report.Report` (an ATen trace priced by
``portmodel.analyze``) in place of HLO text. The reference prices every
machine's compute and collective terms at the v5e's figures
(``utils.hw.PEAK_FLOPS`` and ``ICI_BW``); here both read the machine's
own chip: its dense bf16 rate and its link rate (a TPU's ICI links, a
GPU's NVLink, one direction's half of the published both-ways rate, as
the ``h100`` file's ``ici`` class). On ``tpu_v5e`` that is the
reference's arithmetic; a machine without a chip (the CPU files) keeps
the v5e's figures, as the reference does for every machine.

The memory term resolves the WA-adjusted traffic against the machine's
memory ladder (core/memtier.py), which degrades to the flat HBM number
for working sets that resolve to the backing tier. The in-core port
model supplies a *tighter* compute bound (``t_compute_port``) than
flops/peak — the paper's model used "as part of holistic performance
models such as Roofline" (paper §I.A).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import memtier
from repro_torch.core.machine import MACHINES, MachineModel
from repro_torch.core.report import Report
from repro_torch.utils.hw import ICI_BW, PEAK_FLOPS, GpuSpec


@dataclasses.dataclass
class RooflineCell:
    """Roofline terms + accounting for one (arch, shape, mesh) cell."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device terms, seconds
    t_compute: float
    t_memory: float
    t_collective: float
    t_compute_port: float         # port-model in-core bound (>= t_compute)
    dominant: str
    # accounting (per device)
    flops: float
    bytes_hbm: float
    coll_bytes: dict
    wa_ratio: float
    # usefulness
    model_flops: float            # 6*N*D (global)
    useful_ratio: float           # model_flops / (flops * n_devices)
    bottleneck_port: str
    peak_fraction: float          # (model_flops/chips/peak) / bound
    notes: str = ""
    # memory-ladder resolution (core/memtier.py)
    bottleneck_tier: str = "HBM"  # slowest transfer leg of the ladder
    home_tier: str = "HBM"        # tier the working set resolves to

    @property
    def bound(self) -> float:
        """The roofline bound: slowest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)


def collective_seconds(coll_bytes: dict, ici_bw: float = ICI_BW,
                       links: int = 4) -> float:
    """Wire bytes already include ring factors (isa.py); a chip moves its
    share over `links` links in parallel for ring algorithms."""
    total = sum(coll_bytes.values())
    return total / (ici_bw * links)


def chip_rates(machine: MachineModel) -> tuple:
    """``(peak FLOP/s, link bytes/s, links)`` of the compute and
    collective terms on ``machine``: its chip's dense bf16 rate; a TPU's
    ICI link rate over 4 links, a GPU's NVLink one direction over 1; the
    v5e's figures for a machine without a chip."""
    chip = machine.chip
    if isinstance(chip, GpuSpec):
        return chip.bf16_flops, chip.nvlink_bw / 2.0, 1
    if chip is not None:
        return chip.bf16_flops, chip.ici_link_bw, 4
    return PEAK_FLOPS, ICI_BW, 4


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode counts one
    token per sequence, prefill counts forward-only (2*N*D)."""
    from repro_torch.models.model import count_params
    n = count_params(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch            # one step
    return 2.0 * n * tokens


def analyze_cell(rec: dict, cfg, shape, trace=None,
                 machine: MachineModel | None = None,
                 report: Report | None = None) -> RooflineCell:
    """Build the roofline row for one record.

    rec: ``{"arch", "shape", "mesh", "n_devices", "cost": {"flops",
    "bytes_accessed"}, "collectives", "wa_ratio"}``, the JAX package's
    dry-run record. ``trace`` (a lowered ``core.trace.Trace``) or
    ``report`` gives the port-model accounting; without either the
    record's raw counts are used (documented as under-counting loops).
    """
    machine = machine or MACHINES["tpu_v5e"]
    chips = rec["n_devices"]
    if report is None and trace is not None:
        from repro_torch.core import portmodel
        report = portmodel.analyze(trace, machine)

    if report is not None:
        flops = report.flops
        bytes_hbm = report.bytes_hbm
        coll = report.coll_bytes
        t_port = report.seconds(machine)
        port = report.bottleneck()
    else:
        flops = rec["cost"]["flops"]
        bytes_hbm = rec["cost"]["bytes_accessed"]
        coll = {k: v["bytes"] for k, v in rec.get("collectives", {}).items()}
        t_port = 0.0
        port = "n/a"

    peak, link_bw, links = chip_rates(machine)
    wa_ratio = rec.get("wa_ratio", 1.0)
    t_c = flops / peak
    # tier-resolved memory term: the record's WA ratio is already folded
    # into the traffic (store_frac=0 keeps the ladder from re-applying
    # its own per-tier WA model on top)
    res = memtier.memory_seconds(machine, bytes_hbm * wa_ratio,
                                 store_frac=0.0)
    t_m = res.seconds
    t_x = collective_seconds(coll, link_bw, links)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    if t_port > t_c and t_port >= max(t_m, t_x):
        dominant = "compute(port)"
    else:
        dominant = max(terms, key=terms.get)

    mf = model_flops_for(cfg, shape)
    useful = mf / max(flops * chips, 1.0)
    bound = max(t_c, t_m, t_x, t_port)
    ideal = mf / chips / peak
    return RooflineCell(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        n_devices=chips, t_compute=t_c, t_memory=t_m, t_collective=t_x,
        t_compute_port=t_port, dominant=dominant, flops=flops,
        bytes_hbm=bytes_hbm, coll_bytes=dict(coll), wa_ratio=wa_ratio,
        model_flops=mf, useful_ratio=useful, bottleneck_port=port,
        peak_fraction=ideal / bound if bound > 0 else 0.0,
        bottleneck_tier=res.bottleneck_tier, home_tier=res.home)


def to_markdown(cells: list) -> str:
    """Render roofline cells as a GitHub-flavored markdown table."""
    hdr = ("| arch | shape | mesh | T_comp | T_comp(port) | T_mem | T_coll "
           "| dominant | tier | MF/HLO | peak-frac |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {c.t_compute*1e3:.2f}ms "
            f"| {c.t_compute_port*1e3:.2f}ms | {c.t_memory*1e3:.2f}ms "
            f"| {c.t_collective*1e3:.2f}ms | {c.dominant} "
            f"| {c.bottleneck_tier} "
            f"| {c.useful_ratio:.2f} | {c.peak_fraction:.1%} |")
    return hdr + "\n".join(rows)
