"""Fig. 5 (extension): cache/memory-ladder sweep across the paper CPUs,
on the port.

The counterpart of ``benchmarks/fig5_memladder.py``: pure pricing, the
same rows and gate, plus the card's own ladder (``h100``) priced at the
same working sets and reported beside them, outside the gate.

A STREAM-triad-shaped traffic profile (2 bytes loaded : 1 byte stored
per byte of working set) is swept over working sets that resolve to
each level of every machine's memory ladder (core/memtier.py). Per
machine and per working set the table reports the home tier, the
effective load/store bandwidth of the bottleneck leg, the WA-adjusted
store traffic, and the composed ECM memory term.

The paper's qualitative WA result must survive tier resolution: the
WA-adjusted store traffic obeys Grace <= SPR <= Zen 4 at *every* tier
(Grace claims lines at every level; SpecI2M only helps SPR at a
saturated DRAM interface; Zen 4 standard stores always allocate). The
sweep asserts the ordering per working set and emits a verdict row.
"""

from __future__ import annotations

from repro_torch.core import memtier
from repro_torch.core.machine import get_machine

#: The three paper CPUs, innermost ordering of the WA comparison.
CPUS = ("neoverse_v2", "golden_cove", "zen4")

#: Working-set points chosen to land on L1 / L2 / L3 / DRAM for all
#: three CPUs at once (capacities differ, so points sit inside the
#: smallest respective level: Zen 4 L1 32 KiB, L2 1 MiB, L3 32 MiB).
SWEEP = (
    ("L1", 16 * 1024),
    ("L2", 256 * 1024),
    ("L3", 8 * 2**20),
    ("DRAM", 1 << 30),
)


#: the card's machine file, priced beside the CPUs and not gated
CARD = "h100"


def ladder_rows(nt_stores: bool = False, machines=CPUS) -> list:
    """One dict per (working set, machine): the fig5 ladder table.

    `store_traffic` is the WA-adjusted store traffic crossing the home
    tier's boundary for 1 byte of stored payload per 3 bytes of working
    set (the triad mix), so rows are comparable across machines.
    """
    rows = []
    for label, ws in SWEEP:
        for name in machines:
            m = get_machine(name)
            loads, stores = 2.0 * ws, 1.0 * ws
            res = memtier.transfer_time(
                m, ws_bytes=ws, load_bytes=loads, store_bytes=stores,
                nt_stores=nt_stores, cores_active=m.cores)
            home_leg = res.legs[-1]
            rows.append({
                "ws_label": label, "ws_bytes": ws, "machine": name,
                "home": res.home, "bottleneck": res.bottleneck_tier,
                "saturation": res.saturation,
                "load_bw": home_leg.load_bw, "store_bw": home_leg.store_bw,
                "wa_ratio": home_leg.wa_ratio,
                "store_traffic": home_leg.store_bytes,
                "ecm_seconds": res.seconds,
            })
    return rows


def ordering_ok(rows: list) -> dict:
    """{ws_label: bool} — Grace <= SPR <= Zen 4 store traffic per tier."""
    verdict = {}
    by_ws: dict = {}
    for r in rows:
        by_ws.setdefault(r["ws_label"], {})[r["machine"]] = r
    for label, per_m in by_ws.items():
        t = {n: per_m[n]["store_traffic"] for n in CPUS if n in per_m}
        verdict[label] = (
            len(t) == len(CPUS)
            and t["neoverse_v2"] <= t["golden_cove"] <= t["zen4"])
    return verdict


def main(quick: bool = False, device="cuda"):
    """Emit the fig5 ladder table as benchmark CSV lines (pure pricing:
    ``device`` is not used)."""
    lines = []
    rows = ladder_rows()
    for r in rows + ladder_rows(machines=(CARD,)):
        lines.append(
            f"fig5,{r['machine']}.{r['ws_label']},"
            f"{r['ecm_seconds']*1e6:.1f},"
            f"home={r['home']};bneck={r['bottleneck']};"
            f"sat={r['saturation']:.2f};"
            f"ld_bw={r['load_bw']/1e9:.1f}GB/s;"
            f"st_bw={r['store_bw']/1e9:.1f}GB/s;"
            f"wa={r['wa_ratio']:.2f};"
            f"st_traffic={r['store_traffic']/1e6:.1f}MB")
    verdicts = ordering_ok(rows)
    for label, ok in verdicts.items():
        lines.append(f"fig5,ordering_{label},0,"
                     f"grace<=spr<=zen4={'OK' if ok else 'VIOLATED'}")
    if not quick:
        # NT-store variant: Zen 4 evades fully, the ordering inverts at
        # DRAM — reported for completeness, not asserted
        for r in ladder_rows(nt_stores=True):
            lines.append(
                f"fig5,nt.{r['machine']}.{r['ws_label']},"
                f"{r['ecm_seconds']*1e6:.1f},"
                f"wa={r['wa_ratio']:.2f};"
                f"st_traffic={r['store_traffic']/1e6:.1f}MB")
    if not all(verdicts.values()):
        raise AssertionError(f"WA ladder ordering violated: {verdicts}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
