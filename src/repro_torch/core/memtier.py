"""Multi-tier memory-hierarchy (ECM-style) model with WA-aware ladders.

The in-core port model (``core/portmodel.py``) assumes operands are
resident next to the core; everything else is the memory hierarchy's
problem. This module models that problem in the Execution-Cache-Memory
(ECM) tradition of Hofmann et al.'s generational Intel analysis
(arXiv:1702.07554): a working set is *resolved* to its home tier (the
innermost cache level that holds it), and the time of a loop's memory
traffic is composed from the per-tier transfer legs between the core
and that home tier.

Two compositions are offered:

* ``overlap="none"`` — classic pessimistic ECM: the legs serialize, the
  memory term is the *sum* of leg times. Right for in-order-ish
  machines and single-buffered transfers.
* ``overlap="full"`` — all legs stream concurrently (hardware
  prefetchers on the paper CPUs, double-buffered DMA on TPUs): the
  memory term is the *max* leg time. This is the default, and it makes
  a DRAM-resident working set degrade exactly to the familiar flat
  ``bytes / mem_bw`` roofline term.

Write-allocate awareness: each :class:`repro_torch.utils.hw.MemTier` carries a
``wa_residue`` — the allocate-read traffic fraction that survives when
the machine's WA-evasion mechanism engages at that boundary (CloverLeaf
WA-evasion study, arXiv:2311.04797). The per-tier store traffic is the
Fig. 4 behavioural model (``core/wa.py``) evaluated with that residue
and with the *modeled* interface saturation at the home tier, so
SpecI2M on `golden_cove` engages only when the ladder says the memory
interface actually saturates — not at a caller-supplied constant gate.

A copy of ``repro/core/memtier.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.machine import MachineModel, get_machine
from repro_torch.utils.hw import MemTier


def tiers_of(machine) -> tuple:
    """The MemTier ladder of a machine (model or registered name).

    Machines registered without tiers (e.g. ad-hoc test models) get a
    single flat DRAM tier synthesized from their `dma` entry so every
    consumer can assume a non-empty ladder.
    """
    m = get_machine(machine) if isinstance(machine, str) else machine
    tiers = getattr(m, "mem_tiers", ()) or ()
    if tiers:
        return tuple(tiers)
    return (_fallback_dram(m),)


def _fallback_dram(m: MachineModel) -> MemTier:
    """Synthesize a flat DRAM tier from a model's `dma` byte rate.

    The residue is 0 because a measured/declared `dma` rate already
    reflects whatever allocate traffic the machine generates — charging
    WA on top would double-count it.
    """
    entry = m.table.get("dma")
    bw = m.clock_hz / entry.cycles_per_unit if entry is not None else 1e10
    return MemTier("DRAM", math.inf, bw, bw, shared_bw=bw, wa_residue=0.0)


def resolve_home(tiers, ws_bytes: float) -> MemTier:
    """The innermost tier whose capacity holds ``ws_bytes``.

    Zero-capacity tiers (a machine file may publish a disabled level,
    e.g. a host model with no discernible L3 plateau) are skipped: they
    can never be a home tier, and :func:`ladder` drops them from the
    transfer legs too. Working sets larger than every finite tier
    resolve to the last tier, which by convention is the backing
    DRAM/HBM level.
    """
    home = None
    for t in tiers:
        if t.capacity_bytes <= 0:
            continue
        home = t
        if ws_bytes <= t.capacity_bytes:
            break
    if home is None:
        raise ValueError("machine has no usable memory tiers")
    return home


def ladder(tiers, ws_bytes: float) -> tuple:
    """The transfer legs for a working set: every non-empty tier from
    the innermost level down to (and including) its home tier."""
    home = resolve_home(tiers, ws_bytes)
    legs = []
    for t in tiers:
        if t.capacity_bytes <= 0:
            continue
        legs.append(t)
        if t is home:        # identity: tier names need not be unique
            break
    return tuple(legs)


def effective_bw(tier: MemTier, cores_active: int = 1) -> tuple:
    """(load, store) bytes/s of one tier with ``cores_active`` cores.

    Private tiers scale linearly with cores; shared tiers saturate at
    their socket ceiling (load and store share it proportionally).
    """
    c = max(1, int(cores_active))
    ld, st = tier.load_bw * c, tier.store_bw * c
    if tier.shared_bw > 0:
        cap = tier.shared_bw
        ld, st = min(ld, cap), min(st, cap)
    return ld, st


def modeled_saturation(machine, ws_bytes: float,
                       cores_active: int | None = None) -> float:
    """Modeled interface saturation of a working set's home tier, 0..1.

    This is the gate `saturation_gated` WA evasion (SPR SpecI2M) needs:
    demanded bandwidth (active cores each sustaining their single-core
    rate) against the home tier's shared ceiling. Private tiers scale
    with the cores driving them, so their interface never saturates and
    the function returns 0.0 — SpecI2M correctly stays dormant for
    cache-resident working sets.
    """
    m = get_machine(machine) if isinstance(machine, str) else machine
    home = resolve_home(tiers_of(m), ws_bytes)
    if home.shared_bw <= 0:
        return 0.0
    cores = cores_active if cores_active is not None \
        else (getattr(m, "cores", 0) or 1)
    demand = max(1, int(cores)) * (home.load_bw + home.store_bw)
    return max(0.0, min(1.0, demand / home.shared_bw))


@dataclasses.dataclass(frozen=True)
class TierLeg:
    """One transfer leg of a resolved ladder."""

    tier: str                 # tier name
    seconds: float            # time this leg needs for the traffic
    load_bytes: float         # demand loads crossing this boundary
    store_bytes: float        # WA-adjusted store traffic at this leg
    wa_ratio: float           # store traffic / stored payload here
    load_bw: float            # effective bytes/s used for the load term
    store_bw: float


@dataclasses.dataclass(frozen=True)
class TierResolution:
    """A working set resolved against one machine's memory hierarchy."""

    machine: str
    ws_bytes: float
    home: str                 # home tier name
    legs: tuple               # TierLeg per traversed boundary
    seconds: float            # composed ECM memory term
    saturation: float         # modeled home-interface saturation 0..1
    overlap: str              # composition used ("full" | "none")

    @property
    def bottleneck_tier(self) -> str:
        """Name of the slowest transfer leg."""
        if not self.legs:
            return "none"
        return max(self.legs, key=lambda leg: leg.seconds).tier

    @property
    def traffic_bytes(self) -> float:
        """Total WA-adjusted traffic over the bottleneck leg."""
        if not self.legs:
            return 0.0
        worst = max(self.legs, key=lambda leg: leg.seconds)
        return worst.load_bytes + worst.store_bytes


def transfer_time(machine, *, ws_bytes: float, load_bytes: float,
                  store_bytes: float = 0.0, nt_stores: bool = False,
                  cores_active: int | None = None,
                  overlap: str = "full") -> TierResolution:
    """Compose the ECM memory term of one traffic profile on a machine.

    ``ws_bytes`` picks the home tier; ``load_bytes``/``store_bytes``
    are the demand traffic (per the whole machine if ``cores_active``
    is socket-wide). Store traffic is WA-adjusted per leg: the Fig. 4
    behavioural mode of the machine is evaluated with each tier's
    ``wa_residue`` and the home tier's modeled saturation, so the same
    stores can cost 2x on a Zen 4 DRAM leg and 1x on a Grace one.
    """
    from repro_torch.core import wa  # lazy: wa lazily imports memtier back

    m = get_machine(machine) if isinstance(machine, str) else machine
    tiers = tiers_of(m)
    legs_t = ladder(tiers, ws_bytes)
    cores = cores_active if cores_active is not None \
        else (getattr(m, "cores", 0) or 1)
    sat = modeled_saturation(m, ws_bytes, cores)
    mode = getattr(m, "wa_mode", "") or "auto_claim"

    legs = []
    for t in legs_t:
        ratio = wa.machine_traffic_ratio(
            mode, nt_stores=nt_stores, bw_utilization=sat,
            residue=t.wa_residue)
        ld_bw, st_bw = effective_bw(t, cores)
        st_traffic = store_bytes * ratio
        sec = load_bytes / ld_bw + st_traffic / st_bw
        legs.append(TierLeg(tier=t.name, seconds=sec,
                            load_bytes=load_bytes, store_bytes=st_traffic,
                            wa_ratio=ratio, load_bw=ld_bw, store_bw=st_bw))
    if overlap not in ("full", "none"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    total = (max((leg.seconds for leg in legs), default=0.0)
             if overlap == "full" else sum(leg.seconds for leg in legs))
    return TierResolution(
        machine=getattr(m, "name", str(machine)), ws_bytes=float(ws_bytes),
        home=legs_t[-1].name if legs_t else "none", legs=tuple(legs),
        seconds=total, saturation=sat, overlap=overlap)


def memory_seconds(machine, traffic_bytes: float,
                   ws_bytes: float | None = None, *,
                   store_frac: float = 1.0 / 3.0,
                   nt_stores: bool = False,
                   cores_active: int | None = None,
                   overlap: str = "full") -> TierResolution:
    """Tier-resolved memory term for an aggregate traffic count.

    Convenience wrapper for callers (roofline, portmodel.compare) that
    only know total HBM/DRAM bytes: the traffic is split into loads and
    stores by ``store_frac`` (streaming code is ~2 loads per store) and
    the working set defaults to the traffic itself — an upper-bound
    proxy that sends big modules to the DRAM/HBM tier, which is where
    the flat roofline lived before this model existed.
    """
    ws = traffic_bytes if ws_bytes is None else ws_bytes
    return transfer_time(
        machine, ws_bytes=float(ws),
        load_bytes=traffic_bytes * (1.0 - store_frac),
        store_bytes=traffic_bytes * store_frac,
        nt_stores=nt_stores, cores_active=cores_active, overlap=overlap)


def page_gather_time(machine, *, n_pages: int, page_bytes: float,
                     table_bytes: float = 0.0,
                     ws_bytes: float | None = None,
                     cores_active: int | None = None,
                     overlap: str = "full") -> TierResolution:
    """Tier-resolved seconds of a block-table page gather (pure reads).

    ``n_pages`` live pages of ``page_bytes`` each, plus the block-table
    entries themselves (``table_bytes`` — a few bytes per page, but a
    *dependent* load the dense path never issues). The working set
    defaults to the gathered bytes; pass the full pool size to price
    the gather against where the pool actually lives
    (repro_torch.serve.kv_traffic does). No stores, so this leg carries no
    write-allocate term on any machine — the WA story of paging is in
    the stores it *avoids* (:func:`page_copy_time` prices the ones it
    adds back: CoW).
    """
    load = n_pages * page_bytes + table_bytes
    ws = load if ws_bytes is None else ws_bytes
    return transfer_time(machine, ws_bytes=float(ws), load_bytes=load,
                         store_bytes=0.0, cores_active=cores_active,
                         overlap=overlap)


def page_copy_time(machine, *, page_bytes: float, n_pages: int = 1,
                   ws_bytes: float | None = None, nt_stores: bool = False,
                   cores_active: int | None = None,
                   overlap: str = "full") -> TierResolution:
    """Tier-resolved seconds of a page-to-page copy (CoW fork).

    Reads ``n_pages`` source pages and stores the same bytes to fresh
    destination pages — the store side is WA-adjusted per leg exactly
    like any other allocating store (``transfer_time``), which is what
    makes CoW cost machine-dependent: a Zen 4 DRAM-resident copy pays
    the write-allocate read of the destination, Grace's claim-based
    mode does not.
    """
    b = n_pages * page_bytes
    ws = 2.0 * b if ws_bytes is None else ws_bytes
    return transfer_time(machine, ws_bytes=float(ws), load_bytes=b,
                         store_bytes=b, nt_stores=nt_stores,
                         cores_active=cores_active, overlap=overlap)
