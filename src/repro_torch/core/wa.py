"""Write-allocate / read-modify-write traffic analysis (paper §III).

On a cache-line CPU, a store miss reads the line before overwriting it
(write-allocate) unless the core claims the line (Grace), SpecI2M kicks in
(SPR, only near bandwidth saturation), or the code uses non-temporal
stores (Zen 4). The TPU analogue (DESIGN.md §2): HBM writes land in
(8,128)-element tiles (fp32; (16,128) bf16 packed) — a store that does not
overwrite a full tile forces the memory system to read the tile first.
System-level analogues: a non-donated buffer that XLA must copy before a
dynamic-update-slice (full write-allocate of the whole buffer), and
unaligned Pallas output BlockSpecs.

This module provides:
 * tile-level RMW classification for a store given shape/offset/donation
 * the three behavioural machine modes of paper Fig. 4 so the
   cross-vendor comparison is reproducible as a model:
     - auto_claim        (Grace / TPU): RMW elided whenever a full tile is
                          provably overwritten
     - saturation_gated  (SPR SpecI2M): evasion only on the fraction of
                          stores issued while the memory interface is
                          >= `gate` saturated — the gate is modeled from
                          the machine's memory ladder (core/memtier.py)
                          when a working-set size is supplied; NT stores
                          leave ~10% residue
     - explicit_only     (Zen 4): standard stores always allocate;
                          NT stores evade fully
 * module-level scan: WA-adjusted store traffic for a parsed HLO module
   (``analyze_module_stores``, ``machine_store_traffic``) — not ported:
   it reads HLO, and no caller of the port needs its counterpart over an
   ATen trace yet (ROADMAP queue 1 item 5). :func:`apply_wa_mode` takes
   such a scan's dict and is kept.

The counterpart of ``repro/core/wa.py``, copied but for the scan.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.utils.hw import dtype_bytes


def native_tile(dtype: str) -> tuple:
    """The (sublane, lane) HBM tile granule for a dtype (packed for
    sub-32-bit types: bf16 -> (16,128), int8 -> (32,128))."""
    packing = {"f32": 1, "s32": 1, "u32": 1,
               "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
               "s8": 4, "u8": 4, "f8e4m3fn": 4, "f8e5m2": 4}.get(dtype, 1)
    return (8 * packing, 128)


@dataclasses.dataclass(frozen=True)
class StoreProfile:
    """Tile-level classification of one store region (RMW accounting)."""

    stored_bytes: float           # payload the program wants to write
    rmw_read_bytes: float         # extra reads forced by partial tiles
    copy_bytes: float = 0.0       # whole-buffer copies (missing donation)

    @property
    def traffic(self) -> float:
        """Total memory traffic: write + forced reads + copy (r+w)."""
        return self.stored_bytes + self.rmw_read_bytes + 2 * self.copy_bytes

    @property
    def ratio(self) -> float:
        """Traffic / stored payload (1.0 = perfect, 2.0 = full WA)."""
        return self.traffic / max(self.stored_bytes, 1.0)


def store_profile(shape_dims: tuple, dtype: str, *,
                  offset_aligned: bool = True,
                  donated: bool = True,
                  full_overwrite: bool = True,
                  buffer_bytes: float | None = None) -> StoreProfile:
    """Classify one store region against the native tile grid.

    shape_dims: dims of the written region. offset_aligned: region start is
    tile-aligned (False for unknown dynamic offsets). donated: the target
    buffer aliases an input (in-place); if False and the write is partial
    (full_overwrite=False at buffer granularity), XLA materializes a copy
    of the whole buffer first.
    """
    st, sl = native_tile(dtype)
    eb = dtype_bytes(dtype)
    elems = math.prod(shape_dims) if shape_dims else 1
    stored = float(elems * eb)
    if len(shape_dims) == 0:
        return StoreProfile(stored, 0.0)
    rows = math.prod(shape_dims[:-1]) if len(shape_dims) > 1 else 1
    cols = shape_dims[-1]
    sub = shape_dims[-2] if len(shape_dims) > 1 else 1

    # tiles touched along the minor-2 dims
    if offset_aligned:
        col_tiles = math.ceil(cols / sl)
        row_tiles = math.ceil(sub / st)
        frac_full_cols = (cols // sl) / col_tiles if col_tiles else 1.0
        frac_full_rows = (sub // st) / row_tiles if row_tiles else 1.0
        full_frac = frac_full_cols * frac_full_rows
    else:
        col_tiles = math.ceil(cols / sl) + 1
        row_tiles = math.ceil(sub / st) + 1
        full_frac = max(0.0, (cols - sl) / (col_tiles * sl)) * \
            max(0.0, (sub - st) / (row_tiles * st))
    touched = (rows // max(sub, 1)) * row_tiles * col_tiles if sub else 1
    tile_bytes = st * sl * eb
    touched_bytes = max(stored, touched * tile_bytes)
    rmw = (1.0 - full_frac) * touched_bytes

    copy = 0.0
    if not donated and not full_overwrite and buffer_bytes:
        copy = float(buffer_bytes)
    return StoreProfile(stored, rmw, copy)


# --- the paper's three machines as behavioural modes (Fig. 4) -------------

def machine_traffic_ratio(mode: str, *, nt_stores: bool = False,
                          bw_utilization: float = 1.0,
                          tile_full_frac: float = 1.0,
                          residue: float | None = None) -> float:
    """Memory-traffic / stored-data ratio for a store-only kernel.

    Mirrors Fig. 4: 1.0 = perfect WA evasion, 2.0 = full write-allocate.

    ``residue`` is the per-tier WA-evasion residue from the memory
    ladder (`MemTier.wa_residue`, core/memtier.py): the allocate-read
    fraction surviving the machine's evasion mechanism at one tier
    boundary. When omitted, the legacy Fig. 4 calibration constants
    apply (auto-claim 0, SpecI2M/NT ~0.1, NT-on-Zen4 0, and a
    conservative 0.25 maximum SpecI2M evasion for standard stores).
    """
    partial_extra = 1.0 - tile_full_frac          # RMW share from tiling
    if mode == "auto_claim":            # Grace & TPU
        return 1.0 + (residue or 0.0) + partial_extra
    if mode == "saturation_gated":      # Sapphire Rapids SpecI2M
        if nt_stores:
            # residual allocate traffic (~10% in the paper's Fig. 4)
            return 1.0 + (0.1 if residue is None else residue) \
                + partial_extra
        gate = max(0.0, min(1.0, (bw_utilization - 0.5) / 0.5))
        # evasion depth at full gate: legacy 0.25, or down to the
        # tier's residue when the ladder supplies one
        evade = gate * (0.25 if residue is None else 1.0 - residue)
        return 2.0 - evade + partial_extra
    if mode == "explicit_only":         # Zen 4
        if nt_stores:
            return 1.0 + (residue or 0.0) + partial_extra
        return 2.0 + partial_extra      # standard stores always allocate
    raise ValueError(mode)


# --- per-machine mode selection ---------------------------------------------
#
# Every registered MachineModel is tagged with its wa_mode
# (repro_torch.core.machine), so the Fig. 4 behavioural mode is a property of
# the machine file instead of an ad-hoc argument at each call site.

def wa_mode_of(machine) -> str:
    """WA behavioural mode of a machine (model or registered name)."""
    if isinstance(machine, str):
        from repro_torch.core.machine import get_machine
        machine = get_machine(machine)
    return getattr(machine, "wa_mode", "") or "auto_claim"


def modeled_saturation_for(machine, ws_bytes: float,
                           cores_active: int | None = None) -> float:
    """Ladder-modeled interface saturation for a working set, 0..1.

    Thin forwarding wrapper over `memtier.modeled_saturation` (imported
    lazily — memtier imports this module for the Fig. 4 ratio model).
    """
    from repro_torch.core import memtier
    return memtier.modeled_saturation(machine, ws_bytes, cores_active)


def traffic_ratio_for(machine, *, nt_stores: bool = False,
                      bw_utilization: float | None = None,
                      tile_full_frac: float = 1.0,
                      ws_bytes: float | None = None,
                      cores_active: int | None = None) -> float:
    """`machine_traffic_ratio` with the mode taken from the machine tag.

    The SpecI2M saturation gate is no longer a caller-supplied constant:
    pass ``ws_bytes`` (and optionally ``cores_active``) and the gate is
    *modeled* from the machine's memory ladder — the home tier of the
    working set must actually saturate its shared interface for the
    evasion to engage. An explicit ``bw_utilization`` still overrides
    (sweeps like benchmarks/fig4_wa.py plot against it); with neither
    supplied, full saturation is assumed (the legacy default).
    """
    if bw_utilization is None:
        bw_utilization = (modeled_saturation_for(machine, ws_bytes,
                                                 cores_active)
                          if ws_bytes is not None else 1.0)
    return machine_traffic_ratio(wa_mode_of(machine), nt_stores=nt_stores,
                                 bw_utilization=bw_utilization,
                                 tile_full_frac=tile_full_frac)


def ladder_traffic_ratio(machine, *, nt_stores: bool = False,
                         bw_utilization: float | None = None,
                         tile_full_frac: float = 1.0,
                         ws_bytes: float | None = None,
                         cores_active: int | None = None) -> float:
    """`machine_traffic_ratio` with the residue taken from the ladder.

    The per-tier WA-evasion residue comes from the machine's `MemTier`
    ladder instead of the legacy Fig. 4 calibration constants: the
    working set's home tier (the backing tier when ``ws_bytes`` is
    omitted — store streams that evade WA are DRAM-bound by nature)
    supplies ``wa_residue``, and the SpecI2M gate is modeled from the
    same ladder unless an explicit ``bw_utilization`` overrides. This
    is the single pricing path `benchmarks/fig4_wa.py`,
    `benchmarks/fig4b_ntstore.py`, and the store-flavor selector
    (`repro_torch.kernels.stores`) share, so the Fig. 4 curves, the fig4b
    gate, and the flavor decision can never disagree on a ratio.
    """
    if isinstance(machine, str):
        from repro_torch.core.machine import get_machine
        machine = get_machine(machine)
    from repro_torch.core import memtier
    tiers = memtier.tiers_of(machine)
    home = tiers[-1] if ws_bytes is None \
        else memtier.resolve_home(tiers, ws_bytes)
    if bw_utilization is None:
        bw_utilization = (memtier.modeled_saturation(machine, ws_bytes,
                                                     cores_active)
                          if ws_bytes is not None else 1.0)
    return machine_traffic_ratio(wa_mode_of(machine), nt_stores=nt_stores,
                                 bw_utilization=bw_utilization,
                                 tile_full_frac=tile_full_frac,
                                 residue=home.wa_residue)


def priced_store_traffic(profile: StoreProfile, machine, *,
                         nt_stores: bool = False,
                         ws_bytes: float | None = None,
                         cores_active: int | None = None,
                         flavor: str | None = None) -> float:
    """Total memory traffic (bytes) of one StoreProfile on one machine.

    The stored payload is priced at the machine's Fig. 4 ratio evaluated
    at the profile's tile fullness (``tile_full_frac`` = 1 - rmw/stored,
    which may go negative for badly misaligned stores — the ratio then
    correctly exceeds the mode's base). A donation-copy term
    (``profile.copy_bytes``: the whole-buffer copy XLA materializes for a
    partial write into a non-donated buffer) is priced as one full read
    plus a full-overwrite write at the machine's ratio — the copy streams
    whole tiles, so only the machine's base WA behaviour applies to it.
    Used by repro_torch.serve.kv_traffic to report the per-machine
    donated-vs-copied KV-update delta.

    ``flavor`` opts into store-flavor pricing: ``"standard"`` / ``"nt"``
    (or ``"auto"``, resolved by the per-machine selector in
    ``repro_torch.kernels.stores``) prices through the memory ladder's
    per-tier residues (:func:`ladder_traffic_ratio`) instead of the
    legacy Fig. 4 constants, so the result matches what the selected
    store kernel actually generates. The legacy ``nt_stores`` keyword
    keeps the historical constants when ``flavor`` is None.
    """
    if flavor is not None:
        from repro_torch.kernels.stores import resolve_flavor
        nt_stores = resolve_flavor(flavor, machine, ws_bytes=ws_bytes,
                                   cores_active=cores_active) == "nt"
        ratio_fn = ladder_traffic_ratio
    else:
        ratio_fn = traffic_ratio_for
    stored = profile.stored_bytes
    full_frac = 1.0 - profile.rmw_read_bytes / stored if stored > 0 else 1.0
    ratio = ratio_fn(machine, nt_stores=nt_stores,
                     tile_full_frac=full_frac,
                     ws_bytes=ws_bytes, cores_active=cores_active)
    traffic = stored * ratio
    if profile.copy_bytes:
        ratio_full = ratio_fn(machine, nt_stores=nt_stores,
                              tile_full_frac=1.0,
                              ws_bytes=ws_bytes,
                              cores_active=cores_active)
        traffic += profile.copy_bytes * (1.0 + ratio_full)
    return traffic


def apply_wa_mode(scan: dict, machine, *, nt_stores: bool = False,
                  bw_utilization: float | None = None,
                  ws_bytes: float | None = None,
                  cores_active: int | None = None) -> dict:
    """Apply one machine's WA mode to a (machine-independent) store scan.

    `scan` is an `analyze_module_stores` result. The scan's RMW reads
    become the partial-tile term: tile_full_frac = 1 - rmw/stored, which
    may go negative for badly misaligned stores (rmw > stored) — the
    ratio then correctly exceeds the mode's base. Returns the scan dict
    extended with `wa_mode` and `traffic_bytes` = stored x machine ratio
    + the donation-copy term; the machine ratio replaces `wa_ratio` (the
    scan's tile-level value is preserved as `tile_wa_ratio`).
    """
    stored = scan["stored_bytes"]
    full_frac = 1.0 - scan["rmw_read_bytes"] / stored if stored > 0 else 1.0
    ratio = traffic_ratio_for(machine, nt_stores=nt_stores,
                              bw_utilization=bw_utilization,
                              tile_full_frac=full_frac,
                              ws_bytes=ws_bytes, cores_active=cores_active)
    out = dict(scan)
    out["wa_mode"] = wa_mode_of(machine)
    out["tile_wa_ratio"] = scan.get("wa_ratio")
    out["wa_ratio"] = ratio
    # missing-donation copies (read+write the whole buffer) happen on
    # every machine regardless of WA mode
    out["traffic_bytes"] = stored * ratio + 2.0 * scan.get("copy_bytes", 0.0)
    return out
