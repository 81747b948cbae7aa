"""Cross-vendor machine models — the paper's Table II as machine files.

A :class:`MachineModel` is the OSACA "machine file": a set of ports
(functional-unit groups visible to the scheduler) plus, per µ-op class,
which ports may execute it, how many cycles one *unit* of work occupies
the port group, and the result latency (for CP/LCD analysis). Port sets
may be asymmetric per class (e.g. `vdiv` pinned to one divider pipe) and
weighted per port (`OpEntry.port_weights`) to express per-port issue
widths — see DESIGN.md §4.

µ-op classes (units in parentheses, canonical list in isa.UOP_CLASSES):
  mxu      — one 128x128x128 matmul pass (TPU: systolic pass; CPU: the
             FMA-pipe pair executing the equivalent FMA stream)
  vpu      — elementwise vector op (unit = one (8,128) register block)
  xlu      — transcendental (exp/log/tanh/...) — multi-cycle VPU-class
  vdiv     — vector divide/sqrt (slowest VPU-class, paper Table III)
  vlsu     — load/store/shuffle (unit = (8,128) block moved)
  sc       — scalar op (loop bookkeeping, unit = 1 op)
  dma      — off-core memory transfer (unit = byte; HBM or DDR/LPDDR)
  ici      — inter-chip/cross-socket transfer (unit = byte)

Shipped machines: three TPU generations (spec-derived), the paper's three
CPUs (`zen4`, `golden_cove`, `neoverse_v2` — Table II ports, Table III
latencies mapped onto the µ-op classes), copied from the JAX package's
``repro/core/machine.py`` so that they fingerprint as its do, and the
port's card, `h100` (NVIDIA H100 SXM5, :func:`_gpu_model`). A
`host_cpu` model (:func:`host_cpu_model`) is registered only by a
caller that calibrates one; the port has no calibration yet. Each
machine is tagged with its write-allocate mode so ``core/wa.py``
selects the Fig. 4 behavioural mode per machine.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import isa
from repro_torch.utils.hw import (CHIPS, CPU_CHIPS, GPU_CHIPS, ChipSpec,
                                  CpuSpec, GpuSpec)

#: f32 bytes in one vpu/vlsu unit — the (8,128) register block.
BLOCK_BYTES = 8 * 128 * 4
#: multiply-accumulates in one mxu unit — a 128x128x128 pass.
PASS_MACS = 128 ** 3


@dataclasses.dataclass(frozen=True)
class OpEntry:
    """Machine-file row for one µ-op class: ports, throughput, latency."""

    ports: tuple          # which ports can execute this µ-op class
    cycles_per_unit: float
    latency: float        # cycles until result usable
    # relative issue capacity of each admissible port (None = symmetric).
    # Expresses per-port issue widths: e.g. store pipes that absorb only
    # the store share of `vlsu` traffic get a smaller weight.
    port_weights: tuple | None = None


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """An OSACA-style machine file: ports, µ-op table, WA mode, memory
    ladder (see the module docstring and DESIGN.md §4)."""

    name: str
    clock_hz: float
    ports: tuple
    table: dict           # class name -> OpEntry
    chip: ChipSpec | GpuSpec | None = None
    # paper-style metadata (Table II row)
    simd_width_bytes: int = 0
    notes: str = ""
    vendor: str = ""
    isa_name: str = ""
    issue_width: int = 0          # front-end µops/cycle (0 = unmodeled)
    wa_mode: str = "auto_claim"   # write-allocate behaviour (core/wa.py)
    # memory hierarchy (ECM ladder, innermost first — core/memtier.py)
    mem_tiers: tuple = ()
    cores: int = 1                # cores per socket driving shared tiers

    def entry(self, cls: str) -> OpEntry:
        """The OpEntry of one µ-op class."""
        return self.table[cls]

    def seconds(self, cycles: float) -> float:
        """Convert a cycle count to seconds at this machine's clock."""
        return cycles / self.clock_hz


# --- registry ---------------------------------------------------------------

#: name -> MachineModel. Mutated only through register(); kept as a plain
#: dict under its historical name so existing call sites keep working.
MACHINES: dict = {}

_WA_MODES = ("auto_claim", "saturation_gated", "explicit_only")


class MachineValidationError(ValueError):
    """A machine file failed `validate_model`'s sanity checks."""


def validate_model(model: MachineModel) -> None:
    """A machine file must cover every µ-op class with sane numbers."""
    known = set(model.ports)
    for cls in isa.UOP_CLASSES:
        e = model.table.get(cls)
        if e is None:
            raise MachineValidationError(
                f"{model.name}: missing µ-op class {cls!r}")
        if not e.ports:
            raise MachineValidationError(
                f"{model.name}/{cls}: empty port set")
        if not set(e.ports) <= known:
            raise MachineValidationError(
                f"{model.name}/{cls}: ports {set(e.ports) - known} not "
                f"declared in machine.ports")
        if not e.cycles_per_unit > 0:
            raise MachineValidationError(
                f"{model.name}/{cls}: cycles_per_unit must be > 0")
        if e.latency < 0:
            raise MachineValidationError(
                f"{model.name}/{cls}: negative latency")
        if e.port_weights is not None:
            if len(e.port_weights) != len(e.ports):
                raise MachineValidationError(
                    f"{model.name}/{cls}: {len(e.port_weights)} weights "
                    f"for {len(e.ports)} ports")
            if any(w <= 0 for w in e.port_weights):
                raise MachineValidationError(
                    f"{model.name}/{cls}: non-positive port weight")
    if model.wa_mode not in _WA_MODES:
        raise MachineValidationError(
            f"{model.name}: unknown wa_mode {model.wa_mode!r} "
            f"(expected one of {_WA_MODES})")
    if not model.clock_hz > 0:
        raise MachineValidationError(f"{model.name}: clock_hz must be > 0")
    prev_cap = 0.0
    for t in model.mem_tiers:
        if t.capacity_bytes < 0:
            raise MachineValidationError(
                f"{model.name}/{t.name}: negative tier capacity")
        if t.capacity_bytes > 0:        # zero-capacity = disabled level
            if t.capacity_bytes < prev_cap:
                raise MachineValidationError(
                    f"{model.name}/{t.name}: tier capacities must be "
                    f"non-decreasing outward")
            prev_cap = t.capacity_bytes
        if not (t.load_bw > 0 and t.store_bw > 0):
            raise MachineValidationError(
                f"{model.name}/{t.name}: tier bandwidths must be > 0")
        if t.shared_bw < 0:
            raise MachineValidationError(
                f"{model.name}/{t.name}: negative shared_bw")
        if not 0.0 <= t.wa_residue <= 1.0:
            raise MachineValidationError(
                f"{model.name}/{t.name}: wa_residue must be in [0, 1]")
    if model.mem_tiers and \
            model.mem_tiers[-1].capacity_bytes != float("inf"):
        raise MachineValidationError(
            f"{model.name}: outermost tier must have infinite capacity "
            f"(the backing DRAM/HBM level)")


def register(model: MachineModel, *, replace: bool = False) -> MachineModel:
    """Validate and add a machine to the registry; returns the model."""
    validate_model(model)
    if model.name in MACHINES and not replace:
        raise ValueError(f"machine {model.name!r} already registered "
                         f"(pass replace=True to recalibrate)")
    MACHINES[model.name] = model
    return model


def get_machine(machine) -> MachineModel:
    """Resolve a machine by name or pass a MachineModel through."""
    if isinstance(machine, MachineModel):
        return machine
    try:
        return MACHINES[machine]
    except KeyError:
        raise KeyError(f"unknown machine {machine!r}; registered: "
                       f"{sorted(MACHINES)}") from None


def registered_names() -> tuple:
    """Names of every registered machine, in registration order."""
    return tuple(MACHINES)


def registered_models() -> tuple:
    """Every registered MachineModel, in registration order."""
    return tuple(MACHINES.values())


def machine_fingerprint(machine) -> str:
    """Content hash of one machine file (name or model).

    Stable across processes for identically-built models: the hash
    covers the full dataclass repr — ports, µ-op table, WA mode,
    memory ladder, core count. Two registrations of the *same name*
    with different specs (ubench recalibration, test re-registration)
    therefore fingerprint differently, which is what lets plan caches
    key on machine *content* instead of machine *names*.
    """
    import hashlib
    m = get_machine(machine)
    return hashlib.sha256(repr(m).encode()).hexdigest()[:16]


def registry_fingerprint() -> tuple:
    """(name, content-hash) pairs of the whole registry, in order.

    The plan memo (``serve/planner.py``) and the tile autotuner
    (``kernels/tuning.py``) key on this instead of the bare name tuple:
    re-registering a machine under an existing name (``replace=True``)
    changes the fingerprint, so a plan priced against the old spec can
    never be served after a recalibration.
    """
    return tuple((name, machine_fingerprint(m))
                 for name, m in MACHINES.items())


# --- TPU machine files ------------------------------------------------------

def _tpu_model(chip: ChipSpec, mxu_lat: float = 192.0) -> MachineModel:
    mxus = tuple(f"MXU{i}" for i in range(chip.n_mxu))
    vpus = tuple(f"VPU{i}" for i in range(chip.n_vpu))
    vlsus = ("VLSU0", "VLSU1")
    dmas = ("DMA0", "DMA1")
    icis = ("ICI",)
    sc = ("SC",)
    bytes_per_cy = chip.hbm_bw / chip.clock_hz          # both DMA queues
    ici_bytes_per_cy = chip.ici_link_bw * chip.ici_links / chip.clock_hz
    table = {
        # one pass = stream 128 rows through the 128x128 array
        "mxu": OpEntry(mxus, 128.0, mxu_lat),
        "vpu": OpEntry(vpus, 1.0, 4.0),      # one (8,128) block per cy/port
        "xlu": OpEntry(vpus, 4.0, 12.0),     # transcendental ~1/4 rate
        "vdiv": OpEntry(vpus, 8.0, 24.0),
        "vlsu": OpEntry(vlsus, 1.0, 6.0),    # (8,128) block load/store
        "gather4": OpEntry(vlsus, 4.0, 12.0),  # random-index gather
        "sc": OpEntry(sc, 1.0, 1.0),
        "dma": OpEntry(dmas, 2.0 / bytes_per_cy, 500.0),   # per byte, 2q
        "ici": OpEntry(icis, 1.0 / ici_bytes_per_cy, 2000.0),
    }
    return MachineModel(
        name=chip.name, clock_hz=chip.clock_hz,
        ports=mxus + vpus + vlsus + dmas + icis + sc, table=table, chip=chip,
        simd_width_bytes=BLOCK_BYTES, vendor="Google", isa_name="TPU",
        issue_width=0, wa_mode="auto_claim",
        mem_tiers=tuple(chip.mem_tiers), cores=1,
        notes=f"{chip.n_mxu} MXU / {chip.n_vpu} VPU lanesets, "
              f"{chip.hbm_bw/1e9:.0f} GB/s HBM")


# --- CPU machine files (paper Table II / Table III) -------------------------

def _cpu_ports(spec: CpuSpec) -> dict:
    """Scheduler-visible port groups for one paper CPU."""
    simd = tuple(f"FP{i}" for i in range(spec.n_simd))
    loads = tuple(f"LD{i}" for i in range(spec.n_load))
    stores = tuple(f"ST{i}" for i in range(spec.n_store))
    return {
        "fma": simd[:spec.n_fma],   # FMA-capable subset (the mxu pair)
        "simd": simd,
        "div": simd[:1],            # divider lives on the first FP pipe
        "load": loads,
        "store": stores,
        "alu": ("ALU",),
        "mem": ("MEM",),            # off-core memory interface
        "xs": ("ICI",),             # cross-socket / C2C link
    }


def _cpu_model(spec: CpuSpec) -> MachineModel:
    """Map a paper CPU onto the µ-op classes.

    Units stay TPU-shaped so one HLO analysis is comparable across
    vendors: a `vpu` unit is one (8,128) f32 block (4 KiB of lanes), an
    `mxu` unit is one 128^3 pass. Per class, `cycles_per_unit` is the
    total port-group occupation of one unit assuming one full-width op
    per port per cycle — the Table III reciprocal-throughput model.
    """
    p = _cpu_ports(spec)
    # full-width vector ops needed to touch one (8,128) f32 block
    vec_ops = BLOCK_BYTES / spec.simd_width_bytes
    # FMAs for one 128^3 pass at simd_width/4 f32 lanes per FMA
    fma_ops = PASS_MACS / (spec.simd_width_bytes / 4)
    # loads are ~2 of every 3 accesses in streaming code; store pipes
    # only absorb the store share -> weight them at half a load pipe
    ls_weights = (1.0,) * spec.n_load + (0.5,) * spec.n_store
    cy_per_byte = spec.clock_hz / spec.mem_bw
    mem_lat_cy = 100e-9 * spec.clock_hz        # ~100 ns DRAM latency
    table = {
        "mxu": OpEntry(p["fma"], fma_ops, spec.fma_latency),
        "vpu": OpEntry(p["simd"], vec_ops, spec.fma_latency),
        # vectorized transcendental: ~8-term polynomial of FMA-class ops
        "xlu": OpEntry(p["simd"], 8.0 * vec_ops, 8.0 * spec.fma_latency),
        # divider: single pipe, barely pipelined (Table III)
        "vdiv": OpEntry(p["div"], spec.fdiv_recip_tput * vec_ops,
                        spec.fdiv_latency),
        "vlsu": OpEntry(p["load"] + p["store"], vec_ops, spec.load_latency,
                        port_weights=ls_weights),
        # gathers crack into scalar-ish loads: ~4x block cost, loads only
        "gather4": OpEntry(p["load"], 4.0 * vec_ops,
                           2.0 * spec.load_latency),
        "sc": OpEntry(p["alu"], 1.0, 1.0),
        "dma": OpEntry(p["mem"], cy_per_byte, mem_lat_cy),
        "ici": OpEntry(p["xs"], spec.clock_hz / spec.xsocket_bw,
                       4.0 * mem_lat_cy),
    }
    all_ports = (p["simd"] + p["load"] + p["store"] + p["alu"] + p["mem"]
                 + p["xs"])
    return MachineModel(
        name=spec.name, clock_hz=spec.clock_hz, ports=all_ports,
        table=table, chip=None, simd_width_bytes=spec.simd_width_bytes,
        vendor=spec.vendor, isa_name=spec.isa,
        issue_width=spec.issue_width, wa_mode=spec.wa_mode,
        mem_tiers=tuple(spec.mem_tiers), cores=spec.cores,
        notes=f"{spec.uarch}: {spec.n_fma}xFMA/{spec.n_simd}xSIMD "
              f"{spec.simd_width_bytes * 8}b, {spec.n_load}L/{spec.n_store}S, "
              f"{spec.mem_bw/1e9:.0f} GB/s socket")


TPU_V5E = _tpu_model(CHIPS["tpu_v5e"])
TPU_V5P = _tpu_model(CHIPS["tpu_v5p"])
TPU_V4 = _tpu_model(CHIPS["tpu_v4"])

ZEN4 = _cpu_model(CPU_CHIPS["zen4"])
GOLDEN_COVE = _cpu_model(CPU_CHIPS["golden_cove"])
NEOVERSE_V2 = _cpu_model(CPU_CHIPS["neoverse_v2"])


# --- the port's card ---------------------------------------------------------

def _gpu_model(g: GpuSpec) -> MachineModel:
    """Map a Hopper GPU onto the µ-op classes.

    The units stay the JAX package's, so one trace prices across
    vendors: a `vpu` unit is one (8,128) f32 block, an `mxu` unit one
    128^3 pass. A kernel runs on every SM, so each in-core port carries
    the **whole chip's** rate, as the TPU files do (``cores=1`` there);
    ``cores`` = the SM count drives only what it drives elsewhere: the
    shared tiers' contention in ``core/memtier.py`` and the tile tuner's
    split concurrency. The clock (the published boost clock) is only the
    cycle unit: each rate below is the published chip rate, converted.

    * `mxu`  -> tensor cores, at the dense bf16 rate;
    * `vpu`  -> the FP32 lanes, one element a lane a clock;
    * `xlu`  -> the SFU (MUFU: exp2, lg2, rsqrt, sin, cos, rcp);
    * `vdiv` -> an SFU reciprocal plus an FMA, priced in series on the
      SFU port;
    * `vlsu`, `gather4` -> the load/store units at the shared-memory
      bank rate (a gather at four times a block, as elsewhere);
    * `dma`  -> HBM3; `ici` -> NVLink, one direction's half of the
      published both-ways rate.

    NVIDIA publishes no instruction latencies; the per-class latencies
    (cycles) are the TPU files', which only the critical path and the
    `mca_sched` simulation read.

    Write allocation: ``auto_claim`` with residue 0 at every tier. On
    this card a store-only stream pays no visible allocate read (INIT
    streams at 3193-3300 of 3350 GB/s) and streaming ``st.global.cs``
    stores move nothing by more than 0.6 % (``PERF.md`` §6, PRs 14-16):
    the GPU analogue of the paper's Grace result.
    """
    clk = g.clock_hz
    lanes = g.fp32_lanes_per_sm * g.sms
    sfu = g.sfu_per_sm * g.sms
    lsu = g.lsu_bytes_per_sm * g.sms
    table = {
        "mxu": OpEntry(("TC",), 2.0 * PASS_MACS * clk / g.bf16_flops, 192.0),
        "vpu": OpEntry(("FP32",), (BLOCK_BYTES / 4) / lanes, 4.0),
        "xlu": OpEntry(("SFU",), (BLOCK_BYTES / 4) / sfu, 12.0),
        "vdiv": OpEntry(("SFU",), (BLOCK_BYTES / 4) * (1.0 / sfu
                                                        + 1.0 / lanes),
                        24.0),
        "vlsu": OpEntry(("LSU",), BLOCK_BYTES / lsu, 6.0),
        "gather4": OpEntry(("LSU",), 4.0 * BLOCK_BYTES / lsu, 12.0),
        "sc": OpEntry(("SC",), 1.0, 1.0),
        "dma": OpEntry(("DMA0",), clk / g.hbm_bw, 500.0),
        "ici": OpEntry(("ICI",), clk / (g.nvlink_bw / 2.0), 2000.0),
    }
    return MachineModel(
        name="h100", clock_hz=clk,
        ports=("TC", "FP32", "SFU", "LSU", "SC", "DMA0", "ICI"),
        table=table, chip=g, simd_width_bytes=BLOCK_BYTES,
        vendor=g.vendor, isa_name=g.isa,
        issue_width=g.issue_per_sm * g.sms, wa_mode="auto_claim",
        mem_tiers=tuple(g.mem_tiers), cores=g.sms,
        notes=f"{g.uarch}: {g.sms} SMs, {g.bf16_flops / 1e12:.0f} TFLOP/s "
              f"bf16, {g.hbm_bw / 1e12:.2f} TB/s HBM3")


H100 = _gpu_model(GPU_CHIPS["h100_sxm"])

# the JAX package's order, then the port's card
for _m in (TPU_V5E, TPU_V5P, TPU_V4, ZEN4, GOLDEN_COVE, NEOVERSE_V2, H100):
    register(_m)
del _m


def host_cpu_model(calib: dict | None = None,
                   mem_tiers: tuple = ()) -> MachineModel:
    """Host-CPU machine model; entries overridden by ubench calibration.

    Units are normalized to a nominal 1 GHz clock so `cycles` == ns; the
    calibration dict maps class -> units/second measured on this host.
    ``mem_tiers`` is the measured cache ladder. The JAX package's
    ``core/ubench.py`` builds both and registers the result as
    `host_cpu`; its port waits for ROADMAP queue 1 item 5.
    """
    clock = 1e9
    default_rates = {           # units/s, conservative one-core defaults
        "mxu": 2.0e7,           # ~84 GFLOP/s f32 matmul
        "vpu": 1.2e9,           # (8,128)-blocks/s; calibration will fix
        "xlu": 1.5e8,
        "vdiv": 2.0e8,
        "vlsu": 1.0e9,
        "gather4": 2.5e8,
        "sc": 1.0e9,
        "dma": 2.0e10,          # bytes/s main-memory stream
        "ici": 1.0e10,
    }
    if calib:
        default_rates.update(calib)
    ports = ("P0", "MEM")       # one compute pipe + one memory pipe
    table = {cls: OpEntry(("MEM",) if cls in ("dma", "ici") else ("P0",),
                          clock / rate, 4.0)
             for cls, rate in default_rates.items()}
    return MachineModel(name="host_cpu", clock_hz=clock, ports=ports,
                        table=table, wa_mode="auto_claim",
                        mem_tiers=tuple(mem_tiers), cores=1,
                        notes="ubench-calibrated host model")
