"""Hardware constants: the JAX package's TPU and CPU specs, copied, and
the NVIDIA H100 SXM the port runs on.

The TPU and CPU specs are ``repro/utils/hw.py``'s, field for field, so
that the machine files built from them fingerprint as the JAX package's
do (``core/machine.py``). :data:`H100_SXM` is built from NVIDIA's
public figures only, each cited beside it; nothing in it is fitted to a
measurement of the card.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MemTier:
    """One level of a machine's memory hierarchy (ECM-style tier).

    Capacities are the working-set capacity *visible from one core* (the
    classic cache-ladder x-axis): private L1/L2 capacity for the private
    tiers, the shared slice a single core can realistically occupy for
    L3/SLC, and ``inf`` for DRAM/HBM. Bandwidths are single-core
    sustained rates; ``shared_bw`` is the socket-level ceiling for
    shared tiers (0.0 marks a private tier whose aggregate bandwidth
    scales linearly with active cores).

    ``wa_residue`` parametrizes write-allocate evasion quality at this
    tier boundary, after the CloverLeaf WA-evasion study (arXiv:
    2311.04797): the fraction of allocate-read traffic that *remains*
    when the machine's evasion mechanism (cache-line claim, SpecI2M, NT
    stores) engages for stores homed here. 1.0 = no mechanism operates
    at this boundary; 0.0 = perfect evasion.
    """

    name: str                  # "L1" / "L2" / "L3" / "DRAM" / "VMEM"...
    capacity_bytes: float      # working-set capacity seen from one core
    load_bw: float             # bytes/s, single-core sustained load
    store_bw: float            # bytes/s, single-core sustained store
    shared_bw: float = 0.0     # socket ceiling; 0.0 = private tier
    wa_residue: float = 1.0    # allocate fraction left under evasion


def _cache_ladder(clock_hz: float, levels: tuple) -> tuple:
    """Build a MemTier ladder from per-level (name, capacity, load B/cy,
    store B/cy, shared GB/s or 0, wa_residue) rows at a fixed clock."""
    return tuple(
        MemTier(name=n, capacity_bytes=float(cap),
                load_bw=ld * clock_hz, store_bw=st * clock_hz,
                shared_bw=sh * 1e9, wa_residue=res)
        for (n, cap, ld, st, sh, res) in levels)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    # peak compute
    bf16_flops: float          # FLOP/s per chip
    int8_ops: float            # OP/s per chip
    # memory system
    hbm_bytes: float           # capacity per chip
    hbm_bw: float              # bytes/s per chip
    vmem_bytes: float          # on-chip vector memory
    # interconnect
    ici_link_bw: float         # bytes/s per link (one direction)
    ici_links: int             # links per chip (3D torus: 6; 2D: 4)
    # core geometry (for the in-core port model)
    clock_hz: float
    n_mxu: int                 # 128x128 systolic arrays per core
    n_vpu: int                 # (8,128) vector ALU lanesets usable per cycle
    native_tile: tuple = (8, 128)  # tile granule (fp32 sublane x lane)
    mem_tiers: tuple = ()      # MemTier ladder (VMEM -> HBM), inner first


def _tpu_tiers(vmem_bytes: float, hbm_bw: float) -> tuple:
    """VMEM + HBM ladder for a TPU chip.

    VMEM feeds the compute units at roughly an order of magnitude above
    HBM (it backs every VPU operand fetch); HBM is the DMA-visible tier.
    Both claim full tiles on store (the Grace-like `auto_claim`
    behaviour, DESIGN.md §2), so the WA residue is 0 at both tiers.
    """
    return (
        MemTier("VMEM", float(vmem_bytes), 10.0 * hbm_bw, 10.0 * hbm_bw,
                shared_bw=10.0 * hbm_bw, wa_residue=0.0),
        MemTier("HBM", math.inf, hbm_bw, hbm_bw,
                shared_bw=hbm_bw, wa_residue=0.0),
    )


# TPU v5e — the assignment's target chip. 197 bf16 TFLOP/s at ~0.94 GHz
# with 4 MXUs: 4 * 128*128 * 2 flop * clock ≈ 197e12 → clock ≈ 1.5e9 / ...
# Public spec: 393 int8 TOPS / 197 bf16 TFLOPS, 16 GB HBM2E @ 819 GB/s,
# 1.6 Tbps ICI x4 links (=50 GB/s/link/dir).
TPU_V5E = ChipSpec(
    name="tpu_v5e",
    bf16_flops=197e12,
    int8_ops=394e12,
    hbm_bytes=16e9,
    hbm_bw=819e9,
    vmem_bytes=128 * 2**20,
    ici_link_bw=50e9,
    ici_links=4,
    clock_hz=1.5e9,   # modeled: 4 MXU * 128*128*2 * 1.5e9 = 196.6e12
    n_mxu=4,
    n_vpu=8,
    mem_tiers=_tpu_tiers(128 * 2**20, 819e9),
)

# TPU v5p — the "Sapphire Rapids" of the comparison: widest compute.
TPU_V5P = ChipSpec(
    name="tpu_v5p",
    bf16_flops=459e12,
    int8_ops=918e12,
    hbm_bytes=95e9,
    hbm_bw=2765e9,
    vmem_bytes=128 * 2**20,
    ici_link_bw=100e9,
    ici_links=6,
    clock_hz=1.75e9,  # modeled: 8 MXU * 128*128*2 * 1.75e9 ≈ 459e12
    n_mxu=8,
    n_vpu=16,
    mem_tiers=_tpu_tiers(128 * 2**20, 2765e9),
)

# TPU v4 — previous generation baseline.
TPU_V4 = ChipSpec(
    name="tpu_v4",
    bf16_flops=275e12,
    int8_ops=275e12,
    hbm_bytes=32e9,
    hbm_bw=1228e9,
    vmem_bytes=128 * 2**20,
    ici_link_bw=50e9,
    ici_links=6,
    clock_hz=1.05e9,  # modeled: 8 MXU * 128*128*2 * 1.05e9 ≈ 275e12
    n_mxu=8,
    n_vpu=16,
    mem_tiers=_tpu_tiers(128 * 2**20, 1228e9),
)

CHIPS = {c.name: c for c in (TPU_V5E, TPU_V5P, TPU_V4)}


# --- the paper's actual CPUs (Table I / Table II core features) -------------

@dataclasses.dataclass(frozen=True)
class CpuSpec:
    """Core + node features of one paper CPU (Table I / Table II).

    Port counts describe the scheduler-visible functional-unit groups the
    in-core model needs: FMA-capable SIMD pipes (the `mxu` analogue), total
    SIMD/FP pipes (`vpu`), load/store pipes (`vlsu`), and the single
    divider pipe (`vdiv`).
    """
    name: str
    vendor: str
    uarch: str
    isa: str
    clock_hz: float            # fixed core clock used in the paper's runs
    issue_width: int           # rename/dispatch width, µops per cycle
    simd_width_bytes: int      # native datapath width per FP pipe
    n_fma: int                 # FMA-capable SIMD pipes
    n_simd: int                # all SIMD/FP ALU pipes
    n_load: int                # load pipes (SIMD-capable)
    n_store: int               # store-data pipes
    fma_latency: float         # cycles
    load_latency: float        # L1 load-to-use, cycles (vector)
    fdiv_recip_tput: float     # cycles per full-width vector divide
    fdiv_latency: float
    l1d_bytes: int
    mem_bw: float              # bytes/s sustained per socket (stream-like)
    xsocket_bw: float          # bytes/s cross-socket/C2C link
    cores: int                 # cores per socket
    wa_mode: str               # write-allocate behaviour (core/wa.py)
    mem_tiers: tuple = ()      # MemTier cache ladder, L1 first, DRAM last


# AMD Genoa / Zen 4 (EPYC 9654). 6-wide; 4 FP pipes of which FP0/FP1 are
# 256-bit FMA (AVX-512 is double-pumped on the 256-bit datapath); divider
# on one pipe, not pipelined. WA evasion only via explicit NT stores.
ZEN4 = CpuSpec(
    name="zen4", vendor="AMD", uarch="Zen 4", isa="x86-64 AVX-512(2x256b)",
    clock_hz=2.4e9, issue_width=6, simd_width_bytes=32,
    n_fma=2, n_simd=4, n_load=2, n_store=1,
    fma_latency=4.0, load_latency=7.0,
    fdiv_recip_tput=6.5, fdiv_latency=13.0,
    l1d_bytes=32 * 1024, mem_bw=460.8e9, xsocket_bw=50e9, cores=96,
    wa_mode="explicit_only",
    # Cache ladder (B/cy single core at 2.4 GHz; shared GB/s socket).
    # Standard stores write-allocate at every boundary (residue 1.0);
    # only explicit NT stores evade, fully, at the DRAM interface.
    mem_tiers=_cache_ladder(2.4e9, (
        ("L1", 32 * 1024, 64.0, 32.0, 0.0, 1.0),
        ("L2", 1 * 2**20, 32.0, 32.0, 0.0, 1.0),
        ("L3", 32 * 2**20, 24.0, 20.0, 1380.0, 1.0),   # one CCD slice
        ("DRAM", math.inf, 16.0, 10.0, 460.8, 0.0),    # NT: full evasion
    )),
)

# Intel Sapphire Rapids / Golden Cove (Xeon 8470). 6-wide; with AVX-512
# ports P0+P1 fuse into one 512-bit FMA pipe next to P5 -> two 512-bit
# FMA pipes; divider on P0; 2x512b loads + 1x512b store per cycle.
# SpecI2M evades write-allocates only near bandwidth saturation.
GOLDEN_COVE = CpuSpec(
    name="golden_cove", vendor="Intel", uarch="Golden Cove",
    isa="x86-64 AVX-512", clock_hz=2.0e9, issue_width=6,
    simd_width_bytes=64, n_fma=2, n_simd=2, n_load=2, n_store=1,
    fma_latency=4.0, load_latency=7.0,
    fdiv_recip_tput=8.0, fdiv_latency=16.0,
    l1d_bytes=48 * 1024, mem_bw=307.2e9, xsocket_bw=48e9, cores=52,
    wa_mode="saturation_gated",
    # SpecI2M operates only at the memory interface and leaves ~10% of
    # the allocate traffic behind even when fully engaged (Fig. 4).
    mem_tiers=_cache_ladder(2.0e9, (
        ("L1", 48 * 1024, 128.0, 64.0, 0.0, 1.0),
        ("L2", 2 * 2**20, 64.0, 48.0, 0.0, 1.0),
        ("L3", 105 * 2**20, 20.0, 12.0, 900.0, 1.0),   # mesh-limited
        ("DRAM", math.inf, 15.0, 10.0, 307.2, 0.1),    # SpecI2M residue
    )),
)

# NVIDIA Grace / Neoverse V2. 8-wide; 4x128-bit SIMD pipes V0..V3, all
# FMA-capable; divider on V0; 3 load + 2 store pipes. The cache claims
# lines on store misses -> next-to-optimal automatic WA evasion.
NEOVERSE_V2 = CpuSpec(
    name="neoverse_v2", vendor="NVIDIA", uarch="Neoverse V2",
    isa="AArch64 NEON/SVE2(4x128b)", clock_hz=3.4e9, issue_width=8,
    simd_width_bytes=16, n_fma=4, n_simd=4, n_load=3, n_store=2,
    fma_latency=4.0, load_latency=6.0,
    fdiv_recip_tput=7.0, fdiv_latency=15.0,
    l1d_bytes=64 * 1024, mem_bw=500e9, xsocket_bw=450e9, cores=72,
    wa_mode="auto_claim",
    # The cache claims lines on store misses at every level, so the WA
    # residue is 0 at every tier boundary — the paper's "next-to-
    # optimal automatic WA evasion".
    mem_tiers=_cache_ladder(3.4e9, (
        ("L1", 64 * 1024, 48.0, 32.0, 0.0, 0.0),
        ("L2", 1 * 2**20, 32.0, 24.0, 0.0, 0.0),
        ("L3", 114 * 2**20, 16.0, 12.0, 1100.0, 0.0),  # SLC
        ("DRAM", math.inf, 15.0, 11.0, 500.0, 0.0),    # LPDDR5X
    )),
)

CPU_CHIPS = {c.name: c for c in (ZEN4, GOLDEN_COVE, NEOVERSE_V2)}

# --- the port's card: NVIDIA H100 SXM5 --------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """Chip-level features of one Hopper GPU, from NVIDIA's public papers.

    ``bf16_flops`` and ``hbm_bw`` carry the names ``ChipSpec`` gives them,
    so the naive roofline (``core/baseline.py``) reads either spec.
    """
    name: str
    vendor: str
    uarch: str
    isa: str
    clock_hz: float            # boost clock: the machine file's cycle unit
    sms: int                   # streaming multiprocessors
    bf16_flops: float          # dense bf16 FLOP/s on the tensor cores
    fp32_flops: float          # FP32 FLOP/s outside the tensor cores
    fp32_lanes_per_sm: int     # FP32 lanes an SM a clock
    sfu_per_sm: int            # SFU results an SM a clock (MUFU)
    issue_per_sm: int          # thread-instruction issue slots an SM a clock
    lsu_bytes_per_sm: int      # shared-memory/L1 bytes an SM a clock
    register_bytes_per_sm: int  # register file an SM
    l1_smem_bytes_per_sm: int  # combined L1 data cache / shared memory an SM
    smem_max_bytes: int        # of which usable as shared memory
    l2_bytes: float
    l2_bytes_per_clk: float    # L2 read bytes a clock, whole chip
    hbm_bytes: float
    hbm_bw: float              # bytes/s
    nvlink_bw: float           # bytes/s, both directions together
    mem_tiers: tuple = ()      # registers -> SMEM/L1 -> L2 -> HBM3


def _gpu_tiers(g: GpuSpec) -> tuple:
    """The Hopper memory ladder, innermost first.

    The register file and the L1/shared memory are private to an SM
    (``shared_bw=0``: their aggregate scales with the active SMs); the L2
    and HBM are shared by all SMs and saturate at the chip's rate. No
    figure gives one SM's sustained share of the L2 or the HBM, so the
    per-SM rates are the chip's rate over the SM count: the ceiling is
    reached with every SM streaming. Stores allocate nothing at any
    level (residue 0): a store-only stream reads no line first, which
    this card's own INIT stream shows (``PERF.md``, the ``auto_claim``
    entry in ``core/machine.py``).
    """
    clk, n = g.clock_hz, g.sms
    # an FMA reads three 4-byte register operands and writes one, on
    # every FP32 lane
    reg_ld = 3 * 4 * g.fp32_lanes_per_sm * clk
    reg_st = 4 * g.fp32_lanes_per_sm * clk
    l1 = g.lsu_bytes_per_sm * clk
    l2 = g.l2_bytes_per_clk * clk
    return (
        MemTier("REG", float(g.register_bytes_per_sm), reg_ld, reg_st,
                shared_bw=0.0, wa_residue=0.0),
        MemTier("SMEM/L1", float(g.l1_smem_bytes_per_sm), l1, l1,
                shared_bw=0.0, wa_residue=0.0),
        MemTier("L2", float(g.l2_bytes), l2 / n, l2 / n,
                shared_bw=l2, wa_residue=0.0),
        MemTier("HBM3", math.inf, g.hbm_bw / n, g.hbm_bw / n,
                shared_bw=g.hbm_bw, wa_residue=0.0),
    )


# Sources: [WP] NVIDIA H100 Tensor Core GPU Architecture whitepaper
# (V1.04, 2023); [DS] NVIDIA H100 Tensor Core GPU datasheet (SXM5
# column); [PG] CUDA C++ Programming Guide (compute capability 9.0:
# throughput of native arithmetic instructions, shared memory banks);
# [A100] NVIDIA A100 Tensor Core GPU Architecture whitepaper.
_H100_BASE = GpuSpec(
    name="h100_sxm", vendor="NVIDIA", uarch="Hopper (GH100)",
    isa="sm_90a",
    clock_hz=1.98e9,           # [DS] max boost clock 1980 MHz
    sms=132,                   # [WP] 132 SMs on the SXM5 part
    bf16_flops=989e12,         # [DS] BF16 tensor core, dense
    fp32_flops=67e12,          # [DS] FP32 67 TFLOPS
    fp32_lanes_per_sm=128,     # [WP] 128 FP32 cores an SM
    sfu_per_sm=16,             # [PG] 16 results/clk/SM (rcp, rsqrt, ex2,
                               # lg2, sin, cos); [WP] 4 SFUs a sub-partition
    issue_per_sm=4 * 32,       # [WP] 4 warp schedulers, one warp of 32
                               # an SM a clock each
    lsu_bytes_per_sm=128,      # [PG] 32 banks of 32 bits a clock
    register_bytes_per_sm=256 * 1024,  # [WP] 64K 32-bit registers an SM
    l1_smem_bytes_per_sm=256 * 1024,   # [WP] 256 KB combined L1/shared
    smem_max_bytes=228 * 1024,         # [WP] up to 228 KB shared memory
    l2_bytes=50e6,             # [WP] 50 MB L2
    l2_bytes_per_clk=5120.0,   # [A100] 5120 B/clk L2 read; [WP] gives no
                               # H100 figure, so the A100's is assumed
    hbm_bytes=80e9,            # [DS] 80 GB HBM3
    hbm_bw=3.35e12,            # [DS] 3.35 TB/s
    nvlink_bw=900e9,           # [DS] NVLink 900 GB/s (both directions)
)
H100_SXM = dataclasses.replace(_H100_BASE, mem_tiers=_gpu_tiers(_H100_BASE))

GPU_CHIPS = {H100_SXM.name: H100_SXM}

# Assignment-mandated roofline constants (v5e).
PEAK_FLOPS = TPU_V5E.bf16_flops
HBM_BW = TPU_V5E.hbm_bw
ICI_BW = TPU_V5E.ici_link_bw


def dtype_bytes(dtype) -> int:
    """Bytes of one element of ``dtype``: an HLO or numpy name (``"bf16"``,
    ``"float32"``), a ``torch.dtype``, or its string (``"torch.bfloat16"``).
    An unknown name counts 4 bytes, as the JAX package's does."""
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    return {
        "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
        "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
        "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
        "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
        "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
        "bool": 1, "float8_e4m3fn": 1, "float8_e5m2": 1, "half": 2,
        "float": 4, "double": 8, "long": 8, "int": 4,
    }.get(name, 4)
