"""Microbenchmark-driven machine-model calibration (paper §II).

The counterpart of ``repro/core/ubench.py``. ibench-style methodology:
each op class is measured with a dependency-chained loop
(``x = op(x, b)``) over a small working set, K ops a chain, so dispatch
overhead amortizes over the chain and the chain pins the op on its
unit; streaming (DMA-class) bandwidth is measured separately on a
memory-sized copy and triad. The JAX package measures whatever device
JAX runs on; this module measures the device it is given:

* ``device="cpu"``: the reference's measurement in eager PyTorch, with
  the reference's sizes and arithmetic, registered as ``host_cpu``
  (:func:`core.machine.host_cpu_model`).
* ``device="cuda"``: each chain of K ops is captured as one CUDA graph
  (the counterpart of one jitted ``fori_loop``) and timed by CUDA
  events, on arrays that fill the SMs (``CARD_N``; the reference's 8192
  elements would occupy 8 of 132). The ladder is read at an L2-resident
  working set and an HBM one, and the read rate of one thread block
  from a sweep of ``sum_reduction`` over fixed grids (``CTA_COUNTS``).
  The result is registered as ``h100_measured``
  (:func:`core.machine.measured_gpu_model`): the tensor cores' rate from
  a chain of bf16 matmuls, the HBM stream, each of the L2 and HBM3
  tiers' rate with every SM streaming as its shared ceiling, and one
  block's HBM read rate as HBM3's per-SM rate (:func:`_card_tiers`
  says why L2's per-SM rate and the stores stay published). Every
  other class keeps the published rate: an elementwise torch op on the
  card is a kernel that streams its operands, so its chain time
  measures memory and launch gaps, not the unit. Those chain times are
  reported (``_raw``), not used.

The host model drives the RPE validation (``core/rpe.py``, paper Fig. 3)
on the CPU, the measured card model on the card.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.machine import (GPU_MEASURED_NAME, MachineModel,
                                      host_cpu_model, measured_gpu_model,
                                      register)
from repro_torch.utils.hw import GPU_CHIPS, MemTier

N_SMALL = 8192             # 32 KiB f32 — L1/L2-resident (in-core regime)
N_BIG = 1 << 23            # 32 MiB — memory regime (DMA class)
MAT = 512
K_CHAIN = 256

#: (tier name, elements, declared capacity) for the cache-ladder sweep.
#: Working sets are sized to sit comfortably inside each level on any
#: recent x86/ARM host; the declared capacity is what the resolved
#: MemTier publishes (the level boundary, not the probe size).
TIER_PROBES = (
    ("L1", 1 << 13, 128e3),      # 32 KiB probe in a <=128 KiB L1
    ("L2", 1 << 16, 2e6),        # 256 KiB probe in a <=2 MiB L2
    ("L3", 1 << 20, 24e6),       # 4 MiB probe in a <=24 MiB L3 slice
)

#: elements of a chained op on the card: 4 MiB of f32, 2048 blocks of
#: PyTorch's 512-element elementwise tiles, ~16 an SM
CARD_N = 1 << 20
#: the card's memory-regime arrays: 1 GiB of f32 each
CARD_N_BIG = 1 << 28
#: the card's matmul chain: bf16 (MAT, MAT) products on the tensor cores
CARD_MAT = 4096
#: the card's L2 probe: 4 MiB arrays, 12 MiB touched by a chained add
#: (two operands, one result) inside the 50 MB L2
CARD_L2_N = 1 << 20
#: the block sweep's working sets: L2-resident and HBM-resident
CTA_SWEEP_ELEMS = (("L2", 1 << 22), ("HBM3", CARD_N_BIG))
#: thread blocks of the read sweep: 1 (one SM) to two a SM of an H100
CTA_COUNTS = (1, 2, 4, 8, 16, 32, 64, 128, 132, 264)
#: CUDA-event timings a count of the sweep (the best is kept)
CTA_REPS = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


class _GraphChain:
    """``n_iter`` chained ops captured as one CUDA graph at the first call
    and replayed at every later one (the chain's input is copied into the
    graph's static input first, outside the timed replay)."""

    def __init__(self, op, n_iter: int):
        self.op, self.n_iter = op, n_iter
        self.graph = self.key = self.out = None

    def _run(self, x, consts):
        for _ in range(self.n_iter):
            x = self.op(x, *consts)
        return x

    def __call__(self, x, *consts):
        key = (x.data_ptr(),) + tuple(c.data_ptr() for c in consts)
        if self.key != key:
            self.static = x.clone()
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                self._run(self.static, consts)        # warm-up, not captured
            torch.cuda.current_stream(x.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._run(self.static, consts)
            self.key = key
        self.graph.replay()
        return self.out


def _chain(op, n_iter, device="cpu"):
    """``f(x, *consts)`` applying ``op`` ``n_iter`` times in a chain: a
    Python loop of eager ops on the CPU, one CUDA-graph replay on the
    card."""
    if torch.device(device).type == "cuda":
        return _GraphChain(op, n_iter)

    def f(x, *consts):
        for _ in range(n_iter):
            x = op(x, *consts)
        return x
    return f


def _timeit(fn, *args, reps: int = 5) -> float:
    """Best-of-``reps`` seconds of one call of ``fn(*args)`` after one
    untimed call: wall clock between device synchronizations on the CPU,
    CUDA events around the call on the card."""
    dev = _device_of(args)
    fn(*args)
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
    return best


def _monotone(tiers: list) -> list:
    """Drop inverted levels (noisy hosts can measure an outer level
    faster than an inner one): keep the ladder monotone in bandwidth."""
    mono = []
    for t in tiers:
        while mono and mono[-1].load_bw < t.load_bw:
            mono.pop()
        mono.append(t)
    return mono


def _inputs(n: int, device, gen) -> tuple:
    a = torch.randn(n, generator=gen, device=device).abs() + 0.5
    b = torch.randn(n, generator=gen, device=device).abs() + 0.5
    idx = torch.randperm(n, generator=gen, device=device)
    return a, b, idx


def measure_host_rates(n: int | None = None, device="cuda") -> dict:
    """Measure per-class unit rates + the memory ladder of ``device``.

    Returns {µ-op class: units/second}, plus a ``_raw`` sub-dict with the
    underlying timings, peak numbers and the measured ``mem_tiers``
    MemTier ladder; on the card also the block sweep (``cta_sweep``:
    tier -> [(blocks, bytes/s)]). ``n`` is the chained ops' element
    count (``N_SMALL`` on the CPU, ``CARD_N`` on the card).
    """
    dev = torch.device(device)
    card = dev.type == "cuda"
    if card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to calibrate "
                           "the host")
    n = n or (CARD_N if card else N_SMALL)
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b, idx = _inputs(n, dev, gen)
    mat = CARD_MAT if card else MAT
    mdt = torch.bfloat16 if card else torch.float32
    m1 = (torch.randn(mat, mat, generator=gen, device=dev) * 0.01).to(mdt)
    n_big = CARD_N_BIG if card else N_BIG
    big = torch.randn(n_big, generator=gen, device=dev)

    def ch(op, k=K_CHAIN):
        return _chain(op, k, dev)
    t_add = _timeit(ch(lambda x, c: x + c), a, b) / K_CHAIN
    t_fma = _timeit(ch(lambda x, c: x * 0.999 + c), a, b) / K_CHAIN
    t_div = _timeit(ch(lambda x, c: c / (x + 1.0)), a, b) / K_CHAIN
    t_exp = _timeit(ch(lambda x: torch.exp(-x)), a) / K_CHAIN
    t_gat = _timeit(ch(lambda x, i: x[i]), a, idx) / K_CHAIN
    t_mov = _timeit(ch(lambda x: torch.roll(x, 1)), a) / K_CHAIN
    t_mm = _timeit(ch(lambda x, m: x @ m, 8), m1, m1) / 8
    t_cp = _timeit(lambda x: x + 0.0, big)
    big2 = big * 0.5
    t_tr = _timeit(lambda x, y: torch.add(x, y, alpha=2.0), big, big2)
    del big2

    # memory-tier calibration (ECM ladder): a chained streaming add
    # (2 reads + 1 write per element) at per-level working sets gives
    # each level's combined sustained bandwidth; loads and stores split
    # it 2:1, matching the kernel's access mix. The measured rates
    # already include whatever write-allocate traffic the device really
    # generates, so the resolved tiers carry wa_residue=0 (see
    # core/memtier.py).
    dram_bw = max(2 * 4 * n_big / t_cp, 3 * 4 * n_big / t_tr)
    raw = {"add_s": t_add, "fma_s": t_fma, "div_s": t_div,
           "exp_s": t_exp, "gather_s": t_gat, "move_s": t_mov,
           "matmul_s": t_mm, "copy_big_s": t_cp,
           "flops_matmul": 2 * mat ** 3 / t_mm, "stream_bw": dram_bw}
    if card:
        tiers = _card_tiers(dev, gen, big, dram_bw, raw)
    else:
        tiers = []
        for tname, n_t, cap in TIER_PROBES:
            at = torch.randn(n_t, generator=gen, device=dev).abs() + 0.5
            bt = at * 0.5
            reps = max(16, K_CHAIN // max(1, n_t // 8192))
            t = _timeit(ch(lambda x, c: x + c, reps), at, bt) / reps
            bw = 3 * 4 * n_t / t                   # 2 reads + 1 write
            tiers.append(MemTier(tname, cap, load_bw=bw * 2 / 3,
                                 store_bw=bw / 3, shared_bw=0.0,
                                 wa_residue=0.0))
        tiers.append(MemTier("DRAM", float("inf"), load_bw=dram_bw * 2 / 3,
                             store_bw=dram_bw / 3, shared_bw=dram_bw,
                             wa_residue=0.0))
        tiers = _monotone(tiers)
    raw["mem_tiers"] = tiers

    blocks = n / (8 * 128)
    mxu_passes = (mat / 128) ** 3
    return {
        "vpu": blocks / t_fma,
        "xlu": blocks / t_exp,
        "vdiv": blocks / t_div,
        "vlsu": blocks / t_mov,
        "gather4": blocks / t_gat,
        "mxu": mxu_passes / t_mm,
        "dma": dram_bw,
        "sc": 1e9,
        "_raw": raw,
    }


def cta_sweep(x: torch.Tensor) -> list:
    """``[(blocks, bytes/s)]``: ``sum_reduction`` over ``x`` on a grid
    fixed at each count of ``CTA_COUNTS``, best of ``CTA_REPS``
    CUDA-event timings each. One block streams on one SM, so the rate at
    1 is one SM's read rate; the largest is the chip's."""
    from repro_torch.kernels.stream import kernels as SK
    nbytes = x.numel() * x.element_size()
    return [(c, nbytes / _timeit(lambda t, c=c: SK.sum_reduction(t, blocks=c),
                                 x, reps=CTA_REPS))
            for c in CTA_COUNTS]


def _card_tiers(dev, gen, big, dram_bw: float, raw: dict) -> list:
    """The card's L2 and HBM3 tiers with what was measured of them (the
    first two, the SMs' own storage, are the published ones
    ``measured_gpu_model`` keeps): each tier's shared ceiling (L2 the
    chained add, HBM3 the stream or the sweep's best) and HBM3's per-SM
    read rate (one block of the sweep). L2's per-SM rate and both
    tiers' store rates stay the published ones: the sweep's loads are
    evict-first (``__ldcs``), so its L2 rung reads a stream, not the
    L2, and no probe times stores apart. The sweep's L2 rung is
    reported (``raw["cta_sweep"]``), not registered."""
    at = torch.randn(CARD_L2_N, generator=gen, device=dev).abs() + 0.5
    bt = at * 0.5
    t = _timeit(_chain(lambda x, c: x + c, K_CHAIN, dev), at, bt) / K_CHAIN
    l2_chain_bw = 3 * 4 * CARD_L2_N / t
    raw["l2_chain_bw"] = l2_chain_bw
    del at, bt
    sweep = {}
    for tname, n_t in CTA_SWEEP_ELEMS:
        x = big if n_t == big.numel() else big[:n_t]
        sweep[tname] = cta_sweep(x)
    raw["cta_sweep"] = sweep
    pub = {t.name: t for t in GPU_CHIPS["h100_sxm"].mem_tiers}
    return [dataclasses.replace(pub["L2"], shared_bw=l2_chain_bw),
            dataclasses.replace(
                pub["HBM3"], load_bw=dict(sweep["HBM3"])[1],
                shared_bw=max(dram_bw, max(r for _, r in sweep["HBM3"])))]


_CAL_CACHE: dict = {}


def calibrated_host_model(refresh: bool = False,
                          device="cuda") -> MachineModel:
    """Measure ``device`` and publish the result into the machine
    registry — ``host_cpu`` for the CPU (the reference's host model,
    carrying the measured cache ladder), ``h100_measured`` for the card
    — so compare()/the analyze CLI can address it by name."""
    key = torch.device(device).type
    if key not in _CAL_CACHE or refresh:
        rates = measure_host_rates(device=device)
        raw = rates.pop("_raw")
        if key == "cuda":
            model = measured_gpu_model(
                mxu_flops=raw["flops_matmul"], hbm_bw=raw["stream_bw"],
                tiers=raw["mem_tiers"])
        else:
            model = host_cpu_model(rates, mem_tiers=raw["mem_tiers"])
        _CAL_CACHE[key] = {"model": register(model, replace=True),
                           "raw": dict(raw, rates=dict(rates))}
    return _CAL_CACHE[key]["model"]


def calibration(device="cuda") -> dict:
    """The raw readings behind :func:`calibrated_host_model` (measuring
    first if needed), with the class rates under ``rates``."""
    calibrated_host_model(device=device)
    return _CAL_CACHE[torch.device(device).type]["raw"]


def forget(device="cuda") -> None:
    """Drop a calibration and unregister its model (tests)."""
    from repro_torch.core.machine import MACHINES
    key = torch.device(device).type
    _CAL_CACHE.pop(key, None)
    MACHINES.pop(GPU_MEASURED_NAME if key == "cuda" else "host_cpu", None)


def host_peaks(device="cuda") -> tuple:
    """(peak_flops, mem_bw) for the naive-baseline model on ``device``:
    the measured matmul rate (f32 on the CPU, bf16 on the card) and the
    measured stream."""
    raw = calibration(device)
    return raw["flops_matmul"], raw["stream_bw"]


def mem_tiers(device="cuda") -> tuple:
    """Measured MemTier ladder of ``device``, innermost first."""
    return tuple(calibrated_host_model(device=device).mem_tiers)


def machine_tier_bw(machine, ws_bytes: float) -> float:
    """Combined sustained bytes/s of a machine at the tier a working set
    resolves to, every core streaming: (load + store) x cores, capped by
    a shared tier's ceiling. For the host model (one core, the DRAM
    ceiling its measured stream) it is the reference's ``load_bw +
    store_bw``; for a card's per-SM tiers, the chip's rate."""
    from repro_torch.core import memtier
    from repro_torch.core.machine import get_machine
    m = get_machine(machine)
    t = memtier.resolve_home(memtier.tiers_of(m), ws_bytes)
    bw = t.load_bw + t.store_bw
    if m.cores > 1:                 # a shared ceiling caps the cores' sum
        bw *= m.cores
        if t.shared_bw > 0:
            bw = min(bw, t.shared_bw)
    return bw


def tier_bw(ws_bytes: float, device="cuda") -> float:
    """Combined sustained bytes/s of ``device``'s calibrated model at the
    tier a working set resolves to (:func:`machine_tier_bw`)."""
    return machine_tier_bw(calibrated_host_model(device=device), ws_bytes)
