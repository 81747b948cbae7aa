"""Paper Table I analog: core-feature comparison of the TPU generations,
the paper's three CPUs and the port's card (``h100``, its published
figures), plus the measured envelope of the device the bench runs on
(theoretical vs achieved peak): the calibrated host on the CPU,
``h100_measured`` on the card (``core/ubench.py``)."""

from __future__ import annotations

import torch

from repro_torch.core import ubench
from repro_torch.utils.hw import CHIPS, CPU_CHIPS, GPU_CHIPS


def rows(device="cuda"):
    out = []
    for name in ("tpu_v5e", "tpu_v4", "tpu_v5p"):
        c = CHIPS[name]
        out.append({
            "machine": name,
            "bf16_tflops": c.bf16_flops / 1e12,
            "hbm_gb": c.hbm_bytes / 1e9,
            "hbm_gbs": c.hbm_bw / 1e9,
            "ici_gbs_per_link": c.ici_link_bw / 1e9,
            "clock_ghz": c.clock_hz / 1e9,
        })
    g = GPU_CHIPS["h100_sxm"]
    out.append({
        "machine": "h100", "bf16_tflops": g.bf16_flops / 1e12,
        "hbm_gb": g.hbm_bytes / 1e9, "hbm_gbs": g.hbm_bw / 1e9,
        "ici_gbs_per_link": g.nvlink_bw / 2 / 1e9,
        "clock_ghz": g.clock_hz / 1e9,
    })
    card = torch.device(device).type == "cuda"
    peak, bw = ubench.host_peaks(device)
    out.append({
        "machine": "h100_measured" if card else "host_cpu(measured)",
        "bf16_tflops": peak / 1e12,     # bf16 (card) / f32 (host) matmul
        "hbm_gb": g.hbm_bytes / 1e9 if card else 0, "hbm_gbs": bw / 1e9,
        "ici_gbs_per_link": 0,
        "clock_ghz": g.clock_hz / 1e9 if card else 1.0,
    })
    return out


def cpu_rows():
    """Paper Table I: the three actual CPUs, per-core FP32 peak."""
    out = []
    for c in CPU_CHIPS.values():
        lanes = c.simd_width_bytes / 4
        core_gflops = 2 * c.n_fma * lanes * c.clock_hz / 1e9
        out.append({
            "machine": c.name,
            "core_gflops_f32": core_gflops,
            "socket_tflops_f32": core_gflops * c.cores / 1e3,
            "mem_gbs": c.mem_bw / 1e9,
            "clock_ghz": c.clock_hz / 1e9,
            "cores": c.cores, "wa_mode": c.wa_mode,
        })
    return out


def main(quick: bool = False, device="cuda"):
    lines = []
    for r in rows(device):
        lines.append(
            f"table1,{r['machine']},0,"
            f"tflops={r['bf16_tflops']:.1f};bw={r['hbm_gbs']:.0f}GB/s;"
            f"ici={r['ici_gbs_per_link']:.0f}GB/s;"
            f"clock={r['clock_ghz']:.2f}GHz")
    for r in cpu_rows():
        lines.append(
            f"table1,{r['machine']},0,"
            f"core_gflops={r['core_gflops_f32']:.0f};"
            f"socket_tflops={r['socket_tflops_f32']:.1f};"
            f"bw={r['mem_gbs']:.0f}GB/s;clock={r['clock_ghz']:.2f}GHz;"
            f"cores={r['cores']};wa={r['wa_mode']}")

    def _cap(c):
        return str(int(c)) if c != float("inf") else "inf"

    card = torch.device(device).type == "cuda"
    model = ubench.calibrated_host_model(device=device)
    tiers = ";".join(
        f"{t.name}[{_cap(t.capacity_bytes)}]:"
        f"{ubench.machine_tier_bw(model, min(t.capacity_bytes, 1e15)) / 1e9:.1f}GB/s"
        f"{f'/sm={t.load_bw / 1e9:.1f}GB/s' if card else ''}"
        for t in ubench.mem_tiers(device))
    lines.append(f"table1,{'h100_measured' if card else 'host'}"
                 f"_mem_tiers,0,{tiers}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
