"""Paper Table III analog: per-op-class throughput and latency.

For the machine files the entries are the model values in
DP-elements/cycle (the paper's unit); for the device the bench runs on
they are ubench-measured (``core/ubench.py``): the host's units/s, or on
the card the chained ops' units/s (elementwise chains there measure a
kernel streaming its operands, not the unit) and the bf16 matmul.
"""

from __future__ import annotations

import torch

from repro_torch.core.machine import MACHINES
from repro_torch.core.ubench import calibration, measure_host_rates

VPU_BLOCK = 8 * 128
CLASSES = ("vpu", "xlu", "vdiv", "vlsu", "gather4", "mxu")


def main(quick: bool = False, device="cuda"):
    lines = []
    for name, m in MACHINES.items():
        for cls in CLASSES:
            e = m.table[cls]
            # effective port count matches the Analyzer's weighted
            # occupation: the slowest (highest-weight) port bounds TP
            if e.port_weights:
                n_ports = sum(e.port_weights) / max(e.port_weights)
            else:
                n_ports = len(e.ports)
            if cls == "mxu":
                # elements/cy for a dense 128x128x128 pass
                per_cy = 128 * 128 * n_ports / e.cycles_per_unit
            else:
                per_cy = VPU_BLOCK * n_ports / e.cycles_per_unit / 2  # DP
            lines.append(f"table3,{name}.{cls},0,"
                         f"dp_elems_per_cy={per_cy:.1f};lat_cy={e.latency:.0f}")
    card = torch.device(device).type == "cuda"
    tag = "h100_measured" if card else "host_cpu"
    if card:        # the calibration's own chains (measured once)
        raw = calibration(device)
        rates = raw["rates"]
    else:
        rates = measure_host_rates(device=device)
        raw = rates.pop("_raw")
    for cls in CLASSES:
        lines.append(f"table3,{tag}.{cls},0,units_per_s={rates[cls]:.3e}")
    lines.append(f"table3,{tag}.matmul,{raw['matmul_s']*1e6:.1f},"
                 f"gflops={raw['flops_matmul']/1e9:.1f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
