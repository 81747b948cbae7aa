"""Paper Fig. 4: write-allocate evasion — traffic ratio vs utilization for
a store-only kernel, across the behavioural machine modes, the TPU
tile-level RMW model and a measured device row, on the port.

Modeled curves (``wa.ladder_traffic_ratio``, the path fig4b and the
store-flavor selector price through):
  * Grace (auto_claim): flat 1.0 (perfect evasion)
  * SPR (saturation_gated): 2.0 falling toward the DRAM-tier residue
    (1.1) only near saturation; NT stores leave the same ~10% residue
  * Genoa (explicit_only): flat 2.0; NT stores exact 1.0
  * H100 (auto_claim, residue 0 at every tier): flat 1.0

Measured row: a store-only INIT into a fresh buffer (``torch.full``,
a new output each call) against the same buffer reused (``fill_``),
GB/s and their ratio — the counterpart of the reference's fresh vs
donated store. 16 MiB on the CPU, 1 GiB (HBM-resident) on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.machine import get_machine
from repro_torch.core.ubench import _timeit
from repro_torch.core.wa import ladder_traffic_ratio, store_profile

N = 1 << 22             # 16 MiB store (CPU)
CARD_N = 1 << 28        # 1 GiB store (card)

# registered machine name -> paper Fig. 4 curve label
_CURVES = (("neoverse_v2", "grace"), ("golden_cove", "spr"),
           ("zen4", "genoa"), ("h100", "h100"))


def main(quick: bool = False, device="cuda"):
    lines = []
    machines = [(get_machine(name), label) for name, label in _CURVES]
    for cores_frac in (0.1, 0.25, 0.5, 0.75, 1.0):
        parts = []
        for m, label in machines:
            r = ladder_traffic_ratio(m, bw_utilization=cores_frac)
            parts.append(f"{label}={r:.2f}")
            if m.wa_mode != "auto_claim":   # NT stores only change those
                r_nt = ladder_traffic_ratio(m, nt_stores=True,
                                            bw_utilization=cores_frac)
                parts.append(f"{label}_nt={r_nt:.2f}")
        lines.append(f"fig4,model_utilization_{cores_frac:.2f},0,"
                     + ";".join(parts))

    # --- TPU tile-level RMW (the WA analogue) ---
    full = store_profile((4096, 4096), "f32")
    part = store_profile((4095, 4090), "f32")
    mis = store_profile((7, 100), "f32", offset_aligned=False)
    lines.append(f"fig4,tpu_tile_full,0,ratio={full.ratio:.3f}")
    lines.append(f"fig4,tpu_tile_partial_edge,0,ratio={part.ratio:.3f}")
    lines.append(f"fig4,tpu_tile_misaligned_7x100,0,ratio={mis.ratio:.3f}")

    # --- measured: INIT into a fresh buffer vs the same buffer reused ---
    card = torch.device(device).type == "cuda"
    n = CARD_N if card else N
    buf = torch.zeros(n, device=device)
    reps = 3 if quick else 7
    t_fresh = _timeit(lambda b: torch.full((n,), 3.0, device=b.device),
                      buf, reps=reps)
    t_reuse = _timeit(lambda b: b.fill_(3.0), buf, reps=reps)
    tag = "card" if card else "host"
    lines.append(f"fig4,{tag}_fresh_store,{t_fresh*1e6:.1f},"
                 f"bw={4*n/t_fresh/1e9:.2f}GB/s")
    lines.append(f"fig4,{tag}_reused_store,{t_reuse*1e6:.1f},"
                 f"bw={4*n/t_reuse/1e9:.2f}GB/s;fresh_over_reused="
                 f"{t_fresh / max(t_reuse, 1e-12):.3f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
