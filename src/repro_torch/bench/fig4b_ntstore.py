"""Paper Fig. 4 (b): NT-store evasion — per-machine store-traffic ratio
of the *selected* store flavor vs the standard path, gated, on the port.

For the paper's three machines, the TPU and the port's card the
benchmark

1. asks the store-path selector (``repro_torch.kernels.stores``) which
   flavor it picks for a DRAM/HBM-resident store stream,
2. prices both flavors through the shared ladder-residue path
   (``wa.ladder_traffic_ratio``), and checks that the selected flavor's
   ratio equals ``wa.priced_store_traffic`` on a full-tile store of the
   same payload, and
3. runs the port's ``stream_triad_nt`` (the hand-written kernel on the
   card, the plain version on the CPU) against the plain version: the
   kernel pads nothing (on Hopper a store is streaming by its
   instruction, not its tile), so its store footprint is its payload.

The gate (asserted when run): the reference's — Grace <= SPR <=
Zen4-with-NT within the SpecI2M NT-residue tolerance (0.15), the
standard-flavor ordering Grace <= SPR <= Zen4, Zen4's NT ~1.0 against
~2.0 standard, Zen4 ``nt`` and Grace ``standard`` — and the card's:
``h100`` selects ``standard`` at a ratio within Grace's + 0.15.

A measured row rides along: the STREAM triad through the standard and
the NT store path, GB/s (on the card the two kernels, 1 GiB an array).
It is reported, not gated.
"""

from __future__ import annotations

import torch

from repro_torch.core import wa
from repro_torch.core.machine import get_machine
from repro_torch.core.ubench import _timeit
from repro_torch.kernels.stores import plan_stores
from repro_torch.kernels.stream import ops as K
from repro_torch.kernels.stream import ref as R

#: registered machine name -> paper Fig. 4 curve label
_CURVES = (("neoverse_v2", "grace"), ("golden_cove", "spr"),
           ("zen4", "genoa"), ("tpu_v5e", "tpu"), ("h100", "h100"))

#: ordering tolerance: the SpecI2M NT residue (golden_cove DRAM-tier
#: ``wa_residue`` = 0.1, plus headroom)
ORDER_TOL = 0.15

#: modeled-vs-priced agreement tolerance for the selected flavor
PRICE_TOL = 1e-6

N_ROWS, N_COLS = 1 << 8, 1 << 12      # 4 MiB f32 stream payload
#: the measured triad's arrays: 16 MiB on the CPU, 1 GiB on the card
N_TRIAD, CARD_N_TRIAD = 1 << 22, 1 << 28


def kernel_footprint(device="cuda", shape=(20, 300)) -> float:
    """Stored bytes over payload of the NT triad on a tile-misaligned
    shape, after holding it against the plain version (exact: both
    round the product before the add)."""
    gen = torch.Generator(device=device).manual_seed(4)
    b = torch.randn(shape, generator=gen, device=device)
    c = torch.randn(shape, generator=gen, device=device)
    out = K.stream_triad(b, c, flavor="nt")
    assert torch.equal(out, R.stream_triad(b, c)), "NT triad parity"
    return out.numel() * out.element_size() / float(b.numel() * 4)


def main(quick: bool = False, device="cuda"):
    lines = []
    big = float(N_ROWS * N_COLS * 4) * 256   # clearly DRAM/HBM-resident
    ratios = {}
    for name, label in _CURVES:
        plan = plan_stores(name, ws_bytes=big)
        ratios[label] = plan
        lines.append(
            f"fig4b,{label},0,flavor={plan.flavor};"
            f"ratio={plan.ratio:.3f};std={plan.ratio_standard:.3f};"
            f"nt={plan.ratio_nt:.3f};sat={plan.saturation:.2f};"
            f"wa_mode={plan.wa_mode}")
        payload = float(N_ROWS * N_COLS * 4)
        prof = wa.store_profile((N_ROWS, N_COLS), "f32")
        priced = wa.priced_store_traffic(prof, get_machine(name),
                                         ws_bytes=big, flavor=plan.flavor)
        modeled = payload * plan.ratio
        assert abs(priced - modeled) <= PRICE_TOL * max(modeled, 1.0), (
            f"{name}: priced {priced} != modeled {modeled}")
        lines.append(f"fig4b,{label}_priced,0,"
                     f"priced_bytes={priced:.0f};"
                     f"modeled_bytes={modeled:.0f}")

    grace, spr, zen = ratios["grace"], ratios["spr"], ratios["genoa"]
    h100 = ratios["h100"]
    assert grace.ratio <= spr.ratio + ORDER_TOL, (grace, spr)
    assert spr.ratio <= zen.ratio + ORDER_TOL, (spr, zen)
    assert grace.ratio_standard <= spr.ratio_standard <= \
        zen.ratio_standard, (grace, spr, zen)
    assert abs(zen.ratio_nt - 1.0) < 0.05, zen
    assert abs(zen.ratio_standard - 2.0) < 0.05, zen
    assert zen.flavor == "nt" and grace.flavor == "standard", (zen, grace)
    assert h100.flavor == "standard", h100
    assert h100.ratio <= grace.ratio + ORDER_TOL, (h100, grace)
    lines.append("fig4b,gate,0,ordering=ok;zen4_nt="
                 f"{zen.ratio_nt:.2f};zen4_std={zen.ratio_standard:.2f};"
                 f"h100={h100.flavor}:{h100.ratio:.2f};tol={ORDER_TOL}")

    lines.append(f"fig4b,nt_kernel_footprint,0,"
                 f"stored_over_payload={kernel_footprint(device):.3f}")

    # --- measured: the triad through each store path (reported only) ---
    card = torch.device(device).type == "cuda"
    n = CARD_N_TRIAD if card else N_TRIAD
    gen = torch.Generator(device=device).manual_seed(5)
    b = torch.randn(n, generator=gen, device=device)
    c = torch.randn(n, generator=gen, device=device)
    tag = "card" if card else "host"
    times = {}
    for flavor in ("standard", "nt"):
        t = _timeit(lambda x, y, f=flavor: K.stream_triad(x, y, flavor=f),
                    b, c, reps=3 if quick else 7)
        times[flavor] = t
        lines.append(f"fig4b,{tag}_triad_{flavor},{t*1e6:.1f},"
                     f"bw={3*4*n/t/1e9:.2f}GB/s")
    lines.append(f"fig4b,{tag}_triad_nt_over_standard,0,"
                 f"time_ratio={times['nt'] / times['standard']:.4f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
