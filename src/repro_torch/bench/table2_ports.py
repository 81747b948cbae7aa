"""Paper Table II analog: in-core features / port models of every
registered machine — the three TPU generations, the paper's three CPUs,
the port's card (``h100``) and the calibrated model of the device the
bench runs on (``host_cpu``, or ``h100_measured`` on the card)."""

from __future__ import annotations

from repro_torch.core.machine import registered_models
from repro_torch.core.ubench import calibrated_host_model


def main(quick: bool = False, device="cuda"):
    lines = []
    calibrated_host_model(device=device)    # registers its model
    for m in registered_models():
        n_mxu = len(m.entry("mxu").ports)
        n_vpu = len(m.entry("vpu").ports)
        n_ls = len(m.entry("vlsu").ports)
        lines.append(
            f"table2,{m.name},0,"
            f"vendor={m.vendor or 'host'};ports={len(m.ports)};"
            f"fma_or_mxu={n_mxu};simd_or_vpu={n_vpu};ldst={n_ls};"
            f"issue_width={m.issue_width};"
            f"simd_bytes={m.simd_width_bytes};wa_mode={m.wa_mode};"
            f"mxu_cyc_per_pass={m.entry('mxu').cycles_per_unit:.0f};"
            f"vdiv_port={m.entry('vdiv').ports[0]};"
            f"vpu_lat={m.entry('vpu').latency:.0f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
