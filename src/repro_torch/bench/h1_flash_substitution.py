"""H1.it1, flash-attention substitution, derived from the H1 base
record's per-loop byte attribution (the counterpart of
``benchmarks/h1_flash_substitution.py``).

The attention's kv-chunk walks are the loops of at most S / kv_chunk
trips that move more than 8 MB a trip; the port records every layer's
(it does not scan its layers) forward, recomputed and backward walk
inside the microbatch loop, so their bytes times the microbatches are
the step's. They are replaced by a flash kernel's Q/K/V/O payload.

    PYTHONPATH=src python -m repro_torch.bench.h1_flash_substitution \\
        [results/perf_torch/H1_base.json]
"""

from __future__ import annotations

import json
import sys

from repro_torch.configs import get_config

PATH = "results/perf_torch/H1_base.json"


def main(path: str = PATH, seq: int = 4096, global_batch: int = 256,
         tp: int = 16) -> dict:
    with open(path) as f:
        rec = json.load(f)
    cfg = get_config(rec["arch"])
    pm = rec["portmodel"]
    accum = rec.get("accum_steps", 1)
    max_trips = max(1, seq // cfg.kv_chunk)

    # 1) attention-walk bytes of one microbatch: each loop's trips times
    # its bytes a trip (loop_bytes holds every loop, a visit of its body)
    attn_per_micro = sum(n * b for n, b, _ in pm["loop_bytes"].values()
                         if 1 <= n <= max_trips and b > 8e6)
    total_attn = attn_per_micro * accum

    # 2) the flash kernel's payload: Q, K, V, O a layer pass (forward,
    # recompute, backward twice), the heads over TP
    b_loc = max(1, global_batch // 16 // accum)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
    qkvo = b_loc * seq * (2 * h + 2 * hkv) * dh * 2 / tp
    flash_total = qkvo * cfg.n_layers * accum * 4

    from repro_torch.core.machine import MACHINES
    hbm = MACHINES[pm.get("machine", "h100")].chip.hbm_bw
    before = pm["bytes_hbm"]
    after = before - total_attn + flash_total
    print(f"attention-walk bytes (attributed): {total_attn:.3e} "
          f"({total_attn/before:.1%} of step)")
    print(f"flash Q/K/V/O payload            : {flash_total:.3e}")
    print(f"step bytes  : {before:.3e} -> {after:.3e}")
    print(f"T_mem       : {before/hbm:.3f} s -> {after/hbm:.3f} s "
          f"({(after-before)/before:+.1%})")
    return {"before": before, "after": after,
            "attn_bytes": total_attn, "flash_bytes": flash_total}


if __name__ == "__main__":
    main(*sys.argv[1:2])
