"""chip_smoke's attention-kernel phases alone on an H100: the device and
build phases, the flash bodies' SASS, the decode, paged decode, flash and
row-write checks, the yi-9b dense and paged engines (for the prefill
entry point and the timings' shapes), the three timing phases and the
split sweep. Run from the repository root:

    python scripts/chip_smoke_flash.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as CS  # noqa: E402

if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke_flash: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import numpy as np

    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch import serve
    from repro_torch.kernels import build, stores as S_
    from repro_torch.kernels.attention import decode as D, ops, ref as R
    from repro_torch.models import layers as L, model as M
    from repro_torch.serve import pages as PG
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    CS.phase_device(torch)
    CS.phase_build(build)
    decode_err = CS.phase_decode(torch, D, ops)
    paged_err = CS.phase_paged_decode(torch, D, ops)
    CS.phase_flash_sass(build)
    flash_err = CS.phase_flash(torch, ops, R)
    CS.phase_fused_write(torch, D, ops, S_, K)
    writer_launches = CS.phase_stores(torch, S_, K)
    eng, reqs, launches = CS.phase_engine(torch, np, cfg_mod, M, K, serve)
    flash_launches = CS.phase_prefill_attention(torch, np, eng.cfg, M, L, K,
                                                ops, R, eng.params)
    peng, paged_launches = CS.phase_paged_engine(
        torch, np, cfg_mod, M, K, serve, PG, eng.params, eng.stats())
    rows = CS.phase_timings(torch, np, D, ops, S_, eng, reqs, launches,
                            decode_err, writer_launches)
    rows += CS.phase_new_timings(torch, D, ops, R, S_, peng, reqs,
                                 paged_launches, paged_err, flash_launches,
                                 flash_err)
    CS.phase_wide_timings(torch, D, ops, R, reqs)
    CS.phase_split_sweep(torch, D, ops, eng, reqs)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
