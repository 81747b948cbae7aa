"""chip_smoke's phase 13 alone on an H100: the device and build phases,
then ``phase_examples`` (the five scripts of ``examples/torch`` through
their ``main``, and ``serve_lm --mesh`` as two gloo ranks on the card).
Run from the repository root:

    python scripts/chip_smoke_phase13.py
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
        print("chip_smoke_phase13: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    CS.phase_device(torch)
    CS.phase_build(build)
    print("launches by path:", CS.phase_examples(torch, K, cfg_mod))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
