"""Paper Fig. 2 adapted: sustained throughput against the execution-unit
mix, on the port.

The counterpart of ``benchmarks/fig2_unitmix.py``: the matmul-only,
vector-only and transcendental-only chains and the 1:1 mix of matmul and
vector steps, each a dependency chain (``x = op(x, ...)``). The
"sustained fraction" column (``overlap_frac``) is the analogue of the
paper's sustained-frequency fraction: 1 when the mix runs as fast as its
slower half alone (full overlap), 0 when it takes the sum of its halves.

On the card each chain is one CUDA-graph replay timed by CUDA events
(``core.ubench._chain``/``_timeit``), at sizes where one step is a
device-bound kernel, not a launch: fp32 matmuls of ``CARD_MAT``
(TF32 off, so the product runs in full fp32) and vector steps over
``CARD_N`` elements. The mixed chain issues its matmul and its vector
halves on two CUDA streams inside one graph, so the card *may* overlap
them, as XLA may in the reference's fused loop. The paper's Fig. 2
(frequency against ISA width) becomes the card's own reading: the SM
clock ``nvidia-smi`` reports right after each chain. On the CPU the
reference's sizes run in eager PyTorch and no clock is read.
"""

from __future__ import annotations

import subprocess

import torch

from repro_torch.core.ubench import _chain, _timeit

#: the reference's host sizes
N, MAT = 1 << 16, 384
#: the card's sizes: a 2048^3 fp32 product (~17 GFLOP) and a 256 MiB
#: vector, each well over a kernel's launch time
CARD_N, CARD_MAT = 1 << 26, 2048
#: chain lengths: matmul, vector, transcendental, mixed (the reference's)
K_MM, K_VEC, K_XLU, K_MIX = 16, 64, 64, 16


def sm_clock_mhz() -> str:
    """The card's SM clock as ``nvidia-smi`` reads it now, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.split("\n")[0].strip()


class _TwoStreamMix:
    """The mixed chain on the card: ``k`` matmul steps on the capture
    stream and ``k`` vector steps on a second stream, forked and joined
    inside one CUDA graph, replayed at every call."""

    def __init__(self, k: int):
        self.k = k
        self.graph = None

    def _run(self, a, w, v):
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            vv = v
            for _ in range(self.k):
                vv = vv * 0.999 + 0.5
        aa = a
        for _ in range(self.k):
            aa = aa @ w
        main.wait_stream(self.side)
        return aa, vv

    def __call__(self, a, w, v):
        if self.graph is None:
            self.side = torch.cuda.Stream(a.device)
            self._run(a, w, v)                     # warm-up, not captured
            torch.cuda.synchronize(a.device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._run(a, w, v)
        self.graph.replay()
        return self.out


def _mixed_host(k: int):
    def f(a, w, v):
        for _ in range(k):
            a, v = a @ w, v * 0.999 + 0.5
        return a, v
    return f


def main(quick: bool = False, device="cuda"):
    dev = torch.device(device)
    card = dev.type == "cuda"
    n, mat = (CARD_N, CARD_MAT) if card else (N, MAT)
    reps = 3 if quick else 5
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, generator=gen, device=dev).abs_() + 0.5
        m = torch.randn(mat, mat, generator=gen, device=dev) * 0.02
        c = x * 0.5
        chains = {
            "matmul_only": (_chain(lambda a, w: a @ w, K_MM, dev), (m, m),
                            K_MM),
            "vector_only": (_chain(lambda v, cc: v * 0.999 + cc, K_VEC, dev),
                            (x, c), K_VEC),
            "xlu_only": (_chain(lambda v: torch.exp(-v), K_XLU, dev), (x,),
                         K_XLU),
            "mixed_mm_vec": (_TwoStreamMix(K_MIX) if card
                             else _mixed_host(K_MIX), (m, m, x), K_MIX),
        }
        t, clock = {}, {}
        for name, (fn, args, k) in chains.items():
            t[name] = _timeit(fn, *args, reps=reps) / k
            clock[name] = sm_clock_mhz() if card else "not measured"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    t_mm, t_vec = t["matmul_only"], t["vector_only"]
    # mixed time vs the ideal (perfect overlap = max of the parts) and
    # the serial sum (no overlap)
    ideal, serial = max(t_mm, t_vec), t_mm + t_vec
    frac = (serial - t["mixed_mm_vec"]) / max(serial - ideal, 1e-12)
    where = torch.cuda.get_device_name(dev) if card else "host"
    sizes = f"n={n};mat={mat};device={where}"
    derived = {
        "matmul_only": f"gflops={2 * mat ** 3 / t_mm / 1e9:.1f}",
        "vector_only": f"gelem={n / t_vec / 1e9:.2f}",
        "xlu_only": f"gelem={n / t['xlu_only'] / 1e9:.2f}",
        "mixed_mm_vec": f"overlap_frac={frac:.2f};"
                        f"streams={2 if card else 1}",
    }
    lines = [f"fig2,{name},{t[name] * 1e6:.1f},{derived[name]};{sizes}"
             for name in chains]
    lines.append("fig2,sm_clock,0," + ";".join(
        f"{name}_mhz={clock[name]}" for name in chains))
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
