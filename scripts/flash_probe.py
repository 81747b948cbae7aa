#!/usr/bin/env python3
"""Design variants of the bf16 flash-attention body, timed in turns on one
card at yi-9b's and gemma3-4b's heads (B=1, S=2048, causal and not).

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/flash_probe.py [<variant> ...]

Each variant is ``csrc/flash.cu`` with a few lines replaced (see
``VARIANTS``), compiled with the build's flags into a directory of its own
under the build directory and driven through the same wrapper
(``flash.flash_attention``), by swapping which library ``build.load``
hands it. ``base`` is the source as it stands; ``no_split`` is the base
library under a block plan that splits no tile (every query tile one
block, longest first). Every variant's spills
are printed (none expected), then one line a shape and key tile: each
variant's device time by profiler, the mean of two windows taken in turns
(variants in order, then in reverse), and its TFLOP/s.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: name: (what it changes, [(old, new), ...] in csrc/flash.cu)
VARIANTS = {
    "base": ("the source as it stands", []),
    "no_turns": ("the consumers issue without taking turns", [
        ("const bool turns = R > 64 && q0 + 64 / G < S;",
         "const bool turns = false;")]),
    "three_stages": ("three K and three V stages where they fit", [
        ("static constexpr int STAGES = 2;",
         "static constexpr int STAGES =\n"
         "      Q_BYTES + 6 * TILE_BYTES + 128 + 1024 <= int(kMaxSmem) ? 3 : 2;")]),
    "mask_every_tile": ("the mask evaluated on every tile", [
        ("    if (!full)   // a branch for the whole tile",
         "    if (true)   // a branch for the whole tile")]),
    "no_softmax": ("the softmax of tiles 1 .. n-1 left out (a ceiling, "
                   "not a result)", [("    softmax(j);\n", "")]),
    "no_split": ("no tile split: every query tile one block, longest first",
                 None),
}


def whole_tiles(s, bq, bk, causal, window, per, sms):
    """``flash.block_plan`` with no split tile: query tiles longest first."""
    from repro_torch.kernels.attention import flash as FL
    tiles = FL.key_tiles(s, bq, bk, causal, window)
    order = sorted(range(len(tiles)), key=lambda qt: (-tiles[qt], -qt))
    return len(tiles), tuple(qt * 3 for qt in order)

SHAPES = ((32, 4, 128), (8, 4, 256))   # (H, Hkv, Dh): yi-9b, gemma3-4b
S = 2048


def build_variants(build, chip_smoke, names) -> dict:
    """Every named variant compiled at once; ``{name: library}``."""
    from repro_torch.kernels.attention import flash as FL
    src = (build.CSRC / "flash.cu").read_text()
    jobs = {}
    for name in names:
        if VARIANTS[name][1] is None:
            continue
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in flash.cu")
            text = text.replace(old, new)
        d = build.BUILD_DIR / f"flash_probe_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(d / "lib.so"), str(d / "flash.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log[-4000:]}")
        spills = {k: r for k, r in chip_smoke.ptxas_kernels(log).items()
                  if "bf16" in k and (r[1] or r[2])}
        print(f"variant {name} ({VARIANTS[name][0]}): "
              + (f"SPILLS {spills}" if spills else "no spill"))
        lib = libs[name] = ctypes.CDLL(
            str(build.BUILD_DIR / f"flash_probe_{name}" / "lib.so"))
        for fn, argtypes in FL._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return libs


def use(build, FL, libs, name, plan):
    """Hand the wrapper variant ``name``'s library and block plan."""
    build._LIBS["flash"] = libs.get(name, libs.get("base"))
    FL.block_plan = whole_tiles if name == "no_split" else plan
    FL.block_order.cache_clear()


def main() -> int:
    import torch
    names = sys.argv[1:] or list(VARIANTS)
    if "no_split" in names and "base" not in names:
        names.insert(0, "base")
    if not torch.cuda.is_available() or any(n not in VARIANTS for n in names):
        print(__doc__, file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash as FL

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build_variants(build, chip_smoke, names)
    plan = FL.block_plan
    gen = torch.Generator(device="cuda").manual_seed(3)
    for h, hkv, dh in SHAPES:
        q, k, v = (torch.randn(1, n, S, dh, generator=gen,
                               device="cuda").bfloat16()
                   for n in (h, hkv, hkv))
        for causal in (True, False):
            flops = 4 * (S * (S + 1) // 2 if causal else S * S) * h * dh
            for bk in (b for b in FL.KERNEL_KEY_TILES
                       if 64 <= b <= FL.default_bk(torch.bfloat16, dh)):
                us = {n: 0.0 for n in names}
                for name in names + names[::-1]:
                    use(build, FL, libs, name, plan)
                    us[name] += chip_smoke.timed(
                        torch, lambda: FL.flash_attention(
                            q, k, v, bk=bk, causal=causal, impl="cuda"),
                        20) * 1e3 / 2
                print(f"flash_probe: H={h} Hkv={hkv} Dh={dh} S={S} bk={bk} "
                      f"causal={causal}: " + ", ".join(
                          f"{n} {t:.1f} us ({flops / t / 1e6:.0f} TFLOP/s)"
                          for n, t in us.items()) + " (device time by "
                      "profiler)")
    build._LIBS.pop("flash", None)
    FL.block_plan = plan
    FL.block_order.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
