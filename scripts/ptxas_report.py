#!/usr/bin/env python3
"""Registers, spills and stack of every kernel instantiation in one of
the port's CUDA sources, as ``ptxas -v`` reports them, for the change
and, when given, a parent checkout side by side; and the change's Hopper
instructions, counted in its SASS.

Run from the repository root on a machine with ``nvcc``:

    python3 scripts/ptxas_report.py flash|decode [<parent checkout>]

The change's library is built by ``build.build`` (its report is the
``.log`` kept beside the library); the parent's source is compiled with
the same flags into a scratch file under the build directory. One line a
kernel, by demangled name: registers, spill stores/loads in bytes and
stack frame bytes; a kernel missing on one side shows ``-``. Where the
toolkit has ``cuobjdump``, each of the change's kernels also shows its
Hopper instructions: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tensor
load) for ``flash``; ``UTMALDG`` (the TMA copies of the ring) for
``decode`` (``chip_smoke.DECODE_OPS``).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke  # noqa: E402

#: mangled kernel name: (registers, spill stores, spill loads, stack)
parse = chip_smoke.ptxas_kernels


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 1
    from torch._C import _demangle

    from repro_torch.kernels import build
    name = sys.argv[1]
    build.build((name,))
    lib = build.library_path(name)
    sides = {"change": parse(lib.with_name(lib.name + ".log").read_text())}
    if len(sys.argv) == 3:
        src = os.path.join(sys.argv[2], "src", "repro_torch", "kernels",
                           "csrc", f"{name}.cu")
        out = build.BUILD_DIR / f"ptxas_parent_{name}.so"
        run = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                              str(out), src], capture_output=True, text=True,
                             check=True)
        sides["parent"] = parse(run.stdout + run.stderr)
    by_key = {s: {key(_demangle(k)): r for k, r in side.items()}
              for s, side in sides.items()}
    sass = chip_smoke.library_sass(build, name)
    wanted = chip_smoke.DECODE_OPS if name == "decode" \
        else chip_smoke.HOPPER_OPS
    ops = {} if sass is None else {
        key(_demangle(k)): c
        for k, c in chip_smoke.sass_op_counts(sass, wanted).items()}
    order = list(by_key)[::-1]
    print(f"ptxas -v, {name}.cu: " + " | ".join(
        f"{s}: registers, spill stores/loads (bytes), stack" for s in order)
        + ("; the change's SASS: " + ", ".join(wanted)
           if sass is not None else "; no cuobjdump"))
    for kern in sorted(set().union(*by_key.values())):
        cols = []
        for s in order:
            r = by_key[s].get(kern)
            cols.append("-" if r is None else
                        f"{r[0]} regs, {r[1]}/{r[2]} spill, {r[3]} stack")
        if kern in ops:
            cols.append(", ".join(f"{op} {n}" for op, n in ops[kern].items()))
        print(f"  {kern}: " + " | ".join(cols))
    return 0


def key(demangled: str) -> str:
    """A kernel's name and template arguments, the parameter list left
    out; the decode bodies' former names (``decode_partials_kernel``,
    ``decode_partials_f32_kernel``) map to their present ones, and their
    three template arguments before the WRITE flag to the
    instantiation with WRITE false."""
    m = re.search(r"(\w+<[^()]*>)\(", demangled)
    name = m.group(1) if m else demangled
    name = name.replace("decode_partials_", "decode_")
    if re.fullmatch(r"decode_(f32_)?kernel<[^,]+, [^,]+, [^,]+>", name):
        name = name[:-1] + ", false>"
    return name


if __name__ == "__main__":
    sys.exit(main())
