#!/usr/bin/env python3
"""Parent against change: the port's CUDA kernels of two checkouts timed
in turns on one card, at chip_smoke's shapes.

Run from the repository root of the change on a machine with the card
and ``nvcc``, with a checkout of the parent commit unpacked somewhere
(``git archive <parent> | tar -x -C <dir>``):

    python3 scripts/torch_kernel_ab.py <dir> [<substring>]

With a substring, only the kernels whose label holds it are timed.

Both checkouts' ``stream``, ``stencil``, ``decode`` and ``flash``
libraries are built from their own ``csrc``; the change's Python
wrappers drive the kernels of both, by swapping which library
``build.load`` hands them, where their C interfaces are the same. The
entry points whose interface changed are bound for the parent as the
parent had them and called directly: the parent's
``pi_integration`` is its partials kernel (``stream_pi_partials``,
``PARENT_PI_SIGNATURE``), then ``parts.sum() / n``, against the change's
one launch; both results' distance from the float64 sum of the IEEE fp32
terms is printed. When a library's C interface changes, bind the
parent's as it was here. Each kernel is
timed parent, change, change, parent with ``chip_smoke.timed`` (device
time by torch.profiler) and printed with its two means and their ratio.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LIBS = ("stream", "stencil", "flash", "decode")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the parent's pi entry point, block partials summed by PyTorch
PARENT_PI_SIGNATURE = {"stream_pi_partials": [_L, _I, _P, _P]}


def parent_lib(build, csrc: str, name: str, signatures: dict):
    """csrc/<name>.cu of the parent, built beside the change's libraries
    under a name of its own digest, with ``signatures`` bound."""
    src = os.path.join(csrc, f"{name}.cu")
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    h.update(open(src, "rb").read())
    for hdr in sorted(os.listdir(csrc)):
        if hdr.endswith(".cuh"):
            h.update(open(os.path.join(csrc, hdr), "rb").read())
    out = build.BUILD_DIR / f"libparent_{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch
    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import decode as D
    from repro_torch.kernels.attention import flash as FL
    from repro_torch.kernels.stream import kernels as SK

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = os.path.join(sys.argv[1], "src", "repro_torch", "kernels", "csrc")
    sigs = {"stream": SK._STREAM_SIGNATURES,
            "stencil": SK._STENCIL_SIGNATURES, "flash": FL._SIGNATURES,
            "decode": D._SIGNATURES}
    new = {n: build.load(n, sigs[n]) for n in LIBS}
    parent_sigs = {**sigs,
                   "stream": {**{k: v for k, v in sigs["stream"].items()
                                 if k != "stream_pi"}, **PARENT_PI_SIGNATURE}}
    old = {n: parent_lib(build, csrc, n, parent_sigs[n]) for n in LIBS}

    def using(libs, fn):
        def call():
            build._LIBS.update(libs)
            fn()
        return call

    gen = torch.Generator(device="cuda").manual_seed(21)
    sh = chip_smoke.STREAM_HBM_SHAPE
    xs = [torch.randn(sh, generator=gen, device="cuda") for _ in range(3)]
    cases = []   # (label, parent call, change call, iters)
    for name, (k, _, _, _, _) in chip_smoke.stream_elementwise(
            torch, None, None).items():
        cases.append((f"{name} f32 {sh}",
                      lambda f=getattr(SK, name), a=xs[:k]: f(*a), 10))
    cases += [
        ("init_store f32", lambda: SK.init_store(sh, 2.0), 10),
        ("init_nt f32", lambda: SK.init_nt(sh, 2.0), 10),
        ("init_partial f32", lambda: SK.init_partial(sh, 2.0), 10)]
    j2 = torch.randn(chip_smoke.JACOBI_2D_SHAPE, generator=gen, device="cuda")
    j3 = torch.randn(chip_smoke.JACOBI_3D_SHAPE, generator=gen, device="cuda")
    gs = torch.randn(chip_smoke.GS_SHAPE, generator=gen, device="cuda")
    gsw = chip_smoke.GS_SWEEPS
    cases += [("jacobi_2d5pt", lambda: SK.jacobi_2d5pt(j2), 10),
              ("jacobi_3d7pt", lambda: SK.jacobi_3d7pt(j3), 5),
              ("sum_reduction f32", lambda: SK.sum_reduction(xs[0]), 10),
              (f"gauss_seidel_2d5pt {chip_smoke.GS_SHAPE} x {gsw}",
               lambda: SK.gauss_seidel_2d5pt(gs, gsw), 3)]
    timed = [(label, using(old, fn), using(new, fn), iters)
             for label, fn, iters in cases]
    pi_n = chip_smoke.PI_N

    def parent_pi():
        """The parent's pi: its block partials, then PyTorch's sum."""
        parts = torch.empty(-(-pi_n // SK.PI_BLOCK), dtype=torch.float32,
                            device="cuda")
        build.check(old["stream"], old["stream"].stream_pi_partials(
            pi_n, SK.PI_BLOCK, parts.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "parent pi")
        return parts.sum() / pi_n

    pi_label = f"pi_integration n=2^{pi_n.bit_length() - 1}"
    timed.insert(len(cases), (pi_label, parent_pi,
                              using(new, lambda: SK.pi_integration(pi_n)),
                              10))

    # decode at the served shape: B=8, H=32, Hkv=4, Dh=128, bf16, 2912
    # live rows, 48 layers' caches cycled so every call reads cold rows
    b, hq, hkv, dh, n_layers = 8, 32, 4, 128, 48
    lens = [300, 410, 180, 471, 350, 260, 500, 433]
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    kc = torch.randn(n_layers, b, 2048, hkv, dh, generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn_like(kc)
    q = torch.randn(b, 1, hq, dh, generator=gen, device="cuda").bfloat16()
    bound, sl, ns = D.split_plan(b, hkv, 2048, 128, None, kv_len)
    layer = [0]

    ps, npg = 16, 8 * 2048 // 16
    kp = kc.view(n_layers, -1, ps, hkv, dh)[:, :npg]
    vp = vc.view(n_layers, -1, ps, hkv, dh)[:, :npg]
    nb = -(-kv_len // ps)
    bt = torch.randperm(npg - 1, generator=torch.Generator().manual_seed(13))[
        :b * nb].reshape(b, nb).int().cuda()
    pb, psl, pns = D.paged_split_plan(b, hkv, ps, nb, None)

    def nxt():
        layer[0] = (layer[0] + 1) % n_layers
        return layer[0]

    dkw = dict(window=None, split_len=sl, n_splits=ns, bound=bound)
    pkw = dict(window=None, split_len=psl, n_splits=pns, bound=pb)
    kn = torch.randn(b, 1, hkv, dh, generator=gen, device="cuda").bfloat16()
    vn = torch.randn_like(kn)
    new_rows = dict(k_new=kn, v_new=vn)

    def dense(fused):
        i = nxt()
        return D.decode_finished(q, kc[i], vc[i], pos, impl="cuda",
                                 **dkw, **(new_rows if fused else {}))

    def paged(fused):
        i = nxt()
        return D.decode_paged_finished(q, kp[i], vp[i], bt, pos,
                                       impl="cuda", **pkw,
                                       **(new_rows if fused else {}))

    decode_cases = {
        "flash_decode finished": lambda: dense(False),
        "flash_decode partials alone": lambda: D.decode_partials(
            q, kc[nxt()], vc[layer[0]], pos, impl="cuda", **dkw),
        "flash_decode with the step's row write": lambda: dense(True),
        "flash_decode_paged finished": lambda: paged(False),
        "flash_decode_paged partials alone": lambda: D.decode_paged_partials(
            q, kp[nxt()], vp[layer[0]], bt, pos, impl="cuda", **pkw),
        "flash_decode_paged with the step's row write": lambda: paged(True),
    }
    timed += [(f"{name} B={b} H={hq} Hkv={hkv} Dh={dh} bf16",
               using(old, fn), using(new, fn), 480)
              for name, fn in decode_cases.items()]
    for s in (512, 2048):
        fq = torch.randn(1, hq, s, dh, generator=gen,
                         device="cuda").bfloat16()
        fk = torch.randn(1, hkv, s, dh, generator=gen,
                         device="cuda").bfloat16()
        fv = torch.randn(1, hkv, s, dh, generator=gen,
                         device="cuda").bfloat16()
        fn = lambda fq=fq, fk=fk, fv=fv: FL.flash_attention(fq, fk, fv)  # noqa: E731
        timed.append((f"flash_attention S={s} H={hq} Hkv={hkv} Dh={dh} "
                      f"bf16 causal", using(old, fn), using(new, fn), 20))

    only = sys.argv[2] if len(sys.argv) == 3 else ""
    for label, p_fn, c_fn, iters in timed:
        if only not in label:
            continue
        t = [chip_smoke.timed(torch, f, iters) * 1e3
             for f in (p_fn, c_fn, c_fn, p_fn)]
        par, chg = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"ab: {label}: parent {t[0]:.2f} / {t[3]:.2f} us, change "
              f"{t[1]:.2f} / {t[2]:.2f} us, change / parent "
              f"{chg / par:.4f} (device time by profiler)")
    build._LIBS.update(new)
    if only in pi_label:
        ref = chip_smoke.pi_reference64(torch, pi_n)
        got = {"parent": parent_pi().item(),
               "change": SK.pi_integration(pi_n).item()}
        print(f"ab: {pi_label}: against the float64 sum of the IEEE fp32 "
              f"terms ({ref!r}): " + ", ".join(
                  f"{k} {v!r} off by {abs(v - ref):.3g}"
                  for k, v in got.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
