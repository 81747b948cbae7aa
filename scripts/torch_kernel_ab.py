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
parent had them and called directly. ``flash_attention`` is timed at
yi-9b's and gemma3-4b's heads, and both outputs' distance from the fp32
plain version is printed, as both pi results' from the float64 sum of
the IEEE fp32 terms. The parent's decode entry points
(``PARENT_DECODE_SIGNATURES``, the split counters of the merge through
L2 after ``out``) are called directly with a zeroed counter tensor and
the parent's partials workspace, at the parent's split plan (its
``default_splits`` had no cap at the 8 splits a launch now merges:
``parent_splits``), the change through its wrappers; the decode cases
are yi-9b's served shape dense and paged (finished, partials alone, with
the step's row write), gemma3-4b's
served shape (the serving path's 128-row plan and the tuner's 64-row
one, beside one ``scaled_dot_product_attention`` call with
``enable_gqa`` and a live-row mask, which the port never calls), the
sequence-sharded path's partials (8 slots, 192 rows, 2 splits, bf16 and
fp32) and shapes where that cap binds (B = 1 and 2 over 8192
rows: the parent's 33 and 16 splits against 8). When a library's C
interface changes, bind the parent's as it was here. Each kernel is
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
#: the parent's decode entry points (a split-counter pointer after `out`)
PARENT_DECODE_SIGNATURES = {
    "flash_decode": [_P] * 11 + [_I] * 6 + [_L] * 4 + [_I] * 6
    + [ctypes.c_float, _P],
    "flash_decode_paged": [_P] * 12 + [_I] * 10 + [_L] * 4 + [_I] * 5
    + [ctypes.c_float, _P]}
#: the parent's SMs a wave (its default split count had no merge cap)
PARENT_SMS = 132


def parent_splits(b: int, hkv: int, n_blocks: int) -> int:
    """The parent's ``default_splits``: the most splits one wave holds."""
    return max(1, min(n_blocks, PARENT_SMS // (b * hkv)))


def parent_libs(build, csrc: str, signatures: dict) -> dict:
    """csrc/<name>.cu of the parent for each name of ``signatures``, built
    at once beside the change's libraries under names of their own digest,
    with each one's signatures bound."""
    outs, jobs = {}, []
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in signatures:
        src = os.path.join(csrc, f"{name}.cu")
        h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        h.update(open(src, "rb").read())
        for hdr in sorted(os.listdir(csrc)):
            if hdr.endswith(".cuh"):
                h.update(open(os.path.join(csrc, hdr), "rb").read())
        out = outs[name] = (build.BUILD_DIR /
                            f"libparent_{name}-{h.hexdigest()[:16]}.so")
        if not out.exists():
            jobs.append(subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    if any(j.wait() for j in jobs):
        raise RuntimeError("a parent library failed to build")
    libs = {}
    for name, out in outs.items():
        lib = libs[name] = ctypes.CDLL(str(out))
        for fn, argtypes in signatures[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return libs


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
    build.build(LIBS)
    new = {n: build.load(n, sigs[n]) for n in LIBS}
    old = parent_libs(build, csrc, {**sigs, "decode": PARENT_DECODE_SIGNATURES})

    def using(libs, fn):
        def call():
            build._LIBS.update(libs)
            return fn()
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
    pi_label = f"pi_integration n=2^{pi_n.bit_length() - 1}"
    timed.append((pi_label, using(old, lambda: SK.pi_integration(pi_n)),
                  using(new, lambda: SK.pi_integration(pi_n)), 10))

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
    layer = [0]

    ps, npg = 16, 8 * 2048 // 16
    kp = kc.view(n_layers, -1, ps, hkv, dh)[:, :npg]
    vp = vc.view(n_layers, -1, ps, hkv, dh)[:, :npg]
    nb = -(-kv_len // ps)
    bt = torch.randperm(npg - 1, generator=torch.Generator().manual_seed(13))[
        :b * nb].reshape(b, nb).int().cuda()
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")

    def nxt(n=n_layers):
        layer[0] = (layer[0] + 1) % n
        return layer[0]

    def parent_decode(q, k, v, pos, table=None, *, split_len, n_splits,
                      bound, finished=True, k_new=None, v_new=None):
        """One launch of the parent's dense or paged kernel: its output,
        or its partials' workspace."""
        b, sq, h, dh = q.shape
        ws = o = m = l = None
        if not finished or n_splits > 1 or (q.dtype == torch.float32
                                            and dh == 256):
            n, mo, lo = D.workspace_layout(n_splits, b, sq, h, dh)
            ws = torch.empty(n, dtype=torch.float32, device=q.device)
            o = ws.data_ptr()
            m, l = o + 4 * mo, o + 4 * lo
        out = torch.empty_like(q) if finished else None
        ptrs = (o, m, l, None if out is None else out.data_ptr(),
                counters.data_ptr() if finished and n_splits > 1 else None,
                None if k_new is None else k_new.data_ptr(),
                None if v_new is None else v_new.data_ptr(),
                D._DTYPE_CODES[q.dtype], b, sq, h, k.shape[2], dh)
        tail = (n_splits, split_len, bound, 0, 1.0 / dh ** 0.5,
                torch.cuda.current_stream().cuda_stream)
        lib = old["decode"]
        if table is None:
            rc = lib.flash_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                *ptrs, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                k.shape[1], 0, *tail)
        else:
            rc = lib.flash_decode_paged(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                pos.data_ptr(), *ptrs, table.stride(0), table.shape[1],
                k.shape[0], k.shape[1], k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), 0, *tail)
        build.check(lib, rc, "parent decode")
        return out if finished else ws

    kn = torch.randn(b, 1, hkv, dh, generator=gen, device="cuda").bfloat16()
    vn = torch.randn_like(kn)
    new_rows = dict(k_new=kn, v_new=vn)
    nblk = -(-kv_len // 128)
    bound, sl, ns = D.split_plan(b, hkv, 2048, 128, None, kv_len)
    pbound, psl, pns = D.split_plan(b, hkv, 2048, 128,
                                    parent_splits(b, hkv, nblk), kv_len)
    gb, gsl, gns = D.paged_split_plan(b, hkv, ps, nb, None)
    pgb, pgsl, pgns = D.paged_split_plan(b, hkv, ps, nb,
                                         parent_splits(b, hkv, nb))
    dkw = dict(window=None, split_len=sl, n_splits=ns, bound=bound)
    dpk = dict(split_len=psl, n_splits=pns, bound=pbound)
    gkw = dict(window=None, split_len=gsl, n_splits=gns, bound=gb)
    gpk = dict(split_len=pgsl, n_splits=pgns, bound=pgb)
    decode_cases = {
        "flash_decode finished": (
            lambda: parent_decode(q, kc[nxt()], vc[layer[0]], pos, **dpk),
            lambda: D.decode_finished(q, kc[nxt()], vc[layer[0]], pos,
                                      impl="cuda", **dkw)),
        "flash_decode partials alone": (
            lambda: parent_decode(q, kc[nxt()], vc[layer[0]], pos,
                                  finished=False, **dpk),
            lambda: D.decode_partials(q, kc[nxt()], vc[layer[0]], pos,
                                      impl="cuda", **dkw)),
        "flash_decode with the step's row write": (
            lambda: parent_decode(q, kc[nxt()], vc[layer[0]], pos, **dpk,
                                  **new_rows),
            lambda: D.decode_finished(q, kc[nxt()], vc[layer[0]], pos,
                                      impl="cuda", **dkw, **new_rows)),
        "flash_decode_paged finished": (
            lambda: parent_decode(q, kp[nxt()], vp[layer[0]], pos, bt,
                                  **gpk),
            lambda: D.decode_paged_finished(q, kp[nxt()], vp[layer[0]], bt,
                                            pos, impl="cuda", **gkw)),
        "flash_decode_paged partials alone": (
            lambda: parent_decode(q, kp[nxt()], vp[layer[0]], pos, bt,
                                  finished=False, **gpk),
            lambda: D.decode_paged_partials(q, kp[nxt()], vp[layer[0]], bt,
                                            pos, impl="cuda", **gkw)),
        "flash_decode_paged with the step's row write": (
            lambda: parent_decode(q, kp[nxt()], vp[layer[0]], pos, bt,
                                  **gpk, **new_rows),
            lambda: D.decode_paged_finished(q, kp[nxt()], vp[layer[0]], bt,
                                            pos, impl="cuda", **gkw,
                                            **new_rows)),
    }
    timed += [(f"{name} B={b} H={hq} Hkv={hkv} Dh={dh} bf16 "
               f"({ns} splits; parent {pns if 'paged' not in name else pgns})",
               pfn, using(new, cfn), 480)
              for name, (pfn, cfn) in decode_cases.items()]

    # gemma3-4b served: chip_smoke's split-sweep positions (its prompts
    # plus 32 decoded tokens), 16 random layers, the 1792-row bucket
    gl = 16
    gk = torch.randn(gl, b, 2048, 4, 256, generator=gen,
                     device="cuda").bfloat16()
    gv = torch.randn_like(gk)
    gq = torch.randn(b, 1, 8, 256, generator=gen, device="cuda").bfloat16()
    gpos = torch.randint(*chip_smoke.GEMMA_PROMPT_LENS, (b,),
                         generator=torch.Generator().manual_seed(23),
                         dtype=torch.int32).cuda() + 32
    gbound = min(-(-(int(gpos.max()) + 1) // 128) * 128, 2048)
    live = int((gpos + 1).clamp(max=gbound).sum())
    tuner = chip_smoke.tuner_plan(gq, 4, gbound)
    for what, bk in (("the serving path's 128-row plan", 128),
                     (f"the tuner's {tuner.bk}-row plan", tuner.bk)):
        bnd, gs, gn = D.split_plan(b, 4, 2048, bk, None, gbound)
        _, pgs, pgn = D.split_plan(b, 4, 2048, bk, parent_splits(
            b, 4, -(-gbound // bk)), gbound)
        kw = dict(window=None, split_len=gs, n_splits=gn, bound=bnd)
        pkw = dict(split_len=pgs, n_splits=pgn, bound=bnd)
        timed.append((
            f"flash_decode gemma3-4b served B={b} H=8 Hkv=4 Dh=256 bf16, "
            f"{live} live rows, {what} ({gn} splits; parent {pgn})",
            lambda pkw=pkw: parent_decode(gq, gk[nxt(gl)], gv[layer[0]],
                                          gpos, **pkw),
            using(new, lambda kw=kw: D.decode_finished(
                gq, gk[nxt(gl)], gv[layer[0]], gpos, impl="cuda", **kw)),
            480))
    gmask = (torch.arange(gbound, device="cuda")[None, :]
             <= gpos[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_gemma():
        i = nxt(gl)
        sdpa(gq.transpose(1, 2), gk[i, :, :gbound].transpose(1, 2),
             gv[i, :, :gbound].transpose(1, 2), attn_mask=gmask,
             enable_gqa=True)
    timed.append((f"library for flash_decode gemma3-4b served: "
                  f"scaled_dot_product_attention (enable_gqa, a live-row "
                  f"mask), {gbound} rows, {live} live (both columns the "
                  f"same call)",
                  library_gemma, library_gemma, 480))

    # the sequence-sharded path's partials (chip_smoke 11c): 8 slots, 192
    # rows a rank, every row live, 2 splits
    for dtype in (torch.bfloat16, torch.float32):
        sq_ = torch.randn(b, 1, hq, dh, generator=gen, device="cuda").to(
            dtype)
        sk = torch.randn(n_layers, b, 192, hkv, dh, generator=gen,
                         device="cuda").to(dtype)
        sv = torch.randn_like(sk)
        spos = torch.full((b,), 383, dtype=torch.int32, device="cuda")
        sb, ssl, sns = D.split_plan(b, hkv, 192, 128, None, 192)
        skw = dict(split_len=ssl, n_splits=sns, bound=sb)
        timed.append((
            f"flash_decode partials, the sequence-sharded path's shape "
            f"(8 slots, 192 rows, {sns} splits) {str(dtype)[6:]}",
            lambda sq_=sq_, sk=sk, sv=sv, spos=spos, skw=skw: parent_decode(
                sq_, sk[nxt()], sv[layer[0]], spos, finished=False, **skw),
            using(new, lambda sq_=sq_, sk=sk, sv=sv, spos=spos, skw=skw:
                  D.decode_partials(sq_, sk[nxt()], sv[layer[0]], spos,
                                    window=None, impl="cuda", **skw)),
            480))

    # where the merge cap binds: B = 1 and 2 at yi-9b's heads over 8192
    # live rows (the parent's default 33 and 16 splits, the change's 8)
    for cb in (1, 2):
        ck = torch.randn(8, cb, 8192, hkv, dh, generator=gen,
                         device="cuda").bfloat16()
        cv = torch.randn_like(ck)
        cq = torch.randn(cb, 1, hq, dh, generator=gen,
                         device="cuda").bfloat16()
        cpos = torch.full((cb,), 8191, dtype=torch.int32, device="cuda")
        cbd, csl, cns = D.split_plan(cb, hkv, 8192, 128, None, None)
        _, pcsl, pcns = D.split_plan(cb, hkv, 8192, 128,
                                     parent_splits(cb, hkv, 64), None)
        ckw = dict(window=None, split_len=csl, n_splits=cns, bound=cbd)
        pckw = dict(split_len=pcsl, n_splits=pcns, bound=cbd)
        timed.append((
            f"flash_decode finished, merge cap binding: B={cb} H={hq} "
            f"Hkv={hkv} Dh={dh} bf16, 8192 live rows ({cns} splits; "
            f"parent {pcns})",
            lambda cq=cq, ck=ck, cv=cv, cpos=cpos, pckw=pckw: parent_decode(
                cq, ck[nxt(8)], cv[layer[0]], cpos, **pckw),
            using(new, lambda cq=cq, ck=ck, cv=cv, cpos=cpos, ckw=ckw:
                  D.decode_finished(cq, ck[nxt(8)], cv[layer[0]], cpos,
                                    impl="cuda", **ckw)), 240))

    for fh, fhkv, fdh, s in ((hq, hkv, dh, 512), (hq, hkv, dh, 2048),
                             (8, 4, 256, 2048)):
        fq = torch.randn(1, fh, s, fdh, generator=gen,
                         device="cuda").bfloat16()
        fk = torch.randn(1, fhkv, s, fdh, generator=gen,
                         device="cuda").bfloat16()
        fv = torch.randn(1, fhkv, s, fdh, generator=gen,
                         device="cuda").bfloat16()
        fn = lambda fq=fq, fk=fk, fv=fv: FL.flash_attention(fq, fk, fv)  # noqa: E731
        pfn = using(old, fn)
        want = FL.R.attention(fq.float(), fk.float(), fv.float())
        errs = [(f().float() - want).abs().max().item()
                for f in (pfn, using(new, fn))]
        print(f"ab: flash_attention S={s} H={fh} Hkv={fhkv} Dh={fdh}: max "
              f"abs err against the fp32 plain version: parent {errs[0]:.3g},"
              f" change {errs[1]:.3g}")
        timed.append((f"flash_attention S={s} H={fh} Hkv={fhkv} Dh={fdh} "
                      f"bf16 causal", pfn, using(new, fn), 20))

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
        got = {}
        for side, libs in (("parent", old), ("change", new)):
            build._LIBS.update(libs)
            got[side] = SK.pi_integration(pi_n).item()
        print(f"ab: {pi_label}: against the float64 sum of the IEEE fp32 "
              f"terms ({ref!r}): " + ", ".join(
                  f"{k} {v!r} off by {abs(v - ref):.3g}"
                  for k, v in got.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
