#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the ``repro`` package and builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc`` itself.
Phases, each printed on its own line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both kernels compiled in parallel with ``nvcc``;
3. the split-KV decode kernel against its plain PyTorch version at
   yi-9b's head shapes (B=8, H=32, Hkv=4, Dh=128, bf16): Skv 4096 and
   4095, per-slot positions spread over the cache, Sq 1 and 4, no window
   and a 256-row window, one split and the default split count; and a
   2048-row cache read up to the serving path's occupancy bounds (kv_len
   472 and 301, rounded up to 128-row blocks, and 301 unrounded);
4. the KV row writer against its plain version, both store flavors,
   byte for byte, with a clamped overshoot row, in place;
5. the full-width 48-layer yi-9b ``ServeEngine`` (random weights from a
   seeded generator on the card): 16 greedy requests, prompts of 128 to
   512 tokens, 64 new tokens each, 8 slots, a 2048-row horizon, 8-token
   chunks. Kernel launch counts are zeroed just before the run and read
   just after. One decode step's logits through the kernels are held
   against the same step with ``impl="ref"`` for four prompt sets, and a
   smoke-size fp32 engine's greedy streams on the card against the same
   engine on the CPU;
6. per kernel its time at the path's shapes, its bound, its plain
   version's time and a library call's time, then two full-width decode
   dispatches of the same 8 requests timed once on the wall clock and
   once under the profiler: the device's busy time per step, its idle
   share and where the time goes; the ``kernels`` JSON line comes last
   but one.

TF32 is switched off for matmuls and cuDNN, so fp32 references on the
card run in full fp32. Any failed phase raises and the script exits
non-zero; so does a machine without a CUDA device, or a directory
without the repository's ``src/repro_torch``. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores

# yi-9b head shapes of the serving path
B, H, HKV, DH = 8, 32, 4, 128
# tolerances. The decode kernel and its plain version both compute in
# fp32 from the same bf16 inputs; they differ only in summation order and
# exp rounding, so the normalized fp32 outputs agree to ~1e-6.
DECODE_TOL = 1e-4
# the router's bf16 output against the fp32 dense oracle: one bf16
# rounding (half an ulp, at most 2**-6 for the magnitudes below 8 that
# softmax-weighted unit normals take)
BF16_OUT_TOL = 2 ** -6
# one decode step at full width, kernels vs impl="ref" (their plain
# versions): both attention paths sum in fp32 in different orders, so a
# layer's bf16 attention output can differ by one ulp where the sums
# straddle a rounding boundary, and 48 random-weight layers amplify such
# flips. Held as max |diff| over max |logit|, for each of four prompt
# sets. On an H100 the served prompts read 0.0204 and 0.0236 in two
# runs; the limit leaves twice that room for other prompt sets (their
# spread is recorded in PERF.md). A wrong occupancy bound or split is
# caught at 1e-4 by the kernel cases of phase 3, not here.
LOGITS_REL_TOL = 5e-2
LOGITS_SEEDS = (11, 12, 13)       # prompt sets beside the served prompts


class PhaseError(RuntimeError):
    """A smoke phase failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def device_us(prof) -> dict:
    """Device microseconds by name: every kernel, copy and fill the
    profile saw on the card (host-side operator rows are left out, so
    no kernel is counted twice)."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return out


def timed(torch, fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds of device work per ``fn()`` call.

    The device time of every kernel, copy and fill that ``iters`` calls
    launch, summed from ``torch.profiler``, over ``iters``: host launch
    overhead between calls does not count. A profile with no device time
    fails the phase.
    """
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(prof).values())
    check(us > 0, "timing: the profiler saw no device time")
    return us / 1e3 / iters


# --- phase 1: device -------------------------------------------------------

def phase_device(torch) -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


# --- phase 2: build --------------------------------------------------------

def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    dt = time.perf_counter() - t0
    print(f"build: compiled {built or 'nothing (up to date)'} in {dt:.1f} s")
    for name in build.SOURCES:
        log = build.library_path(name).with_name(
            build.library_path(name).name + ".log")
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"build: {name}: {ln.strip()}")


# --- phase 3: decode kernel ------------------------------------------------

def phase_decode(torch, D, ops) -> float:
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    cases = 0

    def case(q, k, v, pos, window, bound, split_len, n, what):
        nonlocal worst, cases
        dense = D.ref_decode(q.float(), k.float(), v.float(), pos,
                             window=window, kv_len=bound)
        kw = dict(window=window, split_len=split_len, n_splits=n,
                  bound=bound)
        ok_, mk, lk = D.decode_partials(q, k, v, pos, impl="cuda", **kw)
        orf, mr, lr = D.decode_partials(q, k, v, pos, impl="ref", **kw)
        torch.cuda.synchronize()
        got = D.combine_splits(ok_, mk, lk)
        ref = D.combine_splits(orf, mr, lr)
        err = (got - ref).abs().max().item()
        err_dense = (got - dense.float()).abs().max().item()
        check(torch.equal(lk == 0, lr == 0), f"decode: dead splits differ "
              f"({what} bound={bound} n_splits={n})")
        check(err <= DECODE_TOL and err_dense <= DECODE_TOL,
              f"decode: max err {err:.3g} (dense {err_dense:.3g}) > "
              f"{DECODE_TOL} at {what} bound={bound} n_splits={n}")
        worst = max(worst, err)
        cases += 1

    for skv in (4096, 4095):
        k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
        for sq in (1, 4):
            # per-slot positions spread over the whole cache
            pos = torch.linspace(0, skv - sq, B, device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen, device="cuda").bfloat16()
            for window in (None, 256):
                for ns in (1, None):
                    bound, split_len, n = D.split_plan(B, HKV, skv, 128, ns,
                                                       None)
                    case(q, k, v, pos, window, bound, split_len, n,
                         f"skv={skv} sq={sq} window={window}")
    # the served path's cut: a 2048-row horizon read only up to the
    # occupancy bound, as ops.flash_decode rounds it (472 -> 512 and
    # 301 -> 384), and one bound left ragged inside a 128-row block
    skv = 2048
    k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    for kv_len, rounded in ((472, True), (301, True), (301, False)):
        bound = min(-(-kv_len // 128) * 128, skv) if rounded else kv_len
        for sq in (1, 4):
            pos = torch.linspace(0, kv_len - sq, B, device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen, device="cuda").bfloat16()
            bound_, split_len, n = D.split_plan(B, HKV, skv, 128, None, bound)
            check(bound_ == bound, f"decode: split_plan bound {bound_}")
            case(q, k, v, pos, None, bound, split_len, n,
                 f"skv={skv} kv_len={kv_len} sq={sq}")
            if rounded:
                # the router's own rounding reaches the same bound
                got = ops.flash_decode(q, k, v, pos, kv_len=kv_len,
                                       impl="cuda").float()
                want = D.ref_decode(q.float(), k.float(), v.float(), pos,
                                    kv_len=bound)
                err = (got - want).abs().max().item()
                check(err <= BF16_OUT_TOL, f"decode: ops.flash_decode err "
                      f"{err:.3g} > {BF16_OUT_TOL} at kv_len={kv_len}")
    print(f"decode kernel: {cases} cases vs plain version, max abs err "
          f"{worst:.3g} (tol {DECODE_TOL}, fp32 outputs), incl. occupancy "
          f"bounds 512, 384 and 301 of a 2048-row cache")
    return worst


# --- phase 4: KV row writer ------------------------------------------------

def phase_stores(torch, S_) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4)
    s = 2048
    for sq in (1, 4):
        # slot 7 overshoots the horizon: its start clamps to s - sq
        pos = torch.tensor([0, 5, 100, 1000, 2047 - sq, s - sq, 2046, 2047 + 3],
                           dtype=torch.int32, device="cuda")
        kn = torch.randn(B, sq, HKV, DH, generator=gen, device="cuda").bfloat16()
        vn = torch.randn(B, sq, HKV, DH, generator=gen, device="cuda").bfloat16()
        for flavor in ("standard", "nt"):
            kc = torch.randn(B, s, HKV, DH, generator=gen, device="cuda").bfloat16()
            vc = torch.randn(B, s, HKV, DH, generator=gen, device="cuda").bfloat16()
            kr, vr = kc.clone(), vc.clone()
            ptrs = (kc.data_ptr(), vc.data_ptr())
            S_.kv_row_update(kc, vc, kn, vn, pos, flavor=flavor, impl="cuda")
            S_.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor, impl="ref")
            torch.cuda.synchronize()
            check((kc.data_ptr(), vc.data_ptr()) == ptrs,
                  "stores: cache storage moved")
            check(torch.equal(kc.view(torch.int16), kr.view(torch.int16))
                  and torch.equal(vc.view(torch.int16), vr.view(torch.int16)),
                  f"stores: {flavor} sq={sq} not byte-identical to plain")
            check(torch.equal(kc[7, s - sq:].view(torch.int16),
                              kn[7].view(torch.int16)),
                  "stores: overshoot row not clamped to the last rows")
    print("kv writer: standard and nt byte-identical to plain version "
          "(sq 1 and 4, clamped overshoot, in place)")


# --- phase 5: full-width serving -------------------------------------------

def phase_engine(torch, np, cfg_mod, M, K, serve):
    cfg = cfg_mod.get_config("yi-9b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"engine: yi-9b {cfg.n_layers} layers d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    lens = rng.integers(128, 513, size=16)
    reqs = [serve.Request(f"r{i}", tuple(int(t) for t in
                                         rng.integers(0, cfg.vocab_size, n)), 64)
            for i, n in enumerate(lens)]
    eng = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048, chunk=8,
                            device="cuda")
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = eng.stats()
    n_tok = sum(len(v) for v in res.values())
    check(sorted(res) == sorted(r.rid for r in reqs)
          and all(len(v) == 64 for v in res.values()),
          "engine: not every request got its 64 tokens")
    check(all(int(v.min()) >= 0 and int(v.max()) < cfg.vocab_size
              for v in res.values()), "engine: token id out of vocab")
    steps = st["decode_tokens"]
    print(f"engine: {len(res)} requests, {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tok/s; prefill {st['prefill_s']:.2f} s "
          f"({st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.2f} s ({st['decode_dispatches']} dispatches, "
          f"{steps} steps, {st['decode_s'] / steps * 1e3:.2f} ms/step)")
    print(f"engine: launches {launches} (expected {cfg.n_layers} x {steps} "
          f"= {cfg.n_layers * steps} each)")
    for name in ("flash_decode", "kv_row_update"):
        check(launches[name] == cfg.n_layers * steps > 0,
              f"engine: {name} launched {launches[name]} times, expected "
              f"{cfg.n_layers * steps}")
    check(st["quarantined"] == 0, "engine: non-finite logits quarantined")

    # one decode step through the kernels against impl="ref", from the
    # served requests' first 8 prompts and from three more prompt sets
    sets = [[r.prompt for r in reqs[:8]]]
    for seed in LOGITS_SEEDS:
        g = np.random.default_rng(seed)
        sets.append([tuple(int(t) for t in g.integers(0, cfg.vocab_size, n))
                     for n in g.integers(128, 513, size=8)])
    readings = [_one_step_logits(torch, cfg, M, params, p) for p in sets]
    print("engine: one decode step, kernels vs impl='ref', max |diff| / "
          "max |logit| (greedy argmax agreement) per prompt set: "
          + ", ".join(f"{rel:.4g} ({agree:.3f})" for rel, agree in readings)
          + f"; tol {LOGITS_REL_TOL}")
    worst = max(rel for rel, _ in readings)
    check(worst <= LOGITS_REL_TOL, f"engine: kernel logits vs impl='ref' "
          f"rel err {worst:.3g} > {LOGITS_REL_TOL}")
    _small_engine_check(torch, np, cfg_mod, M, serve)
    return eng, reqs, launches


def _one_step_logits(torch, cfg, M, params, prompts) -> tuple:
    """Prefill ``prompts`` into 8 slots of a 2048-row cache, then one
    decode step through the kernels and one with ``impl="ref"`` on a copy
    of the cache. Returns (max |diff| / max |logit|, argmax agreement)."""
    from repro_torch.serve.slots import insert
    from repro_torch.train.serve import make_prefill_step
    fresh = M.init_cache(cfg, 8, 2048, "cuda")
    prefill = make_prefill_step(cfg, cache_len=2048)
    toks = []
    for i, p in enumerate(prompts):
        lg, one = prefill(params, {"tokens": torch.tensor(
            [p], dtype=torch.int64, device="cuda")})
        insert(fresh, one, i)
        toks.append(int(lg[0, -1].argmax()))
    del one
    tok = torch.tensor(toks, dtype=torch.int64, device="cuda")[:, None]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    kv_len = int(pos.max()) + 1
    ref_cache = {"scan": {"0": {n: t.clone() for n, t in
                                fresh["scan"]["0"].items()}}, "tail": {}}
    lk, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                         cache=fresh, pos=pos, impl="auto", kv_len=kv_len)
    lr, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                         cache=ref_cache, pos=pos, impl="ref", kv_len=kv_len)
    lk, lr = lk.float(), lr.float()
    check(bool(torch.isfinite(lk).all()), "engine: non-finite logits")
    rel = ((lk - lr).abs().max() / lr.abs().max()).item()
    agree = (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()
    return rel, agree


def _small_engine_check(torch, np, cfg_mod, M, serve) -> None:
    """Smoke-size fp32 engine: greedy streams on the card == on the CPU."""
    cfg = dataclasses.replace(cfg_mod.get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [serve.Request(str(i), tuple(int(t) for t in
                                        rng.integers(0, cfg.vocab_size, n)), m)
            for i, (n, m) in enumerate([(9, 12), (17, 5), (4, 1), (12, 9),
                                        (30, 7)])]
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        eng = serve.ServeEngine(cfg, p, max_slots=2, max_len=40, chunk=3,
                                device=dev)
        out[dev] = eng.run(reqs)
    check(all(out["cpu"][r.rid].tolist() == out["cuda"][r.rid].tolist()
              for r in reqs), "engine: smoke fp32 streams differ card vs CPU")
    print("engine: smoke-size fp32 greedy streams identical on the card and "
          "the CPU (5 requests, 2 slots, chunk 3)")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# --- phase 6: kernel timings -----------------------------------------------

def phase_timings(torch, np, D, S_, eng, reqs, launches, decode_err) -> list:
    F = torch.nn.functional
    cache = eng.cache["scan"]["0"]
    n_layers = cache["k"].shape[0]
    # mid-decode positions of the first 8 requests: prompt + 32 tokens
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:B]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    bound, split_len, n_splits = D.split_plan(B, HKV, cache["k"].shape[2],
                                              128, None, kv_len)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(B, 1, H, DH, generator=gen, device="cuda").bfloat16()
    kw = dict(window=None, split_len=split_len, n_splits=n_splits,
              bound=bound)
    # cycle over the 48 layers' caches so every call reads cold KV rows,
    # as the decode step does
    layer = [0]

    def next_kv():
        i = layer[0] = (layer[0] + 1) % n_layers
        return cache["k"][i], cache["v"][i]

    def kern():
        k, v = next_kv()
        D.decode_partials(q, k, v, pos, impl="cuda", **kw)

    def plain():
        k, v = next_kv()
        D.decode_partials(q, k, v, pos, impl="ref", **kw)

    mask = (torch.arange(bound, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]          # (B, 1, 1, bound)
    qt = q.transpose(1, 2)

    def library():
        k, v = next_kv()
        F.scaled_dot_product_attention(
            qt, k[:, :bound].transpose(1, 2), v[:, :bound].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    ms = timed(torch, kern, 480)
    plain_ms = timed(torch, plain, 48)
    lib_ms = timed(torch, library, 480)
    live = (pos + 1).clamp(max=bound).sum().item()       # KV rows read
    n_read = B * H * DH * 2 + live * HKV * DH * 2 * 2 + B * 4
    n_write = n_splits * B * H * (DH + 2) * 4
    flops = live * (H // HKV) * HKV * DH * 4
    t_bytes = (n_read + n_write) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    decode_row = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/attention/decode.py:179",
        "launches": launches["flash_decode"], "max_abs_err": decode_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms}
    print(f"timing: flash_decode at B={B} Sq=1 kv_len={kv_len} "
          f"n_splits={n_splits} ({live} live rows): {ms * 1e3:.2f} us, "
          f"bound {decode_row['bound_ms'] * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.2f} us "
          f"(device time by profiler)")

    # KV writer: one layer's K and V rows per launch, at a decode position
    kn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    flat = [c.view(n_layers, -1, HKV, DH) for c in (cache["k"], cache["v"])]
    rows = (torch.arange(B, device="cuda") * cache["k"].shape[2]
            + pos).long()

    def wkern():
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="cuda")

    def wplain():
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="ref")

    def wlib():
        i = layer[0] = (layer[0] + 1) % n_layers
        flat[0][i].index_copy_(0, rows, kn[:, 0])
        flat[1][i].index_copy_(0, rows, vn[:, 0])

    wms = timed(torch, wkern, 960)
    wplain_ms = timed(torch, wplain, 96)
    wlib_ms = timed(torch, wlib, 960)
    w_bytes = 2 * 2 * B * HKV * DH * 2 + B * 4
    writer_row = {
        "name": "kv_row_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stores.cu",
        "replaces": "src/repro/kernels/stores.py:235",
        "launches": launches["kv_row_update"], "max_abs_err": 0.0,
        "ms": wms, "plain_ms": wplain_ms,
        "bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": wlib_ms}
    print(f"timing: kv_row_update at B={B} Sq=1: {wms * 1e3:.2f} us, bound "
          f"{writer_row['bound_ms'] * 1e3:.4f} us, plain "
          f"{wplain_ms * 1e3:.1f} us, index_copy_ x2 {wlib_ms * 1e3:.2f} us "
          f"(device time by profiler)")
    return [decode_row, writer_row]


def phase_trace(torch, serve, eng, reqs) -> None:
    """Where a full-width decode step's device time goes, and the
    device's idle share over the same steps.

    The same 8 requests are served twice from an idle engine: once to
    take the wall time of two chunked dispatches, once under the
    profiler to take the device's busy time in the same two dispatches.
    Greedy decoding repeats the same tokens, positions and occupancy
    bounds, so both passes do the same work.
    """
    from torch.profiler import ProfilerActivity, profile
    check(not any(eng.slots), "trace: engine not idle")

    def admit_and_warm(tag):
        # 1 token from the prefill and 3 chunks: the warm dispatch, then
        # the two that are measured, after which the requests retire
        for r in reqs[:8]:
            eng.admit(serve.Request(f"{tag}-{r.rid}", r.prompt,
                                    1 + 3 * eng.chunk))
        eng.step()
        torch.cuda.synchronize()

    steps = 2 * eng.chunk
    admit_and_warm("wall")
    t0 = time.perf_counter()
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    check(not any(eng.slots), "trace: requests did not retire")
    admit_and_warm("trace")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        eng.step()
        torch.cuda.synchronize()
    prof_wall_ms = (time.perf_counter() - t0) / steps * 1e3
    by_name = device_us(prof)
    total = sum(by_name.values())
    check(total > 0, "trace: the profiler saw no device time")
    groups = {"flash_decode": 0.0, "kv_row_update": 0.0, "matmul": 0.0,
              "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if "decode_partials_kernel" in name:
            groups["flash_decode"] += us
        elif "kv_rows_kernel" in name:
            groups["kv_row_update"] += us
        elif any(t in low for t in ("gemm", "gemv", "cutlass", "sm90_",
                                    "nvjet", "matmul", "splitk")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    dev_ms = total / 1e3 / steps
    print(f"trace: full-width decode step, 8 slots (2 dispatches of "
          f"{eng.chunk} tokens, same requests twice): device busy "
          f"{dev_ms:.2f} ms/step (profiled pass) of {wall_ms:.2f} ms/step "
          f"wall (unprofiled pass), idle share {1 - dev_ms / wall_ms:.3f}; "
          f"under the profiler {prof_wall_ms:.2f} ms/step wall")
    print("trace: device time by group: " + ", ".join(
        f"{g} {us / 1e3 / steps:.3f} ms/step ({us / total:.3f})"
        for g, us in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        print(f"trace: {us / 1e3 / steps:8.3f} ms/step  {name[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the repository root (src/repro_torch "
              "not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch import serve
    from repro_torch.kernels import build, stores as S_
    from repro_torch.kernels.attention import decode as D, ops
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = phase_device(torch)
    phase_build(build)
    decode_err = phase_decode(torch, D, ops)
    phase_stores(torch, S_)
    eng, reqs, launches = phase_engine(torch, np, cfg_mod, M, K, serve)
    rows = phase_timings(torch, np, D, S_, eng, reqs, launches, decode_err)
    phase_trace(torch, serve, eng, reqs)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
