"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip on a machine without a CUDA device. This
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import stores, tuning
from repro_torch.kernels.attention import decode as D
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention import ref as R
from repro_torch.kernels.stream import kernels as SK
from repro_torch.kernels.stream import ops as SO
from repro_torch.kernels.stream import ref as SR
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.serve import PagedServeEngine, Request, ServeEngine
from repro_torch.serve import decode as SD
from repro_torch.train import serve as TS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import _pi_model as PM  # noqa: E402
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: the attention family's decode shapes, (b, skv, h, hkv, dh, sq, window,
#: n_splits): qwen2-vl-7b's G=7 (28 query heads over 4), musicgen-large's
#: MHA (G=1) at Dh=64, and gemma3-4b's heads with its 1024-row window over
#: a 2048-row cache, slots' positions on both sides of the window; then
#: jamba's attention layer (H 32, Hkv 8), grok-1's G=6 (48 over 8) and
#: qwen3-moe's G=16 (64 over 4)
FAMILY_DECODE_SHAPES = [
    (8, 1024, 28, 4, 128, 1, None, None),
    (8, 1024, 32, 32, 64, 1, None, None),
    (8, 2048, 8, 4, 256, 1, 1024, None),
    (8, 1024, 32, 8, 128, 1, None, None),
    (8, 1024, 48, 8, 128, 1, None, None),
    (8, 1024, 64, 4, 128, 1, None, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ns", [
    (2, 77, 4, 2, 32, 1, None, 3),      # smoke shapes, ragged, dead splits
    (3, 200, 8, 2, 64, 3, 40, 4),       # Sq=3, window
    (8, 1024, 32, 4, 128, 1, None, None),   # yi-9b heads, default splits
] + [
    # G=8 with Sq 1-4 (up to 32 packed rows, two mma row tiles): slot 0
    # sees one row (Sq=1), 6 splits leave some ragged and some dead
    (4, 300, 32, 4, 128, sq, window, 6) for sq in (1, 2, 3, 4)
    for window in (None, 40)
] + [
    # Dh=256 (gemma3-4b) at G 1-8, Sq 1-2, one live row, dead splits
    (4, 300, 2 * g, 2, 256, sq, None, 6) for g, sq in ((1, 1), (2, 2), (4, 1),
                                                       (8, 2))
] + [
    # more than 32 packed rows (groups of 32): G=16 at Sq 1-4, G=8 at Sq 8
    (3, 200, 32, 2, 128, sq, None, None) for sq in (1, 2, 3, 4)
] + [(3, 200, 32, 2, 128, 4, 40, None), (3, 200, 16, 2, 128, 8, None, None)]
  + FAMILY_DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, dtype, b, skv, h, hkv, dh, sq,
                                     window, ns):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, sq, h, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    pos = torch.linspace(0, skv - sq, b, device=cuda).round().int()
    bound, split_len, n = D.split_plan(b, hkv, skv, 64, ns, None)
    kw = dict(window=window, split_len=split_len, n_splits=n, bound=bound)
    K.reset_launches()
    got = D.decode_partials(q, k, v, pos, impl="cuda", **kw)
    want = D.decode_partials(q, k, v, pos, impl="ref", **kw)
    assert K.LAUNCHES["flash_decode"] == 1
    torch.testing.assert_close(D.combine_splits(*got),
                               D.combine_splits(*want), rtol=1e-4, atol=1e-4)
    assert torch.equal(got[2] == 0, want[2] == 0)        # dead splits
    # the finished output, splits merged in the kernel: one launch
    K.reset_launches()
    fin = D.decode_finished(q, k, v, pos, impl="cuda", **kw)
    assert K.LAUNCHES["flash_decode"] == 1 and fin.dtype == dtype
    _assert_finished(fin, D.combine_splits(*want))


def _assert_finished(got, want_f32):
    """A finished kernel output against the plain partials merged by
    combine_splits and cast to its dtype. fp32: within 1e-4, as the
    partials. bf16: within one bf16 ulp (rtol 2**-7 of the rounded plain
    value) plus the fp32 tolerance: both sides round an fp32 sum taken in
    another order than torch.sum's, so near a rounding boundary the two
    roundings can part by one ulp. The split counters are all 0 again."""
    want = want_f32.to(got.dtype)
    rtol = 1e-4 if got.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4)
    torch.cuda.synchronize()
    assert not D.split_counters(got.device).any()


def test_decode_counters_reset_and_repeats_bit_identical(cuda):
    """One cached counter tensor across finished calls of other split
    counts, slot counts and row groups, dense and paged: after each call
    every counter is 0 again, and a call repeated gives the same bits (the
    last block merges in split order, whichever block finishes last)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    skv, hkv, dh, ps = 512, 2, 128, 16
    D._COUNTERS.clear()             # made for the first call, grown after
    for b, h, sq, ns in ((1, 16, 1, 16), (3, 16, 1, 2), (8, 16, 1, 5),
                         (2, 32, 4, 3), (8, 16, 1, 8), (5, 16, 1, 1),
                         (8, 16, 1, 5)):
        q = torch.randn(b, sq, h, dh, generator=g, device=cuda).bfloat16()
        k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
        v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
        pos = torch.linspace(0, skv - sq, b, device=cuda).round().int()
        bt = torch.arange(b * skv // ps, dtype=torch.int32,
                          device=cuda).reshape(b, -1)
        kp, vp = (x.reshape(-1, ps, hkv, dh) for x in (k, v))
        calls = (lambda: D.flash_decode(q, k, v, pos, n_splits=ns,
                                        impl="cuda"),
                 lambda: D.flash_decode_paged(q, kp, vp, bt, pos,
                                              n_splits=ns, impl="cuda"))
        for call in calls:
            first = call()
            torch.cuda.synchronize()
            assert not D.split_counters(q.device).any()
            assert torch.equal(call().view(torch.int16),
                               first.view(torch.int16))
            torch.cuda.synchronize()
            assert not D.split_counters(q.device).any()
    assert D.split_counters(q.device).numel() >= D.counters_needed(2, 4, 32,
                                                                   hkv)


@pytest.mark.parametrize("kv_len,rounded", [(472, True), (301, True),
                                            (301, False)])
def test_decode_kernel_occupancy_bound(cuda, kv_len, rounded):
    """The serving path's cut: a 2048-row cache read only up to the
    occupancy bound (rounded to 128-row blocks as ops.flash_decode does,
    or ragged inside a block), default splits, yi-9b heads."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, skv, h, hkv, dh = 8, 2048, 32, 4, 128
    q = torch.randn(b, 1, h, dh, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
    pos = torch.linspace(0, kv_len - 1, b, device=cuda).round().int()
    bound = -(-kv_len // 128) * 128 if rounded else kv_len
    bound, split_len, n = D.split_plan(b, hkv, skv, 128, None, bound)
    kw = dict(window=None, split_len=split_len, n_splits=n, bound=bound)
    got = D.combine_splits(*D.decode_partials(q, k, v, pos, impl="cuda",
                                              **kw))
    want = D.combine_splits(*D.decode_partials(q, k, v, pos, impl="ref",
                                               **kw))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dense = D.ref_decode(q.float(), k.float(), v.float(), pos, kv_len=bound)
    torch.testing.assert_close(got, dense.float(), rtol=1e-4, atol=1e-4)


#: the served decode shapes at engine kv_len buckets, (b, h, hkv, dh,
#: kv_len): yi-9b's heads across the buckets whose tuned tiles differ,
#: gemma3-4b's Dh=256 and jamba's Hkv 8
TUNED_SHAPES = [(8, 32, 4, 128, kv) for kv in (128, 256, 640, 1024, 2048)] \
    + [(8, 8, 4, 256, kv) for kv in (128, 1536)] + [(8, 32, 8, 128, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,hkv,dh,kv_len", TUNED_SHAPES)
def test_decode_kernels_at_the_tuners_tiles(cuda, dtype, b, h, hkv, dh,
                                            kv_len):
    """The decode kernels at the tile tuner's ``(bk, n_splits)`` on h100
    (``kernels.tuning.decode_tiles``, as the JAX router asks it), through
    ``ops.flash_decode`` and ``ops.flash_decode_paged`` over a 2048-row
    cache at a bucketed kv_len: one launch each, bit for bit the
    finished kernel at that split plan, and within the finished
    tolerance of the plain version at the same tiles."""
    g = torch.Generator(device=cuda).manual_seed(31)
    skv, ps = 2048, 16
    q = torch.randn(b, 1, h, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    pos = torch.linspace(0, kv_len - 1, b, device=cuda).round().int()
    name = str(dtype)[len("torch."):]
    plan = tuning.decode_tiles("h100", skv=kv_len, dh=dh, h=h, hkv=hkv,
                               batch=b, dtype=name)
    assert plan.bk % (64 if dtype == torch.bfloat16 else 32) == 0
    K.reset_launches()
    got = ops.flash_decode(q, k, v, pos, kv_len=kv_len, impl="cuda",
                           bk=plan.bk, n_splits=plan.n_splits)
    assert K.LAUNCHES["flash_decode"] == 1
    bound = min(-(-kv_len // plan.bk) * plan.bk, skv)
    bound, split_len, n = D.split_plan(b, hkv, skv, plan.bk, plan.n_splits,
                                       bound)
    kw = dict(window=None, split_len=split_len, n_splits=n, bound=bound)
    fin = D.decode_finished(q, k, v, pos, impl="cuda", **kw)
    assert torch.equal(got.view(torch.uint8), fin.view(torch.uint8))
    _assert_finished(got, D.combine_splits(*D.decode_partials(
        q, k, v, pos, impl="ref", **kw)))
    kp, vp = (x.reshape(-1, ps, hkv, dh) for x in (k, v))
    bt = torch.arange(b * skv // ps, dtype=torch.int32,
                      device=cuda).reshape(b, -1)
    nb = kv_len // ps
    pns = tuning.decode_tiles("h100", skv=nb * ps, dh=dh, h=h, hkv=hkv,
                              batch=b, dtype=name).n_splits
    K.reset_launches()
    pgot = ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=kv_len,
                                  impl="cuda", n_splits=pns)
    assert K.LAUNCHES["flash_decode_paged"] == 1
    pbound, psl, pn = D.paged_split_plan(b, hkv, ps, nb, pns)
    pkw = dict(window=None, split_len=psl, n_splits=pn, bound=pbound)
    pfin = D.decode_paged_finished(q, kp, vp, bt, pos, impl="cuda", **pkw)
    assert torch.equal(pgot.view(torch.uint8), pfin.view(torch.uint8))
    _assert_finished(pgot, D.combine_splits(*D.decode_paged_partials(
        q, kp, vp, bt, pos, impl="ref", **pkw)))


@pytest.mark.parametrize("flavor", ["standard", "nt"])
@pytest.mark.parametrize("sq", [1, 3])
def test_kv_writer_matches_plain(cuda, flavor, sq):
    g = torch.Generator(device=cuda).manual_seed(1)
    kc = torch.randn(4, 64, 2, 32, generator=g, device=cuda).bfloat16()
    vc = torch.randn(4, 64, 2, 32, generator=g, device=cuda).bfloat16()
    kn = torch.randn(4, sq, 2, 32, generator=g, device=cuda).bfloat16()
    vn = torch.randn(4, sq, 2, 32, generator=g, device=cuda).bfloat16()
    pos = torch.tensor([0, 17, 63, 70], dtype=torch.int32, device=cuda)
    kr, vr = kc.clone(), vc.clone()
    ptr = kc.data_ptr()
    stores.kv_row_update(kc, vc, kn, vn, pos, flavor=flavor, impl="cuda")
    stores.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor, impl="ref")
    assert kc.data_ptr() == ptr
    assert torch.equal(kc.view(torch.int16), kr.view(torch.int16))
    assert torch.equal(vc.view(torch.int16), vr.view(torch.int16))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.randn(1, 1, 4, 48, device=cuda)            # head_dim 48
    k = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        D.flash_decode(q, k, k, 3, impl="cuda")
    q = torch.randn(1, 2, 16, 256, device=cuda)      # fp32 at Dh=256
    with pytest.raises(ValueError, match="bk"):      # 64 keys do not fit
        ops.flash_attention(q, q, q, bk=64, impl="cuda")
    qb = q.bfloat16()                                # bf16 at Dh=256
    with pytest.raises(ValueError, match="bk"):      # 128 keys do not fit
        ops.flash_attention(qb, qb, qb, bk=128, impl="cuda")
    kc = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        stores.kv_row_update(kc[:, :, :, :16], kc[:, :, :, :16],
                             torch.zeros(1, 1, 2, 16, device=cuda),
                             torch.zeros(1, 1, 2, 16, device=cuda), 0,
                             impl="cuda")


def test_engine_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(str(i), tuple(int(t) for t in
                                  rng.integers(0, cfg.vocab_size, n)), m)
            for i, (n, m) in enumerate([(9, 12), (17, 5), (4, 1), (12, 9)])]
    to = lambda t, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                       for k, v in t.items()}
    out = {d: ServeEngine(cfg, to(params, d), max_slots=2, max_len=32,
                          chunk=3, device=d).run(reqs) for d in ("cpu", cuda)}
    for r in reqs:
        assert out["cpu"][r.rid].tolist() == out[cuda][r.rid].tolist()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-vl-7b"])
def test_family_engine_on_card_matches_cpu(cuda, arch, paged):
    """Smoke fp32 engines of the attention family: gemma3-4b at 8 layers
    (a 6-block unit and a tail of 2; local layers' window of 16 inside
    the 64-row horizon) and qwen2-vl-7b (QKV bias, M-RoPE): the graphed
    streams on the card equal the CPU engine's."""
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              n_layers=8 if arch == "gemma3-4b" else 2)
    params = M.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(str(i), tuple(int(t) for t in
                                  rng.integers(0, cfg.vocab_size, n)), m)
            for i, (n, m) in enumerate([(20, 30), (33, 12), (5, 1),
                                        (18, 21)])]
    to = lambda t, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                       for k, v in t.items()}
    cls, kw = (PagedServeEngine, dict(page_size=8)) if paged \
        else (ServeEngine, {})
    out = {d: cls(cfg, to(params, d), max_slots=2, max_len=64, chunk=3,
                  device=d, **kw).run(reqs) for d in ("cpu", cuda)}
    for r in reqs:
        assert out["cpu"][r.rid].tolist() == out[cuda][r.rid].tolist()


def _paged_layout(k, v, ps, gen, dead_to):
    """The slot caches k, v (B, S, Hkv, Dh) as page pools under a randomly
    permuted block table, with one extra pool page ``dead_to`` points
    into: table columns past ``dead_to[b]`` rows name it."""
    b, skv, hkv, dh = k.shape
    nb = -(-skv // ps)
    perm = torch.randperm(b * nb, generator=gen, device="cpu")
    pad = (0, 0, 0, 0, 0, nb * ps - skv)
    pools = []
    for x in (k, v):
        pages = torch.nn.functional.pad(x, pad).reshape(b * nb, ps, hkv, dh)
        pool = torch.empty((b * nb + 1, ps, hkv, dh), dtype=x.dtype,
                           device=x.device)
        pool[perm.to(x.device)] = pages
        pool[-1] = float("nan")                      # never read
        pools.append(pool)
    bt = perm.reshape(b, nb).clone()
    for i, last in enumerate(dead_to):
        bt[i, last // ps + 1:] = b * nb              # the NaN page
    return pools[0], pools[1], bt.int().to(k.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ps,ns", [
    (2, 77, 4, 2, 32, 1, None, 4, 3),       # smoke shapes, ragged
    (3, 200, 8, 2, 64, 3, 40, 16, 4),       # Sq=3, window
    (8, 1024, 32, 4, 128, 1, None, 16, None),   # yi-9b heads
    (8, 1024, 32, 4, 128, 4, 256, 256, None),   # page 256, Sq=4, window
] + [
    # G=8 with Sq 1-4 (up to 32 packed rows), one live row in slot 0
    # (Sq=1), ragged and dead splits, pages of 8, 16 and 256 rows
    (4, 300, 32, 4, 128, sq, None, ps, 6) for sq in (1, 2, 3, 4)
    for ps in (8, 16, 256)
] + [
    # Dh=256 at G 1-8, pages of 16; more than 32 packed rows
    (4, 300, 2 * g, 2, 256, sq, None, 16, 6) for g, sq in ((1, 1), (2, 2),
                                                           (4, 1), (8, 2))
] + [(3, 200, 32, 2, 128, sq, None, 16, None) for sq in (1, 4)]
  + [(3, 200, 16, 2, 128, 8, 40, 16, None)]
  + [shape[:7] + (16,) + shape[7:] for shape in FAMILY_DECODE_SHAPES])
def test_paged_decode_kernel_matches_plain(cuda, dtype, b, skv, h, hkv, dh,
                                           sq, window, ps, ns):
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(b, sq, h, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    pos = torch.linspace(0, skv - sq, b, device=cuda).round().int()
    kp, vp, bt = _paged_layout(k, v, ps, torch.Generator().manual_seed(6),
                               (pos + sq - 1).tolist())
    for n_blocks in (bt.shape[1], -(-(int(pos.max()) + sq) // ps)):
        bound, split_len, n = D.paged_split_plan(b, hkv, ps, n_blocks, ns)
        kw = dict(window=window, split_len=split_len, n_splits=n,
                  bound=bound)
        K.reset_launches()
        got = D.decode_paged_partials(q, kp, vp, bt, pos, impl="cuda", **kw)
        want = D.decode_paged_partials(q, kp, vp, bt, pos, impl="ref", **kw)
        assert K.LAUNCHES["flash_decode_paged"] == 1
        torch.testing.assert_close(D.combine_splits(*got),
                                   D.combine_splits(*want), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(got[2] == 0, want[2] == 0)     # dead splits
        K.reset_launches()
        fin = D.decode_paged_finished(q, kp, vp, bt, pos, impl="cuda", **kw)
        assert K.LAUNCHES["flash_decode_paged"] == 1 and fin.dtype == dtype
        _assert_finished(fin, D.combine_splits(*want))
    # the same logical cache through the dense kernel
    dense = D.flash_decode(q, k, v, pos, window=window, impl="cuda")
    paged = ops.flash_decode_paged(q, kp, vp, bt, pos, window=window,
                                   impl="cuda")
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(paged.float(), dense.float(), rtol=tol,
                               atol=tol)


# the fused row write: (b, skv, h, hkv, dh, sq, window, n_splits); head
# dims 64, 128 and 256, one split and many, more than 32 packed rows
FUSED_WRITE_SHAPES = [
    (4, 300, 8, 2, 64, 1, None, 1), (4, 300, 8, 2, 64, 3, 40, None),
    (8, 1024, 32, 4, 128, 1, None, None), (8, 1024, 32, 4, 128, 1, None, 1),
    (4, 300, 4, 2, 256, 2, None, 6), (4, 300, 16, 2, 256, 1, 40, 1),
    (3, 200, 32, 2, 128, 4, None, None),        # G*Sq = 64: two row groups
]


def _same_bytes(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("flavor", ["standard", "nt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ns", FUSED_WRITE_SHAPES)
def test_fused_write_matches_unfused_pair_dense(cuda, flavor, dtype, b, skv,
                                                h, hkv, dh, sq, window, ns):
    """One decode launch given the step's rows against the standalone
    writer and then the decode kernel: the output bit for bit, both caches
    byte for byte. Slot 0's position is negative (counted from the end),
    the last slot's overshoots the cache (its window clamps below pos)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(b, sq, h, dh, generator=g, device=cuda).to(dtype)
    kc = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    vc = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    kn = torch.randn(b, sq, hkv, dh, generator=g, device=cuda).to(dtype)
    vn = torch.randn(b, sq, hkv, dh, generator=g, device=cuda).to(dtype)
    pos = torch.linspace(0, skv - sq, b, device=cuda).round().int()
    pos[0], pos[-1] = -2, skv + 3
    bound, split_len, n = D.split_plan(b, hkv, skv, 128, ns, None)
    kw = dict(window=window, split_len=split_len, n_splits=n, bound=bound)
    kr, vr = kc.clone(), vc.clone()
    stores.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor, impl="cuda")
    want = D.decode_finished(q, kr, vr, pos, impl="cuda", **kw)
    K.reset_launches()
    got = D.decode_finished(q, kc, vc, pos, impl="cuda", k_new=kn, v_new=vn,
                            store_flavor=flavor, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_decode"] == 1
    assert K.LAUNCHES["kv_rows_in_decode"] == 1
    assert K.LAUNCHES["kv_row_update"] == 0
    assert _same_bytes(got, want)
    assert _same_bytes(kc, kr) and _same_bytes(vc, vr)
    assert not D.split_counters(cuda).any()


@pytest.mark.parametrize("pos0", [None, -3, -37])
@pytest.mark.parametrize("flavor", ["standard", "nt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ns", FUSED_WRITE_SHAPES)
def test_fused_write_matches_unfused_pair_paged(cuda, flavor, dtype, b, skv,
                                                h, hkv, dh, sq, window, ns,
                                                pos0):
    """The paged kernel given the step's rows against the plain index
    write and then the paged kernel, under a shuffled table, with the
    table read in full and cut below the last slot's written column (the
    write counts the table's full width); the last slot's position
    overshoots the table and retires onto its last column. ``pos0``, when
    given, is slot 0's negative position, whose write wraps to column
    ``pos0 // 16 + NB`` of its own table, as the plain route's does."""
    g = torch.Generator(device=cuda).manual_seed(14)
    ps = 16
    q = torch.randn(b, sq, h, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    kn = torch.randn(b, sq, hkv, dh, generator=g, device=cuda).to(dtype)
    vn = torch.randn(b, sq, hkv, dh, generator=g, device=cuda).to(dtype)
    pos = torch.linspace(0, skv - 60, b, device=cuda).round().int()
    nb = -(-skv // ps)
    pos[-1] = nb * ps + 5
    # every column a slot writes or reads is its own page; the last slot's
    # whole row, the others' past their last live row name the NaN page
    # (but a slot 0 at a negative position's, which it writes)
    dead = (pos + sq - 1).tolist()
    if pos0 is not None:
        pos[0], dead[0] = pos0, nb * ps
    kp, vp, bt = _paged_layout(k, v, ps, torch.Generator().manual_seed(15),
                               dead)
    for n_blocks in (nb, -(-(int(pos[:-1].max()) + sq) // ps)):
        bound, split_len, n = D.paged_split_plan(b, hkv, ps, n_blocks, ns)
        kw = dict(window=window, split_len=split_len, n_splits=n,
                  bound=bound)
        kr, vr = kp.clone(), vp.clone()
        stores.ref_paged_row_update(kr, vr, bt, kn, vn, pos)
        want = D.decode_paged_finished(q, kr, vr, bt, pos, impl="cuda", **kw)
        K.reset_launches()
        got = D.decode_paged_finished(q, kp, vp, bt, pos, impl="cuda",
                                      k_new=kn, v_new=vn,
                                      store_flavor=flavor, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES["flash_decode_paged"] == 1
        assert K.LAUNCHES["kv_rows_in_decode"] == 1
        assert _same_bytes(got, want)
        assert _same_bytes(kp, kr) and _same_bytes(vp, vr)
    # the written rows landed where the reference's scatter puts them
    last = bt[-1, nb - 1].long()
    assert _same_bytes(kp[last, (nb * ps + 5) % ps], kn[-1, 0])
    if pos0 is not None:
        assert _same_bytes(kp[bt[0, pos0 // ps + nb].long(), pos0 % ps],
                           kn[0, 0])


def test_fused_write_refuses_what_it_does_not_take(cuda):
    q = torch.randn(2, 1, 4, 32, device=cuda)
    kc = torch.randn(2, 16, 2, 32, device=cuda)
    kn = torch.randn(2, 1, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="come together"):
        ops.flash_decode(q, kc, kc.clone(), 3, k_new=kn, impl="cuda")
    with pytest.raises(ValueError, match="k_new must be"):
        ops.flash_decode(q, kc, kc.clone(), 3, k_new=kn[:, :, :1],
                         v_new=kn[:, :, :1], impl="cuda")
    with pytest.raises(ValueError, match="unknown store flavor"):
        ops.flash_decode(q, kc, kc.clone(), 3, k_new=kn, v_new=kn,
                         store_flavor="fast", impl="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,s,dh,window,bq,bk,causal", [
    (4, 2, 77, 32, None, None, 64, True),        # ragged S
    (8, 2, 200, 64, 40, 8, 32, True),            # window, bk 32
    (32, 4, 509, 128, None, None, 64, True),     # yi-9b heads, ragged
    (32, 4, 512, 128, 256, None, 64, True),      # yi-9b heads, window
] + [
    # the edges of the tiling (64 packed rows a consumer warpgroup in
    # bf16, 16 a thread row in fp32; 32- to 128-key tiles), in both bodies
    # (bf16 wgmma, fp32 scalar): S of one row, around one and four tiles
    (32, 4, s, 128, None, None, 64, True) for s in (1, 15, 16, 17, 63, 65)
] + [
    (2 * g, 2, 100, 64, None, None, 64, True) for g in (1, 2, 4, 8)  # G
] + [
    (8, 2, 130, dh, None, None, 32, True) for dh in (32, 64, 128)
] + [
    (6, 2, 90, 64, None, None, 64, True),   # G=3: 126 packed rows
    (8, 1, 70, 128, None, 3, 64, True),     # bq=3 at G=8: 24 packed rows
    (32, 4, 300, 128, 5, None, 64, True),   # windows smaller than a tile
    (4, 2, 129, 32, 1, None, 32, True),
    (8, 2, 100, 64, None, None, 64, False),  # no causal mask
] + [
    # Dh=256 (gemma3-4b's heads) at the default tiles (64 keys; 32 in fp32)
    (8, 4, s, 256, None, None, None, True) for s in (1, 65, 512, 2048)
] + [
    (2 * g, 2, 100, 256, None, None, None, True) for g in (1, 2, 4, 8)
] + [
    (8, 4, 300, 256, 40, None, None, True),  # a window
    (8, 4, 100, 256, None, None, None, False),  # no causal mask
] + [
    # S = 4096 at yi-9b's and gemma3-4b's heads: many rounds of the stages
    (32, 4, 4096, 128, None, None, None, True),
    (8, 4, 4096, 256, None, None, None, True),
    # key ranges split in two blocks and merged (bf16): under a window,
    # and every tile of a call without the causal mask
    (4, 2, 2048, 256, 512, None, None, True),
    (8, 4, 1024, 256, None, None, None, False),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, h, hkv, s, dh,
                                              window, bq, bk, causal):
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(1, h, s, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, hkv, s, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, hkv, s, dh, generator=g, device=cuda).to(dtype)
    K.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, bq=bq,
                              bk=bk, impl="cuda")
    assert K.LAUNCHES["flash_attention"] == 1 and got.dtype == dtype
    want = R.attention(q.float(), k.float(), v.float(), causal=causal,
                       window=window)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    # the (B, S, H, Dh) adapter reads strided views, no copy
    got_bshd = ops.flash_attention_bshd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window, bq=bq,
        bk=bk, impl="cuda")
    assert torch.equal(got_bshd.transpose(1, 2), got)


def _paged_schedule(eng, prompts, fork: bool) -> dict:
    """Admit, fork (paged only), cancel and drain; {rid: tokens}."""
    eng.admit(Request("0", prompts[0], 10))
    out = {r: t.tolist() for r, t in eng.step()}
    if fork:
        eng.fork("0", "fork")
    pending = [Request(str(i), p, 7) for i, p in enumerate(prompts)][1:]
    steps = 0
    while pending or any(eng.slots):
        for slot in eng.free_slots():
            if pending:
                eng.admit(pending.pop(0), slot)
        out.update({r: t.tolist() for r, t in eng.step()})
        steps += 1
        if steps == 2:
            got = eng.cancel("1")
            out["1"] = None if got is None else got.tolist()
    return out


def test_paged_engine_on_card_matches_dense_and_cpu(cuda):
    """Smoke fp32 paged engine on the card: the same greedy streams as
    the paged engine on the CPU (prefix sharing, a fork and a cancel on
    the way) and as the dense engine on the card (no fork)."""
    cfg = dataclasses.replace(get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(4)
    system = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    prompts = [system + tuple(int(t) for t in
                              rng.integers(0, cfg.vocab_size, n))
               for n in (1, 5, 0, 9)]
    to = lambda t, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                       for k, v in t.items()}
    kw = dict(max_slots=2, max_len=40, chunk=3)

    def paged(dev, fork):
        eng = PagedServeEngine(cfg, to(params, dev), page_size=4,
                               device=dev, **kw)
        out = _paged_schedule(eng, prompts, fork)
        eng.check_pool()
        assert eng.pool.stats["shared_maps"] > 0
        return out

    card = paged(cuda, True)
    assert card == paged("cpu", True)
    assert card["fork"] == card["0"]
    dense = _paged_schedule(ServeEngine(cfg, to(params, cuda), device=cuda,
                                        **kw), prompts, False)
    assert paged(cuda, False) == dense


# --- the recurrent and MoE families on the card ------------------------------

def _smoke_params(arch, seed):
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(seed),
                              "cpu")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_recurrent_engines_on_card_match_cpu_and_eager(cuda, arch, paged):
    """Smoke fp32 xlstm-125m and jamba engines: the graphed chunk on the
    card gives the CPU engine's greedy streams and the eager chunk's on
    the card (a fork and a cancel on the paged schedule: the clone's
    recurrent rows copied on the card); xlstm-125m, which reads no KV
    rows, holds one graph for every chunk."""
    cfg, params = _smoke_params(arch, 3)
    rng = np.random.default_rng(14)
    system = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    prompts = [system + tuple(int(t) for t in
                              rng.integers(0, cfg.vocab_size, n))
               for n in (12, 1, 30, 5)]
    cls, kw = (PagedServeEngine, dict(page_size=4)) if paged \
        else (ServeEngine, {})
    out = {}
    for dev, graphs in (("cpu", False), (cuda, False), (cuda, True)):
        eng = cls(cfg, _to(params, dev), max_slots=2, max_len=60, chunk=3,
                  device=dev, cuda_graphs=graphs, **kw)
        out[(str(dev), graphs)] = _paged_schedule(eng, prompts, fork=paged)
        if paged:
            eng.check_pool()
    assert out[("cpu", False)] == out[("cuda", False)] == out[("cuda", True)]
    if paged:
        assert out[("cpu", False)]["fork"] == out[("cpu", False)]["0"]
    # a 60-row horizon is one bucket
    assert list(eng.graphs.graphs) == ([None] if arch == "xlstm-125m"
                                       else [60])


def test_recurrent_chunk_graph_writes_the_state_in_place(cuda):
    """jamba's chunk as one replay: the capture's eager warm-up leaves the
    recurrent leaves (fp32) as it found them, and each replay leaves them
    and the KV rows of the same cache tensors bit for bit as the eager
    chunk leaves a copy of them, replay after replay."""
    cfg, params = _smoke_params("jamba-v0.1-52b", 4)
    params = _to(params, cuda)
    b, n = 3, 4
    g = torch.Generator(device=cuda).manual_seed(17)
    cache = M.init_cache(cfg, b, 64, cuda)
    for _, leaf in M._walk(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda) * 0.1)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                           device=cuda)
    pos = torch.tensor([20, 7, 33], dtype=torch.int32, device=cuda)
    body = SD.make_chunk_body(cfg, n)
    graphs = SD.ChunkGraphs(body, cfg, params, cache, batch=b, n_tokens=n,
                            sampled=False, device=cuda)
    ref = _clone_cache(cache)
    graphs.load(tokens, pos)
    graphs.capture(64)
    torch.cuda.synchronize()
    state = M.state_leaves(cfg, cache)
    assert len(state) == 14
    assert all(torch.equal(t, r) for t, r in zip(
        state, M.state_leaves(cfg, ref)))
    ptrs = [t.data_ptr() for _, t in M._walk(cache)]
    for _ in range(2):
        want = body(params, ref, tokens, pos, None, 64)
        got = graphs.run(64, tokens, pos)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        for (path, t), (_, r) in zip(M._walk(cache), M._walk(ref)):
            assert torch.equal(t, r), path
    assert [t.data_ptr() for _, t in M._walk(cache)] == ptrs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_on_card_matches_cpu(cuda, dtype):
    """``moe_ffn`` at 16 experts top-2 with drops (capacity 2 over 8
    tokens): on the card the routing of the CPU run (fp32), and its
    output within 1e-5 (fp32) or 5e-2 of its largest (bf16)."""
    g = torch.Generator().manual_seed(5)
    d, e, f = 64, 16, 48
    p = {"router": torch.randn(d, e, generator=g) * d ** -0.5,
         "w_gate": torch.randn(e, d, f, generator=g) * d ** -0.5,
         "w_up": torch.randn(e, d, f, generator=g) * d ** -0.5,
         "w_down": torch.randn(e, f, d, generator=g) * f ** -0.5}
    p = {k: v.to(dtype) for k, v in p.items()}
    x = torch.randn(8, 1, d, generator=g).to(dtype)
    kw = dict(n_experts=e, top_k=2)
    want, aux_c = MoE.moe_ffn(p, x, **kw)
    got, aux_g = MoE.moe_ffn(_to(p, cuda), x.to(cuda), **kw)
    w = want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        route = [MoE.route(xg.reshape(1, 8, d), r, n_experts=e, top_k=2,
                           cap=2) for xg, r in ((x, p["router"]),
                                                 (x.to(cuda),
                                                  p["router"].to(cuda)))]
        assert not bool(route[0][3].all())
        for a, b in zip(route[0][2:], route[1][2:]):
            assert torch.equal(a, b.cpu())
    else:
        assert (got.cpu().float() - w).abs().max() <= 5e-2 * w.abs().max()
    torch.testing.assert_close(aux_g.cpu(), aux_c, rtol=1e-5, atol=1e-6)


# --- the decode chunk as CUDA-graph replays ---------------------------------

def _smoke_on_card(cuda):
    cfg = dataclasses.replace(get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(cuda)
                    for k, v in t.items()}
    return cfg, to(params)


def _random_chunk_state(cfg, cuda, b, horizon, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    cache = M.init_cache(cfg, b, horizon, cuda)
    for part in cache["scan"].values():
        for leaf in part.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                           device=cuda)
    return cache, tokens


def _clone_cache(cache):
    return {k: _clone_cache(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("paged", [False, True])
def test_graphed_engine_matches_eager(cuda, paged, temperature):
    """Smoke fp32 engines on the card, a 300-row horizon: the chunk as
    CUDA-graph replays gives the eager chunk's streams token for token,
    greedy and sampled, dense and paged (a fork and a cancel on the
    paged schedule), over prompts whose chunks cross the 128- and
    256-row buckets; one graph a bucket; split counters 0 after."""
    cfg, params = _smoke_on_card(cuda)
    rng = np.random.default_rng(8)
    system = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 8))
    prompts = [system + tuple(int(t) for t in
                              rng.integers(0, cfg.vocab_size, n - 8))
               for n in (120, 9, 250, 126)]
    cls, kw = (PagedServeEngine, dict(page_size=16)) if paged \
        else (ServeEngine, {})
    out, engines = {}, {}
    for graphs in (False, True):
        eng = cls(cfg, params, max_slots=3, max_len=300, chunk=4,
                  temperature=temperature, seed=3, device=cuda,
                  cuda_graphs=graphs, **kw)
        out[graphs] = _paged_schedule(eng, prompts, fork=paged)
        engines[graphs] = eng
    assert out[True] == out[False]
    assert engines[False].graphs is None
    buckets = set(engines[True].graphs.graphs)
    assert len(buckets) >= 2 and buckets <= {128, 256, 300}
    torch.cuda.synchronize()
    assert not D.split_counters(cuda).any()


def test_graphed_engine_batched_admission(cuda):
    """All slots free and equal prompt lengths: the batched prefill lands
    in the cache tensors the graphs read (in place), and the graphed
    streams are the eager engine's."""
    cfg, params = _smoke_on_card(cuda)
    rng = np.random.default_rng(12)
    reqs = [Request(str(i), tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, 9)), m) for i, m in enumerate((7, 4, 10))]
    out = {}
    for graphs in (False, True):
        eng = ServeEngine(cfg, params, max_slots=3, max_len=40, chunk=3,
                          device=cuda, cuda_graphs=graphs)
        ptrs = [t.data_ptr() for t in eng.cache["scan"]["0"].values()]
        out[graphs] = {r: t.tolist() for r, t in eng.run(reqs).items()}
        assert eng.prefill_dispatches == 1
        assert [t.data_ptr() for t in eng.cache["scan"]["0"].values()] \
            == ptrs
    assert out[True] == out[False]


def test_chunk_graph_replay_counts_like_the_eager_chunk(cuda):
    """One replay advances ``LAUNCHES`` exactly as one eager call of the
    same chunk does, gives its tokens and its cache bit for bit, leaves
    the split counters at 0; a bucket is never captured twice."""
    cfg, params = _smoke_on_card(cuda)
    b, n = 3, 4
    cache, tokens = _random_chunk_state(cfg, cuda, b, 300, 9)
    pos = torch.tensor([100, 7, 180], dtype=torch.int32, device=cuda)
    body = SD.make_chunk_body(cfg, n)
    eager_cache = _clone_cache(cache)
    K.reset_launches()
    want = body(params, eager_cache, tokens, pos, None, 256)
    torch.cuda.synchronize()
    eager = dict(K.LAUNCHES)
    assert eager["flash_decode"] == eager["kv_rows_in_decode"] \
        == cfg.n_layers * n
    graphs = SD.ChunkGraphs(body, cfg, params, cache, batch=b, n_tokens=n,
                            sampled=False, device=cuda)
    graphs.load(tokens, pos)
    graphs.capture(256)
    with pytest.raises(RuntimeError, match="captured already"):
        graphs.capture(256)
    for _ in range(2):
        K.reset_launches()
        got = graphs.run(256, tokens, pos)
        torch.cuda.synchronize()
        assert K.LAUNCHES == eager
        assert not D.split_counters(cuda).any()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(cache["scan"]["0"][k], eager_cache["scan"]["0"][k])
               for k in ("k", "v"))
    assert list(graphs.graphs) == [256]


def test_chunk_graph_survives_split_counters_growth(cuda):
    """A decode call that needs more split counters than a captured graph
    was captured with grows them to a new tensor; the graph still
    replays the eager chunk's tokens and cache bit for bit, with memory
    handed out after the growth filled with nonzero words, and its own
    counters back at 0."""
    cfg, params = _smoke_on_card(cuda)
    b, n = 3, 4
    cache, tokens = _random_chunk_state(cfg, cuda, b, 300, 13)
    pos = torch.tensor([150, 20, 260], dtype=torch.int32, device=cuda)
    body = SD.make_chunk_body(cfg, n)
    graphs = SD.ChunkGraphs(body, cfg, params, cache, batch=b, n_tokens=n,
                            sampled=False, device=cuda)
    eager_cache = _clone_cache(cache)
    graphs.load(tokens, pos)
    graphs.capture(300)
    # the capture wrote the chunk's rows into the cache: so does the
    # eager reference, before its own chunk
    body(params, eager_cache, tokens, pos, None, 300)
    want = body(params, eager_cache, tokens, pos, None, 300)
    old = D.split_counters(cuda)
    # a larger decode call in two splits: one counter a slot, more slots
    # than there are counters
    nb = old.numel() + 1
    q = torch.randn(nb, 1, 1, 32, device=cuda).bfloat16()
    k = torch.randn(nb, 256, 1, 32, device=cuda).bfloat16()
    pos_b = torch.full((nb,), 255, dtype=torch.int32, device=cuda)
    ops.flash_decode(q, k, k, pos_b, n_splits=2, impl="cuda")
    assert D.split_counters(cuda) is not old
    del q, k, pos_b
    junk = [torch.full((old.numel(),), 7, dtype=torch.int32, device=cuda)
            for _ in range(8)]
    got = graphs.run(300, tokens, pos)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(cache["scan"]["0"][k], eager_cache["scan"]["0"][k])
               for k in ("k", "v"))
    assert not old.any() and not D.split_counters(cuda).any()
    assert all(bool((j == 7).all()) for j in junk)


def test_engine_captures_each_bucket_once(cuda):
    """``capture_graphs`` captures every bucket of the horizon once; a
    served run after it captures nothing and counts its launches as the
    eager engine does."""
    cfg, params = _smoke_on_card(cuda)
    rng = np.random.default_rng(10)
    reqs = [Request(str(i), tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, n)), 9) for i, n in enumerate((130, 20, 250))]
    counts = {}
    for graphs in (False, True):
        eng = ServeEngine(cfg, params, max_slots=2, max_len=300, chunk=4,
                          device=cuda, cuda_graphs=graphs)
        if graphs:
            assert eng.capture_graphs() == 3
            assert sorted(eng.graphs.graphs) == [128, 256, 300]
            assert eng.capture_graphs() == 0
            spent = eng.graphs.capture_s
        K.reset_launches()
        eng.run(reqs)
        torch.cuda.synchronize()
        counts[graphs] = dict(K.LAUNCHES)
    assert eng.graphs.capture_s == spent and len(eng.graphs.graphs) == 3
    assert counts[True] == counts[False]


def test_decode_loop_step_replays_on_the_card(cuda):
    """``make_decode_loop_step`` on CUDA tensors: one graph for a set of
    parameter and cache tensors, replayed; its tokens and cache equal
    the eager chunked step's."""
    cfg, params = _smoke_on_card(cuda)
    cache, tokens = _random_chunk_state(cfg, cuda, 2, 40, 11)
    ref = _clone_cache(cache)
    step = SD.make_chunked_decode_step(cfg, 3)
    loop = TS.make_decode_loop_step(cfg, 3)
    for p in (5, 8):
        want, _, _, _ = step(params, ref, tokens, p)
        got, out = loop(params, cache, {"tokens": tokens}, p)
        assert torch.equal(got, want)
        assert out["scan"]["0"]["k"] is cache["scan"]["0"]["k"]
    assert all(torch.equal(cache["scan"]["0"][k], ref["scan"]["0"][k])
               for k in ("k", "v"))


def test_decode_loop_step_holds_one_graph(cuda):
    """The loop called on one cache, then on another, then on the first
    again: one graph held at a time, over the last call's tensors, and
    each call's tokens and cache equal the eager chunked step's."""
    cfg, params = _smoke_on_card(cuda)
    loop = TS.make_decode_loop_step(cfg, 3)
    step = SD.make_chunked_decode_step(cfg, 3)
    states = [_random_chunk_state(cfg, cuda, 2, 40, seed) for seed in (15, 16)]
    refs = [_clone_cache(c) for c, _ in states]
    held = []
    for i, p in ((0, 5), (1, 9), (1, 12), (0, 8)):
        cache, tokens = states[i]
        want, _, _, _ = step(params, refs[i], tokens, p)
        got, _ = loop(params, cache, {"tokens": tokens}, p)
        assert torch.equal(got, want)
        assert loop.graphs.cache is cache and len(loop.graphs.graphs) == 1
        held.append(loop.graphs)
    # a new graph for each change of cache, the same one while it stays
    assert held[1] is held[2]
    assert len({id(g) for g in held}) == 3
    for (cache, _), ref in zip(states, refs):
        assert all(torch.equal(cache["scan"]["0"][k], ref["scan"]["0"][k])
                   for k in ("k", "v"))


# --- the stream suite -------------------------------------------------------

STREAM_SHAPES = [(256, 512), (253, 484)]      # aligned and ragged


def _within_bf16_ulp(got, want_f32) -> bool:
    """``got`` (bf16) within one bf16 ulp of the fp32 result ``want_f32``
    rounded once to bf16."""
    want = want_f32.bfloat16().float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return bool(((got.float() - want).abs() <= ulp).all())


# name: (call through ops, plain version, number of inputs)
STREAM_ELEMENTWISE = {
    "copy": (lambda x: SO.copy(x[0]), lambda x: SR.copy(x[0]), 1),
    "copy_nt": (lambda x: SO.copy(x[0], flavor="nt"),
                lambda x: SR.copy(x[0]), 1),
    "add": (lambda x: SO.add(x[0], x[1]), lambda x: SR.add(x[0], x[1]), 2),
    "update": (lambda x: SO.update(x[0], 1.5),
               lambda x: SR.update(x[0], 1.5), 1),
    "update_nt": (lambda x: SO.update(x[0], 1.5, flavor="nt"),
                  lambda x: SR.update(x[0], 1.5), 1),
    "stream_triad": (lambda x: SO.stream_triad(x[0], x[1], 2.5),
                     lambda x: SR.stream_triad(x[0], x[1], 2.5), 2),
    "stream_triad_nt": (lambda x: SO.stream_triad(x[0], x[1], 2.5,
                                                  flavor="nt"),
                        lambda x: SR.stream_triad(x[0], x[1], 2.5), 2),
    "schoenauer_triad": (lambda x: SO.schoenauer_triad(*x[:3]),
                         lambda x: SR.schoenauer_triad(*x[:3]), 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STREAM_SHAPES)
@pytest.mark.parametrize("name", list(STREAM_ELEMENTWISE))
def test_stream_elementwise_kernel_matches_plain(cuda, name, shape, dtype):
    """f32: bit-identical to the plain version; bf16: within one bf16 ulp
    of the plain version computed in fp32 from the same bf16 inputs."""
    call, plain, n = STREAM_ELEMENTWISE[name]
    g = torch.Generator(device=cuda).manual_seed(8)
    xs = [torch.randn(shape, generator=g, device=cuda).to(dtype)
          for _ in range(n)]
    K.reset_launches()
    got = call(xs)
    assert K.LAUNCHES[name] == 1 and sum(K.LAUNCHES.values()) == 1
    assert got.dtype == dtype and got.shape == shape
    if dtype == torch.float32:
        assert torch.equal(got, plain(xs))
    else:
        assert _within_bf16_ulp(got, plain([x.float() for x in xs]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(STREAM_ELEMENTWISE))
def test_stream_elementwise_whole_tiles_and_tail(cuda, name, dtype):
    """A length past many whole tiles of 256 threads x 4 vectors, with
    vectors left over and a ragged tail of single elements."""
    call, plain, n = STREAM_ELEMENTWISE[name]
    g = torch.Generator(device=cuda).manual_seed(18)
    xs = [torch.randn((1001, 1003), generator=g, device=cuda).to(dtype)
          for _ in range(n)]
    got = call(xs)
    if dtype == torch.float32:
        assert torch.equal(got, plain(xs))
    else:
        assert _within_bf16_ulp(got, plain([x.float() for x in xs]))


def test_stream_elementwise_ragged_tail(cuda):
    """Lengths that are no multiple of a 16-byte vector: the tail is
    written one element a step."""
    g = torch.Generator(device=cuda).manual_seed(9)
    for n in (1, 3, 1001):
        b, c = (torch.randn(n, generator=g, device=cuda) for _ in range(2))
        for flavor in ("standard", "nt"):
            assert torch.equal(SO.stream_triad(b, c, 2.5, flavor=flavor),
                               SR.stream_triad(b, c, 2.5))
        assert torch.equal(SO.copy(b.bfloat16()), b.bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STREAM_SHAPES + [(7, 100), (8, 101)])
@pytest.mark.parametrize("name", ["init_store", "init_partial", "init_nt"])
def test_stream_init_kernels_match_plain(cuda, name, shape, dtype):
    call = {"init_store": lambda: SO.init(shape, 2.5, dtype, device=cuda),
            "init_nt": lambda: SO.init(shape, 2.5, dtype, flavor="nt",
                                       device=cuda),
            "init_partial": lambda: SO.init_partial(shape, 2.5, dtype,
                                                    device=cuda)}[name]
    K.reset_launches()
    got = call()
    assert K.LAUNCHES[name] == 1
    assert torch.equal(got, SR.init(shape, 2.5, dtype, cuda))


@pytest.mark.parametrize("shape,dtype", [
    ((16384, 16384), torch.float32),          # the stream phase's size
    ((253, 484), torch.float32),
    ((37, 1001), torch.bfloat16),             # odd rows of 2002 bytes
    ((15, 203), torch.bfloat16)])
def test_stream_init_partial_at_size(cuda, shape, dtype):
    """init_partial's 7 x 100 blocks at full size and at odd widths, where
    a block's rows start at every alignment."""
    K.reset_launches()
    got = SO.init_partial(shape, 2.5, dtype, device=cuda)
    assert K.LAUNCHES["init_partial"] == 1
    assert torch.equal(got, SR.init(shape, 2.5, dtype, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STREAM_SHAPES + [(4096, 4099),
                                                   (1 << 12, 1 << 14)])
def test_stream_sum_kernel_matches_plain(cuda, shape, dtype):
    """fp32 partials, summed by the last block: held against the plain
    fp32-accumulated sum (for bf16 too: JAX would round each partial to
    bf16, the port does not). One launch a call, the block counter back
    at 0 after each call, and a repeat bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    K.reset_launches()
    got = SO.sum_reduction(x)
    assert K.LAUNCHES["sum_reduction"] == 1 and got.dtype == torch.float32
    torch.cuda.synchronize()
    assert not SK.sum_counter(cuda).any()
    want = SR.sum_reduction(x.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(SO.sum_reduction(x).view(torch.int32),
                       got.view(torch.int32))
    torch.cuda.synchronize()
    assert not SK.sum_counter(cuda).any()
    # one device event, the sum kernel (chip_smoke's check: a profiler
    # window that saw no device event at all is taken again)
    chip_smoke.one_kernel_event(torch, lambda: SO.sum_reduction(x),
                                "sum_reduction", chip_smoke.SUM_KERNEL)


@pytest.mark.parametrize("n", [262144, 262143, 1, 4097, 2 ** 24 + 8,
                               2 ** 24 - 1, 2 ** 28])
def test_stream_pi_kernel_matches_plain(cuda, n):
    """One launch returning a 0-d float32 pi within 1e-5 of the plain
    version, at ragged n (the last block masked), at an n outside the
    reciprocal route's proof (2^24 - 1, IEEE division) and the main
    path's; within 1e-4 * pi of pi where the rule has points enough.

    The plain version's terms on the card are the kernel's, bit for bit:
    4 times the numpy model's quotient and reciprocal (the model the
    kernel's sum is held to in ``test_stream_pi_kernel_is_its_model``),
    on every point up to 2^24 + 8 and on a sample of 2^28. Only the two
    sums' orders differ."""
    K.reset_launches()
    got = SO.pi_integration(n, device=cuda)
    assert K.LAUNCHES["pi_integration"] == 1
    assert got.shape == () and got.dtype == torch.float32
    want = SR.pi_integration(n, device=cuda)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    if n >= 262143:
        assert abs(got.item() - np.pi) < 1e-4 * np.pi
    terms = SR.pi_terms(n, device=cuda)
    idx = np.arange(n, dtype=np.int64) if n <= 2 ** 25 else np.unique(
        np.concatenate([np.arange(0, n, 4099), np.arange(n - 8192, n)]))
    for s in range(0, len(idx), 1 << 22):
        part = idx[s:s + (1 << 22)]
        plain = terms[torch.from_numpy(part).to(cuda)].cpu().numpy()
        model = np.float32(4) * PM.kernel_terms(n, part)
        assert np.array_equal(plain.view(np.uint32), model.view(np.uint32))


@pytest.mark.parametrize("n", [4097, 2 ** 24 + 8])
def test_stream_pi_one_event_counter_and_repeats(cuda, n):
    """A call is one device event, the pi kernel (no sum, no division
    after it); its block counter is 0 after every call, and repeats are
    bit-identical."""
    counter, _ = SK.pi_scratch(cuda)
    first = SO.pi_integration(n, device=cuda)
    torch.cuda.synchronize()
    assert not counter.any()
    again = SO.pi_integration(n, device=cuda)
    torch.cuda.synchronize()
    assert not counter.any()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    chip_smoke.one_kernel_event(torch, lambda: SO.pi_integration(
        n, device=cuda), "pi_integration", chip_smoke.PI_KERNEL)


@pytest.mark.parametrize("n", [1, 4097, 262143, 2 ** 24 + 8, 2 ** 24 - 1])
def test_stream_pi_kernel_is_its_model(cuda, n):
    """The kernel's result bit for bit the numpy model's
    (``tests/_pi_model.py``: each point's arithmetic and the reduction
    order, on this card's SM count)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = SO.pi_integration(n, device=cuda).item()
    assert np.float32(got) == PM.kernel_sum(n, sms)


@pytest.mark.parametrize("name,shape,sweeps", [
    ("jacobi_2d5pt", (258, 514), None), ("jacobi_2d5pt", (253, 484), None),
    ("jacobi_3d7pt", (18, 34, 130), None), ("jacobi_3d7pt", (17, 29, 101),
                                            None),
    ("gauss_seidel_2d5pt", (34, 128), 2), ("gauss_seidel_2d5pt", (33, 101), 1),
    ("gauss_seidel_2d5pt", (20, 2500), 3),   # 3 columns a thread
    ("gauss_seidel_2d5pt", (3, 2500), 2),    # one interior row, two sweeps
    ("gauss_seidel_2d5pt", (3, 101), 3),
    ("gauss_seidel_2d5pt", (6, 20000), 2),
    ("gauss_seidel_2d5pt", (5, 40002), 1),
    # widths of 32k + 2 and 32k + 3 columns (the 4-byte route) and of 4k
    # (the TMA route); no sweep (a copy); sweeps in one pass (4), two
    # passes (8, the first into the temporary grid) and three (9, the
    # first into the output); chip_smoke's main-path shape
    ("gauss_seidel_2d5pt", (40, 130), 2), ("gauss_seidel_2d5pt", (40, 131), 2),
    ("gauss_seidel_2d5pt", (40, 130), 0), ("gauss_seidel_2d5pt", (40, 132), 0),
    ("gauss_seidel_2d5pt", (70, 131), 4), ("gauss_seidel_2d5pt", (70, 132), 4),
    ("gauss_seidel_2d5pt", (70, 130), 8), ("gauss_seidel_2d5pt", (70, 132), 8),
    ("gauss_seidel_2d5pt", (70, 131), 9), ("gauss_seidel_2d5pt", (70, 132), 9),
    ("gauss_seidel_2d5pt", (300, 4098), 5), ("gauss_seidel_2d5pt", (300, 4096), 5),
    ("gauss_seidel_2d5pt", (4098, 4096), 2),
])
def test_stream_stencil_kernels_match_plain(cuda, name, shape, sweeps):
    """Within 1e-6 of the plain version; Gauss-Seidel bit for bit (the
    kernel sums in the plain version's order with the _rn intrinsics),
    one launch a pass of its plan."""
    g = torch.Generator(device=cuda).manual_seed(11)
    u = torch.randn(shape, generator=g, device=cuda)
    args = () if sweeps is None else (sweeps,)
    K.reset_launches()
    got = getattr(SO, name)(u, *args)
    want_launches = 1 if sweeps is None else len(
        SK.gauss_seidel_plan(*shape, sweeps).fused)
    assert K.LAUNCHES[name] == want_launches
    want = getattr(SR, name)(u, *args)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if sweeps is not None:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,sweeps", [
    ("jacobi_2d5pt", (17, 101), None), ("jacobi_3d7pt", (6, 9, 13), None),
    ("gauss_seidel_2d5pt", (17, 101), 2),
    # a first pass on the 4-byte route, then passes on the TMA route
    ("gauss_seidel_2d5pt", (70, 132), 2), ("gauss_seidel_2d5pt", (70, 132), 9),
])
def test_stream_stencils_take_offset_views(cuda, name, shape, sweeps):
    """The stencils load one float at a time (Gauss-Seidel on its 4-byte
    route), so a contiguous view whose data start off a 16-byte boundary
    is served."""
    g = torch.Generator(device=cuda).manual_seed(12)
    n = int(np.prod(shape))
    u = torch.randn(n + 1, generator=g, device=cuda)[1:].view(shape)
    assert u.is_contiguous() and u.data_ptr() % 16
    args = () if sweeps is None else (sweeps,)
    K.reset_launches()
    got = getattr(SO, name)(u, *args)
    assert K.LAUNCHES[name] == (1 if sweeps is None else len(
        SK.gauss_seidel_plan(*shape, sweeps, aligned=False).fused))
    torch.testing.assert_close(got, getattr(SR, name)(u, *args), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape,offset", [
    ((6, 9, 13), 0), ((17, 29, 101), 0), ((18, 34, 130), 0),
    ((18, 34, 132), 0), ((20, 40, 256), 0), ((3, 3, 3), 0),
    ((40, 20, 20), 0), ((130, 7, 68), 0),
    ((17, 29, 100), 1),              # an offset view: the 4-byte route
])
def test_jacobi_3d7pt_bit_identical(cuda, shape, offset):
    """The plane-tile kernel against its plain version, bit for bit, in one
    launch: both TMA (W % 4 == 0, aligned) and 4-byte routes, ragged tiles
    and chunks, a single point."""
    g = torch.Generator(device=cuda).manual_seed(16)
    n = int(np.prod(shape))
    u = torch.randn(n + offset, generator=g, device=cuda)[offset:].view(shape)
    K.reset_launches()
    got = SO.jacobi_3d7pt(u)
    assert K.LAUNCHES["jacobi_3d7pt"] == 1
    want = SR.jacobi_3d7pt(u)
    assert got.shape == want.shape and torch.equal(got, want)


def test_stream_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 4, device=cuda)
    with pytest.raises(ValueError, match="one device, dtype and shape"):
        SO.add(x, torch.zeros(4, 5, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        SO.copy(x.t()[:, :3])
    with pytest.raises(ValueError, match="16-byte aligned"):
        SO.copy(x.view(-1)[1:])
    with pytest.raises(ValueError, match="takes"):
        SO.jacobi_2d5pt(x.double())
    with pytest.raises(ValueError, match="2-D grid"):
        SO.gauss_seidel_2d5pt(torch.zeros(3, 4, 5, device=cuda))


# --- the analysis half on the card (core/ubench.py, core/rpe.py) ------------

def test_card_calibration_registers_measured_model(cuda):
    """The card's calibration: every class rate positive, the block sweep
    rising with blocks to the chip's rate, the measured L2 faster than
    HBM3, and ``h100_measured`` registered with the measured tensor-core
    rate; ``h100`` unchanged."""
    from repro_torch.core import machine as TM
    from repro_torch.core import ubench
    h100 = TM.get_machine("h100")
    try:
        m = ubench.calibrated_host_model(device="cuda", refresh=True)
        raw = ubench.calibration("cuda")
        assert m.name == "h100_measured" and TM.get_machine(m.name) is m
        assert all(v > 0 for v in raw["rates"].values())
        for tier, sweep in raw["cta_sweep"].items():
            rates = dict(sweep)
            assert rates[1] > 0 and max(rates.values()) > 4 * rates[1], tier
        l2, hbm = m.mem_tiers[2], m.mem_tiers[3]
        assert (l2.name, hbm.name) == ("L2", "HBM3")
        assert l2.shared_bw > hbm.shared_bw > 1e12
        # measured: the ceilings and HBM3's per-SM read; published: L2's
        # per-SM rate and the stores
        pub = h100.mem_tiers
        assert (l2.load_bw, l2.store_bw) == (pub[2].load_bw,
                                             pub[2].store_bw)
        assert hbm.store_bw == pub[3].store_bw
        assert hbm.load_bw == dict(raw["cta_sweep"]["HBM3"])[1]
        assert m.chip.bf16_flops == raw["flops_matmul"] > 1e14
        assert TM.get_machine("h100") == h100
    finally:
        ubench.forget("cuda")


@pytest.mark.parametrize("kernel", SR.KERNELS_13)
def test_rpe_kernel_variant_matches_plain(cuda, kernel):
    """The Fig. 3 ``kernel`` variant on the card (the hand-written kernel)
    against the ``eager`` variant (the plain version) on the same inputs;
    the stencils without a kernel run plain in both."""
    from repro_torch.core import rpe
    n = 1 << 16
    args = rpe.make_inputs(kernel, n, device="cuda")
    before = dict(K.LAUNCHES)
    fn, a = rpe.build_variant(kernel, "kernel", n, device="cuda", args=args)
    got = fn(*a)
    launched = {k for k, v in K.LAUNCHES.items() if v != before[k]}
    assert launched == (set() if kernel in rpe.PLAIN_KERNELS else
                        {"init_store" if kernel == "init" else kernel})
    pfn, pa = rpe.build_variant(kernel, "eager", n, device="cuda",
                                args=args)
    want = pfn(*pa)
    if kernel == "init":
        want = want.reshape(got.shape)
    # a sum's rounding scales with the sum of its terms' magnitudes
    scale = float(args[0].abs().sum() if kernel == "sum_reduction"
                  else want.abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-6,
                               atol=1e-6 * scale)


# --- the router's engine hooks and the serving benchmarks on the card ------

def _hook_requests(cfg, lens, news, seed):
    rng = np.random.default_rng(seed)
    return [Request(f"h{i}", tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, n)), m) for i, (n, m) in enumerate(zip(lens,
                                                                  news))]


def _chunk_schedule(eng, reqs, chunks):
    """Admit ``reqs``, then step with ``chunks[r]`` set before round r
    (the last one after), to the end; returns {rid: tokens}."""
    for r in reqs:
        eng.admit(r)
    out, rnd = {}, 0
    while any(s is not None for s in eng.slots):
        eng.set_chunk(chunks[min(rnd, len(chunks) - 1)])
        out.update({rid: t.tolist() for rid, t in eng.step()})
        rnd += 1
    return out


@pytest.mark.parametrize("arch", ["yi-9b", "xlstm-125m"])
def test_set_chunk_replays_a_seen_chunk_without_capture(cuda, arch):
    """Chunks 4, 2, 4, 2, ...: each length's graphs are captured at its
    first use and replayed after, capturing nothing more, on the same
    cache tensors; the streams are the eager engine's under the same
    schedule."""
    cfg, params = _smoke_params(arch, 5)
    params = _to(params, cuda)
    reqs = _hook_requests(cfg, (7, 12, 5), (15, 11, 13), 21)
    out = {}
    for graphs in (False, True):
        eng = ServeEngine(cfg, params, max_slots=3, max_len=64, chunk=4,
                          device=cuda, cuda_graphs=graphs)
        ptrs = [t.data_ptr() for t in M.state_leaves(cfg, eng.cache)] + [
            t.data_ptr() for part in eng.cache["scan"].values()
            for t in part.values()]
        if graphs:
            _chunk_schedule(eng, reqs[:1], [4, 2])
            captured = eng.captured_graphs()
            assert captured == 2 and eng.chunk_lengths == [2, 4]
            pool = eng.graphs.pool
        out[graphs] = _chunk_schedule(eng, reqs, [4, 2, 4, 2, 4, 2])
        assert [t.data_ptr() for t in M.state_leaves(cfg, eng.cache)] + [
            t.data_ptr() for part in eng.cache["scan"].values()
            for t in part.values()] == ptrs
    assert eng.captured_graphs() == captured      # nothing recaptured
    assert all(g.pool == pool and g.stream == eng.graphs.stream
               for _, g in eng._chunks.values())
    assert out[True] == out[False]


def test_poison_under_graph_replay_is_quarantined(cuda):
    """The NaN poison written in place into the recurrent state that a
    captured graph replays over (xlstm-125m) reaches the graph: the
    victim is quarantined with its tokens so far, the scrub leaves the
    bystander's state bit for bit, and the bystander streams as in a run
    without the poison; no cache tensor moved, no graph recaptured."""
    from repro_torch.serve.faults import poison_slot, scrub_nonfinite
    cfg, params = _smoke_params("xlstm-125m", 6)
    params = _to(params, cuda)
    reqs = _hook_requests(cfg, (6, 9), (12, 12), 22)

    def run(poison):
        eng = ServeEngine(cfg, params, max_slots=2, max_len=48, chunk=3,
                          device=cuda)
        for r in reqs:
            eng.admit(r)
        out = dict(eng.step())
        captured = eng.captured_graphs()
        ptrs = [t.data_ptr() for t in M.state_leaves(cfg, eng.cache)]
        if poison:
            poison_slot(eng, 0)
            assert eng.step() == []
            q = eng.drain_quarantined()
            assert [r for r, _ in q] == ["h0"] and len(q[0][1]) == 4
            state = M.state_leaves(cfg, eng.cache)
            kept = [t[:, 1].clone() for t in state]
            scrub_nonfinite(eng)
            assert all(bool(torch.isfinite(t).all()) for t in state)
            assert all(torch.equal(t[:, 1], k) for t, k in zip(state, kept))
        while any(s is not None for s in eng.slots):
            out.update(dict(eng.step()))
        assert [t.data_ptr() for t in M.state_leaves(cfg, eng.cache)] == ptrs
        assert eng.captured_graphs() == captured == 1
        return {r: t.tolist() for r, t in out.items()}

    clean, poisoned = run(False), run(True)
    assert "h0" not in poisoned and poisoned["h1"] == clean["h1"]


def test_fig7_bounded_kernel_beats_the_full_horizon(cuda):
    """fig7's paths at yi-9b's heads (two layers of its published width):
    at 1/8 occupancy of a 4096-row horizon the bounded decode kernel's
    device time a step is under the full horizon's, and at full occupancy
    the bounded time is over its 1/8 time."""
    from repro_torch.bench import fig7_decode as F7
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(7),
                           device=cuda)
    rec = F7.decode_record(cfg, params, 8, 4096, (512, 4096), 3, cuda)
    lo, hi = rec["cells"]
    assert lo["k_split"] < lo["k_dense"]
    assert lo["k_split"] < hi["k_split"]


@pytest.mark.parametrize("module", ["fig2_unitmix", "fig5_memladder",
                                    "fig6_serve", "fig7_decode",
                                    "fig8_paged", "fig9_load",
                                    "fig10_chaos"])
def test_bench_module_runs_on_the_card(cuda, module, capsys):
    """``python -m repro_torch.bench.run --only <module>`` on the card
    (its default device) runs the module to its ``ok`` line."""
    from repro_torch.bench import run as bench_run
    assert bench_run.main(["--only", module]) == 0
    out = capsys.readouterr().out
    assert f"_meta,{module}," in out and out.rstrip().endswith(",ok")
    torch.cuda.empty_cache()


# --- the runtime around the engine: pipelined dispatch, staging, snapshots --

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("graphs", [False, True])
def test_pipelined_streams_equal_serial_on_the_card(cuda, paged, temperature,
                                                    graphs):
    """Smoke fp32 yi-9b, dense and paged, greedy and sampled, graphed and
    eager: pipeline=2 streams and dispatch counts equal the serial
    engine's, with admissions while rounds are in flight."""
    cfg, params = _smoke_params("yi-9b", 5)
    params = _to(params, cuda)
    reqs = _hook_requests(cfg, (7, 12, 5, 9, 6), (15, 11, 13, 9, 1), 23)
    out = {}
    for pipeline in (0, 2):
        kw = dict(max_slots=3, max_len=64, chunk=4, temperature=temperature,
                  seed=2, device=cuda, cuda_graphs=graphs, pipeline=pipeline)
        eng = PagedServeEngine(cfg, params, page_size=8, **kw) if paged \
            else ServeEngine(cfg, params, **kw)
        out[pipeline] = ({r: t.tolist() for r, t in eng.run(reqs).items()},
                         eng.decode_dispatches)
        assert eng.stats()["in_flight"] == 0
    assert out[0] == out[2]


def test_pipelined_rounds_make_no_blocking_call(cuda):
    """Two graphed rounds from nothing in flight: serial rounds read their
    tokens back with a stream sync between the enqueues, pipelined rounds
    make no blocking call there (``chip_smoke.blocking_between_enqueues``
    over the profile's host calls)."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = _smoke_params("yi-9b", 6)
    params = _to(params, cuda)
    eng = ServeEngine(cfg, params, max_slots=3, max_len=64, chunk=4,
                      device=cuda, pipeline=2)
    reqs = _hook_requests(cfg, (7, 12, 5), (17, 17, 17), 24)
    got = {}
    for depth in (0, 2):
        eng.pipeline = depth
        for r in reqs:
            eng.admit(Request(f"{depth}{r.rid}", r.prompt, r.max_new_tokens))
        eng.step()
        eng.sync()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            eng.step()
            eng.sync()
            torch.cuda.synchronize()
        got[depth] = chip_smoke.blocking_between_enqueues(prof)
        while any(eng.slots):
            eng.step()
        eng.sync()
    assert got[2] == ({}, 2)
    assert got[0][1] == 2 and got[0][0].get("cudaStreamSynchronize", 0) > 0


def test_stager_copies_on_a_side_stream(cuda):
    """A staged prompt is copied from pinned memory on the stager's own
    stream with an event; take() hands the same ids the inline path
    makes, staged or not."""
    from repro_torch.serve.staging import PromptStager
    st = PromptStager(depth=2, device=cuda)
    assert st.stage("a", (1, 2, 3)) is True
    _, dev, done = st._staged["a"]
    assert isinstance(done, torch.cuda.Event)
    assert st._stream != torch.cuda.current_stream(cuda)
    assert dev.device.type == "cuda"
    got = st.take("a", (1, 2, 3))
    assert got.dtype == torch.int64 and got.cpu().tolist() == [[1, 2, 3]]
    assert st.take("b", (4, 5)).cpu().tolist() == [[4, 5]]
    assert st.stats() == {"staged": 1, "hits": 1, "misses": 1, "queued": 0}


def test_snapshot_copies_into_pinned_buffers_on_a_side_stream(cuda,
                                                              tmp_path):
    """CUDA leaves are copied into pinned buffers, reused across saves, on
    the checkpointer's stream; they restore bit for bit on the card."""
    from repro_torch.checkpoint import Checkpointer
    gen = torch.Generator(device=cuda).manual_seed(3)
    tree = {"w": torch.randn((64, 33), generator=gen, device=cuda).to(
        torch.bfloat16), "b": {"n": torch.arange(7, dtype=torch.int32,
                                                 device=cuda)}}
    ck = Checkpointer(str(tmp_path))
    ready = torch.cuda.Event()
    ready.record()
    assert ck.save(1, tree, block=True, after=ready)
    bufs = dict(ck._pinned)
    assert bufs and all(b.is_pinned() for b in bufs.values())
    assert ck._stream != torch.cuda.current_stream(cuda)
    assert ck.save(2, tree, block=True)
    assert all(ck._pinned[i] is b for i, b in bufs.items())
    back = ck.restore(2, tree)
    assert back["w"].device.type == "cuda"
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(back["b"]["n"], tree["b"]["n"])
