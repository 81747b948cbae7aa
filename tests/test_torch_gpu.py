"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip on a machine without a CUDA device. This
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import stores
from repro_torch.kernels.attention import decode as D
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention import ref as R
from repro_torch.kernels.stream import ops as SO
from repro_torch.kernels.stream import ref as SR
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
] + [(3, 200, 32, 2, 128, 4, 40, None), (3, 200, 16, 2, 128, 8, None, None)])
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
  + [(3, 200, 16, 2, 128, 8, 40, 16, None)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,s,dh,window,bq,bk,causal", [
    (4, 2, 77, 32, None, None, 64, True),        # ragged S
    (8, 2, 200, 64, 40, 8, 32, True),            # window, bk 32
    (32, 4, 509, 128, None, None, 64, True),     # yi-9b heads, ragged
    (32, 4, 512, 128, 256, None, 64, True),      # yi-9b heads, window
] + [
    # the edges of the tensor-core tiling (16 packed rows a warp, 32- or
    # 64-key tiles), in both bodies (bf16 tensor cores, fp32 scalar): S
    # of one row, around one and four mma tiles
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
@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_stream_sum_kernel_matches_plain(cuda, shape, dtype):
    """fp32 partials: held against the plain fp32-accumulated sum (for
    bf16 too: JAX would round each partial to bf16, the port does not)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    K.reset_launches()
    got = SO.sum_reduction(x)
    assert K.LAUNCHES["sum_reduction"] == 1 and got.dtype == torch.float32
    want = SR.sum_reduction(x.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [262144, 262143])
def test_stream_pi_kernel_matches_plain(cuda, n):
    K.reset_launches()
    got = SO.pi_integration(n, device=cuda)
    assert K.LAUNCHES["pi_integration"] == 1
    want = SR.pi_integration(n, device=cuda)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert abs(got.item() - np.pi) < 1e-4 * np.pi


@pytest.mark.parametrize("name,shape,sweeps", [
    ("jacobi_2d5pt", (258, 514), None), ("jacobi_2d5pt", (253, 484), None),
    ("jacobi_3d7pt", (18, 34, 130), None), ("jacobi_3d7pt", (17, 29, 101),
                                            None),
    ("gauss_seidel_2d5pt", (34, 128), 2), ("gauss_seidel_2d5pt", (33, 101), 1),
    ("gauss_seidel_2d5pt", (20, 2500), 3),   # 3 columns a thread
    ("gauss_seidel_2d5pt", (3, 2500), 2),    # one interior row, two sweeps
    ("gauss_seidel_2d5pt", (3, 101), 3),
    # past the 16,384 interior columns held in registers: the rest of a
    # row is staged in the scratch row
    ("gauss_seidel_2d5pt", (6, 20000), 2),
    ("gauss_seidel_2d5pt", (5, 40002), 1),
])
def test_stream_stencil_kernels_match_plain(cuda, name, shape, sweeps):
    g = torch.Generator(device=cuda).manual_seed(11)
    u = torch.randn(shape, generator=g, device=cuda)
    args = () if sweeps is None else (sweeps,)
    K.reset_launches()
    got = getattr(SO, name)(u, *args)
    assert K.LAUNCHES[name] == 1
    want = getattr(SR, name)(u, *args)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,shape,sweeps", [
    ("jacobi_2d5pt", (17, 101), None), ("jacobi_3d7pt", (6, 9, 13), None),
    ("gauss_seidel_2d5pt", (17, 101), 2),
])
def test_stream_stencils_take_offset_views(cuda, name, shape, sweeps):
    """The stencils load and store one float at a time, so a contiguous
    view whose data start off a 16-byte boundary is served."""
    g = torch.Generator(device=cuda).manual_seed(12)
    u = torch.randn((shape[0] + 1,) + shape[1:], generator=g, device=cuda)[1:]
    assert u.is_contiguous() and u.data_ptr() % 16
    args = () if sweeps is None else (sweeps,)
    K.reset_launches()
    got = getattr(SO, name)(u, *args)
    assert K.LAUNCHES[name] == 1
    torch.testing.assert_close(got, getattr(SR, name)(u, *args), rtol=1e-6,
                               atol=1e-6)


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
