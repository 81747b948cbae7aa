"""Split-KV flash decode of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs the CUDA kernel's plain version (the
same per-split partials) and the split combine; both are held against
JAX's dense oracle ``ref_decode`` and its Pallas kernel in interpret
mode. fp32 agrees within 1e-5 (summation order only). In bf16 both sides
compute in fp32 and round the output once, so they agree within one
bf16 ulp at |x| < 2 (1e-2).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import decode as JD
from repro.kernels.attention import ops as JOPS
from repro_torch import kernels as K
from repro_torch.kernels.attention import decode as D
from repro_torch.kernels.attention import ops

from _torch_common import f32

NEG_INF = D.NEG_INF

torch.set_num_threads(1)

CASES = [
    # (b, skv, h, hkv, dh, sq, window, bk, n_splits, pos)
    (2, 64, 4, 2, 32, 1, None, 32, 1, [40, 63]),        # GQA g=2
    (3, 77, 4, 1, 32, 1, None, 16, 3, [3, 40, 76]),     # MQA, ragged, dead
    (2, 77, 8, 2, 32, 3, None, 16, 3, [5, 70]),         # Sq=3, ragged
    (2, 96, 4, 2, 32, 1, 24, 16, 3, [10, 90]),          # window, dead splits
    (2, 50, 4, 2, 32, 3, 16, 16, 1, [20, 47]),          # window, Sq=3
]


# head shapes past the smoke config's: gemma3-4b's head_dim 256, and G=16
# at Sq=4 (64 packed query rows a KV head, more than one row group of the
# CUDA kernel), against JAX's Pallas kernel in interpret mode
WIDE_CASES = [
    # (b, skv, h, hkv, dh, sq, window, bk, n_splits, pos)
    (1, 40, 2, 1, 256, 1, None, 16, 2, [37]),         # Dh=256
    (1, 40, 2, 1, 256, 2, 24, 16, 3, [20]),           # Sq=2, window, dead
    (2, 40, 16, 1, 32, 4, None, 16, 2, [30, 9]),      # G*Sq = 64
]


def _case(b, skv, h, hkv, dh, sq, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(dtype)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(dtype)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(dtype)
    return q, k, v


def _jax(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _torch(*xs, dtype=torch.float32):
    return [torch.tensor(x, dtype=dtype) for x in xs]


@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,bk,ns,pos", CASES)
def test_flash_decode_matches_jax_oracle_f32(b, skv, h, hkv, dh, sq, window,
                                             bk, ns, pos):
    q, k, v = _case(b, skv, h, hkv, dh, sq)
    oracle = JD.ref_decode(*_jax(q, k, v), jnp.asarray(pos, jnp.int32),
                           window=window)
    tpos = torch.tensor(pos, dtype=torch.int32)
    got = D.flash_decode(*_torch(q, k, v), tpos, window=window, bk=bk,
                         n_splits=ns)
    np.testing.assert_allclose(f32(got), f32(oracle), rtol=1e-5, atol=1e-5)
    dense = D.ref_decode(*_torch(q, k, v), tpos, window=window)
    np.testing.assert_allclose(f32(dense), f32(oracle), rtol=1e-5, atol=1e-5)


# interpret mode is slow: three cases cover Sq 1 and 3, ragged Skv, a
# window, n_splits 1 and 3, and dead splits; then the wide head shapes
@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,bk,ns,pos",
                         [CASES[0], CASES[2], CASES[3]] + WIDE_CASES)
def test_flash_decode_matches_jax_kernel_f32(b, skv, h, hkv, dh, sq, window,
                                             bk, ns, pos):
    q, k, v = _case(b, skv, h, hkv, dh, sq)
    want = JD.flash_decode(*_jax(q, k, v), jnp.asarray(pos, jnp.int32),
                           window=window, bk=bk, n_splits=ns, interpret=True)
    got = D.flash_decode(*_torch(q, k, v), torch.tensor(pos, dtype=torch.int32),
                         window=window, bk=bk, n_splits=ns)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,bk,ns,pos",
                         [CASES[2], CASES[3]] + WIDE_CASES)
def test_flash_decode_matches_jax_bf16(b, skv, h, hkv, dh, sq, window, bk,
                                       ns, pos):
    q, k, v = _case(b, skv, h, hkv, dh, sq, seed=1)
    jpos = jnp.asarray(pos, jnp.int32)
    want = JD.flash_decode(*_jax(q, k, v, dtype=jnp.bfloat16), jpos,
                           window=window, bk=bk, n_splits=ns, interpret=True)
    got = D.flash_decode(*_torch(q, k, v, dtype=torch.bfloat16),
                         torch.tensor(pos, dtype=torch.int32),
                         window=window, bk=bk, n_splits=ns)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=1e-2)


def test_dead_splits_carry_zero_weight():
    """A split wholly past pos (or before the window) is never read and
    leaves (m=-1e30, l=0, o=0), even over NaN cache rows."""
    q, k, v = _case(2, 64, 4, 2, 32, 1, seed=2)
    qt, kt, vt = _torch(q, k, v)
    pos = torch.tensor([5, 60], dtype=torch.int32)
    kt[0, 16:] = float("nan")          # slot 0 never reads past row 5
    vt[0, 16:] = float("nan")
    o, m, l = D.decode_partials(qt, kt, vt, pos, window=None, split_len=16,
                                n_splits=4, bound=64)
    assert torch.all(m[1:, 0] == D.NEG_INF) and torch.all(l[1:, 0] == 0)
    assert torch.all(o[1:, 0] == 0)
    got = D.combine_splits(o, m, l)
    want = JD.ref_decode(*_jax(q, k, v), jnp.asarray([5, 60], jnp.int32))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_combine_splits_matches_jax():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((3, 2, 1, 4, 8)).astype(np.float32)
    m = rng.standard_normal((3, 2, 1, 4)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (3, 2, 1, 4)).astype(np.float32)
    o[1], m[1], l[1] = 0.0, -1e30, 0.0          # a dead split
    want = JD.combine_splits(*_jax(o, m, l))
    got = D.combine_splits(*_torch(o, m, l))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_len", [None, 22, 40])
def test_ops_occupancy_bound_matches_jax(kv_len):
    """kv_len is rounded up to the block grid; rows past the rounded
    bound are never read (NaN there changes nothing)."""
    q, k, v = _case(2, 64, 4, 2, 32, 1, seed=4)
    pos = [9, 21]
    want = JOPS.flash_decode(*_jax(q, k, v), jnp.asarray(pos, jnp.int32),
                             impl="pallas", bk=16, n_splits=2, kv_len=kv_len)
    qt, kt, vt = _torch(q, k, v)
    cut = None
    if kv_len is not None:
        cut = -(-kv_len // 16) * 16
        kt[:, cut:] = float("nan")
        vt[:, cut:] = float("nan")
    tpos = torch.tensor(pos, dtype=torch.int32)
    for impl in ("ref", "auto"):
        got = ops.flash_decode(qt, kt, vt, tpos, impl=impl, bk=16,
                               n_splits=2, kv_len=kv_len)
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                   atol=1e-5, err_msg=impl)
    oracle = D.ref_decode(qt, kt, vt, tpos, kv_len=cut)
    np.testing.assert_allclose(f32(oracle), f32(want), rtol=1e-5, atol=1e-5)


def test_impl_routing_on_cpu():
    q, k, v = _torch(*_case(1, 16, 2, 1, 32, 1))
    pos = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_decode(q, k, v, pos, impl="pallas")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.flash_decode(q, k, v, pos, impl="cuda")
    K.reset_launches()
    ops.flash_decode(q, k, v, pos, impl="auto")
    assert K.LAUNCHES["flash_decode"] == 0     # the plain version ran


@pytest.mark.parametrize("h,hkv,tp", [(32, 4, 1), (32, 4, 4), (32, 4, 8),
                                      (30, 6, 4), (8, 8, 2)])
def test_validate_tp_heads_matches_jax(h, hkv, tp):
    try:
        want = JOPS.validate_tp_heads(h, hkv, 128, tp)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            ops.validate_tp_heads(h, hkv, 128, tp)
    else:
        assert ops.validate_tp_heads(h, hkv, 128, tp) == want


def test_default_splits_cover_the_sms():
    # yi-9b serving: 8 slots x 4 KV heads = 32 blocks a split; 4 splits
    # fill one wave of the SMs, a fifth would start a second
    assert D.default_splits(8, 4, 100) == 4
    assert 8 * 4 * 4 <= D.H100_SMS < 8 * 4 * 5
    assert D.default_splits(8, 4, 3) == 3          # no more than blocks
    assert D.default_splits(1, 8, 100) == 8        # the merge's 8, not 16
    assert D.default_splits(8, 32, 100) == 1       # 256 blocks a split
    bound, split_len, n = D.split_plan(8, 4, 2048, 128, None, 600)
    assert (bound, n) == (600, 4) and split_len * n >= bound


@pytest.mark.parametrize("hkv", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_default_splits_stop_at_the_merge_cap(b, hkv):
    """The serving path's count is the most splits one wave of the SMs
    holds, but never more than a finished launch merges: the cap binds
    where B * Hkv <= 16."""
    wave = D.H100_SMS // (b * hkv)
    want = max(1, min(D.MERGE_MAX_SPLITS, wave))
    assert D.default_splits(b, hkv, 10_000) == want
    assert D.default_splits(b, hkv, 2) == min(2, want)
    assert D.MERGE_MAX_SPLITS == 8
    _, _, n = D.split_plan(b, hkv, 65536, 128, None, None)
    assert n == want
    _, _, pn = D.paged_split_plan(b, hkv, 16, 4096, None)
    assert pn == want


@pytest.mark.parametrize("n_splits", [1, 5, 8, 9, 16, 17, 64])
def test_kernel_split_plan_fits_one_merge(n_splits):
    """A finished launch runs at most the merge's splits: a plan of more
    merges runs of adjacent splits, reading the same rows (the plan's
    cover, in contiguous splits whose boundaries are the plan's), and a
    plan of at most 8 is left as it is."""
    split_len = 48
    got_len, got_n = D.kernel_split_plan(split_len, n_splits)
    assert 1 <= got_n <= D.MERGE_MAX_SPLITS
    assert got_len % split_len == 0
    assert got_len * got_n >= split_len * n_splits
    assert got_len * (got_n - 1) < split_len * n_splits
    if n_splits <= D.MERGE_MAX_SPLITS:
        assert (got_len, got_n) == (split_len, n_splits)


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_page_boxes_never_cross_a_page(dtype, dh):
    """The paged kernel's copies (``gcd(page, tile)`` rows, the tile 64
    bf16 rows, 32 at Dh 256 and in fp32) for every page from 1 to 300
    rows: the boxes of every tile of every split of the paged plan cover
    the tile and none crosses a page, so any page size is served."""
    tile = D.kernel_tile_rows(dtype, dh)
    assert tile == (32 if dtype == torch.float32 or dh == 256 else 64)
    for ps in range(1, 301):
        box = D.page_box_rows(dtype, dh, ps)
        assert tile % box == 0 and ps % box == 0
        _, split_len, n = D.paged_split_plan(8, 4, ps, -(-900 // ps), None)
        for s in range(n):
            for t0 in range(s * split_len, (s + 1) * split_len, tile):
                for r in range(t0, t0 + tile, box):
                    assert r // ps == (r + box - 1) // ps


@pytest.mark.parametrize("kv_len", [512, 1792, 4096])
@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b"])
def test_h100_tuner_picks_one_wave_of_splits(arch, kv_len):
    """The tuner on ``h100`` at the served buckets (8 slots): 4 splits,
    the most one wave of the SMs holds (128 blocks on 132) and the
    serving path's count; fewer splits stream longer, more take a second
    wave and merge more partials."""
    from repro_torch.kernels import tuning
    h, hkv, dh = {"yi-9b": (32, 4, 128), "gemma3-4b": (8, 4, 256)}[arch]
    plan = tuning.decode_tiles("h100", skv=kv_len, dh=dh, h=h, hkv=hkv,
                               batch=8, dtype="bfloat16")
    assert plan.n_splits == 4
    assert plan.n_splits == D.default_splits(8, hkv, -(-kv_len // 128))
    assert plan.seconds > tuning.SPLIT_MERGE_S


@pytest.mark.parametrize("n_splits", [1, 2, 5, 8])
def test_split_order_merge_equals_combine_splits(n_splits):
    """The last block of a row group merges the splits one at a time in
    split order 0 .. S-1 (``csrc/decode.cu``'s ``split_merge_end``), dead
    splits (m = -1e30, l = 0, o = 0) weighing exactly 0. In plain torch that
    order gives ``combine_splits``' output up to the order of fp32 sums
    of at most 8 terms (torch reduces 8 splits in another order than
    one at a time; one split is the same bits); the kernel also contracts
    its products and sums into FMAs, so the card's tests hold the two
    within the decode tolerance."""
    rng = np.random.default_rng(n_splits)
    shape = (n_splits, 3, 2, 8)
    o = torch.tensor(rng.standard_normal(shape + (32,)), dtype=torch.float32)
    m = torch.tensor(rng.standard_normal(shape) * 4, dtype=torch.float32)
    l = torch.tensor(rng.random(shape) * 9 + 1, dtype=torch.float32)
    if n_splits > 1:
        o[-1], m[-1], l[-1] = 0.0, NEG_INF, 0.0
    mx = m[0]
    for s in range(1, n_splits):
        mx = torch.maximum(mx, m[s])
    acc = torch.zeros_like(o[0])
    tot = torch.zeros_like(l[0])
    for s in range(n_splits):
        w = torch.exp(m[s] - mx)
        tot = tot + l[s] * w
        acc = acc + o[s] * w[..., None]
    got = acc / tot.clamp_min(1e-30)[..., None]
    want = D.combine_splits(o, m, l)
    assert torch.allclose(got, want, rtol=4e-7 * n_splits, atol=1e-7)
    if n_splits == 1:
        assert torch.equal(got, want)
    assert torch.isfinite(got).all()


# The fused merge's buffers, sized in pure Python by the wrapper: one fp32
# workspace laid out o | m | l, and one split counter a (KV head, group of
# 32 packed rows, slot).
@pytest.mark.parametrize("ns,b,sq,h,dh", [(1, 1, 1, 2, 32), (5, 8, 1, 32, 128),
                                          (3, 2, 4, 16, 256)])
def test_workspace_layout_is_o_then_m_then_l(ns, b, sq, h, dh):
    n, mo, lo = D.workspace_layout(ns, b, sq, h, dh)
    n_o, n_m = ns * b * sq * h * dh, ns * b * sq * h
    assert (n, mo, lo) == (n_o + 2 * n_m, n_o, n_o + n_m)
    ws = torch.arange(n, dtype=torch.float32)
    o, m, l = D.partials_views(ws, ns, b, sq, h, dh)
    assert o.shape == (ns, b, sq, h, dh) and m.shape == l.shape == (ns, b, sq, h)
    assert o.is_contiguous() and m.is_contiguous() and l.is_contiguous()
    # the three views tile the workspace in order, with no gap or overlap
    assert o.flatten()[0] == 0 and m.flatten()[0] == mo and l.flatten()[0] == lo
    assert l.flatten()[-1] == n - 1
    assert mo * 4 % 16 == 0          # m starts 16-byte aligned (Dh >= 32)


@pytest.mark.parametrize("b,sq,h,hkv,want", [
    (8, 1, 32, 4, 4 * 1 * 8),          # yi-9b served: G*Sq = 8, one group
    (1, 4, 32, 4, 4 * 1 * 1),          # G*Sq = 32, still one group
    (2, 1, 66, 2, 2 * 2 * 2),          # G*Sq = 33: two groups
    (3, 4, 32, 2, 2 * 2 * 3),          # G*Sq = 64
    (2, 8, 16, 1, 1 * 4 * 2),          # G*Sq = 128
])
def test_counters_needed_one_per_row_group(b, sq, h, hkv, want):
    """One split counter per (KV head, group of 32 packed rows, slot); a
    launch runs that many blocks times its splits."""
    assert D.counters_needed(b, sq, h, hkv) == want
    assert D.launch_ctas(b, sq, h, hkv, 3) == 3 * want


@pytest.mark.parametrize("finished,ns", [(False, 1), (False, 4), (True, 1),
                                         (True, 4)])
def test_launch_buffers_point_into_one_workspace(finished, ns):
    """What a launch is handed: the partials as offsets into one fp32
    workspace (none for a finished call of one split), the output in q's
    dtype when finished, and the device's cached counters only for a
    finished call of more than one split."""
    b, sq, h, hkv, dh = 3, 2, 16, 2, 32
    q = torch.zeros(b, sq, h, dh, dtype=torch.bfloat16)
    ws, out, (o, m, l, outp, cnt) = D._launch_buffers(q, hkv, ns, finished)
    assert (ws is not None) == D.needs_workspace(ns, finished)
    if finished and ns == 1:
        assert ws is None and o is m is l is None
    else:
        n, mo, lo = D.workspace_layout(ns, b, sq, h, dh)
        assert ws.dtype == torch.float32 and ws.numel() == n
        assert (o, m, l) == (ws.data_ptr(), ws.data_ptr() + 4 * mo,
                             ws.data_ptr() + 4 * lo)
    if finished:
        assert out.shape == q.shape and out.dtype == q.dtype
        assert outp == out.data_ptr()
    else:
        assert out is None and outp is None
    if finished and ns > 1:
        c = D.split_counters(q.device)
        assert cnt == c.data_ptr()
        assert c.numel() >= D.counters_needed(b, sq, h, hkv)
    else:
        assert cnt is None


@pytest.mark.parametrize("dtype,dh,ns,finished,want", [
    (torch.bfloat16, 128, 1, True, False),   # one split writes its output
    (torch.bfloat16, 128, 5, True, True),    # the merge's scratch
    (torch.bfloat16, 128, 1, False, True),   # the partials alone
    (torch.float32, 128, 1, True, False),
    (torch.bfloat16, 256, 1, True, False),
    (torch.float32, 256, 1, True, False),    # every body writes one split
    (torch.float32, 256, 3, True, True),
])
def test_needs_workspace(dtype, dh, ns, finished, want):
    """A launch gets the fp32 partials workspace unless it is a finished
    call of one split, at every dtype and head dim."""
    assert D.needs_workspace(ns, finished) is want
    q = torch.zeros(2, 1, 8, dh, dtype=dtype)
    ws, _, _ = D._launch_buffers(q, 2, ns, finished)
    assert (ws is not None) is want


def test_split_counters_grow_zeroed_and_are_kept():
    dev = torch.device("cpu")
    D._COUNTERS.pop(dev, None)
    small = D.split_counters(dev, 4)
    assert small.dtype == torch.int32 and small.numel() == 4
    assert D.split_counters(dev, 2) is small      # enough: the same tensor
    big = D.split_counters(dev, 48)
    assert big.numel() == 48 and not big.any()
    assert D.split_counters(dev) is big
    D._COUNTERS.pop(dev, None)


def test_split_counters_keep_what_they_handed_out():
    """A tensor a larger one replaces stays referenced (a CUDA graph
    captured over it reads its address at every replay)."""
    dev = torch.device("cpu")
    D._COUNTERS.pop(dev, None)
    small = D.split_counters(dev, 4)
    big = D.split_counters(dev, 96)
    assert big is not small
    assert any(t is small for t in D._RETIRED)
    assert not any(t is big for t in D._RETIRED)
    D._COUNTERS.pop(dev, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finished_output_is_combined_partials_in_q_dtype(dtype):
    """On the CPU the finished output is the plain partials merged by
    combine_splits and cast to q's dtype, bit for bit; flash_decode and
    flash_decode_paged are it under their split plans."""
    q, k, v = _torch(*_case(2, 77, 8, 2, 32, 3, seed=5), dtype=dtype)
    pos = torch.tensor([5, 70], dtype=torch.int32)
    bound, split_len, n = D.split_plan(2, 2, 77, 16, 3, None)
    kw = dict(window=None, split_len=split_len, n_splits=n, bound=bound)
    want = D.combine_splits(*D.decode_partials(q, k, v, pos, **kw)).to(dtype)
    got = D.decode_finished(q, k, v, pos, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(D.flash_decode(q, k, v, pos, bk=16, n_splits=3), want)
    ps = 7
    nb = -(-77 // ps)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nb * ps - 77)).reshape(
        2 * nb, ps, 2, 32)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nb * ps - 77)).reshape(
        2 * nb, ps, 2, 32)
    bt = torch.arange(2 * nb, dtype=torch.int32).reshape(2, nb)
    pb, psl, pns = D.paged_split_plan(2, 2, ps, nb, 3)
    pkw = dict(window=None, split_len=psl, n_splits=pns, bound=pb)
    pwant = D.combine_splits(*D.decode_paged_partials(
        q, kp, vp, bt, pos, **pkw)).to(dtype)
    pgot = D.decode_paged_finished(q, kp, vp, bt, pos, **pkw)
    assert pgot.dtype == dtype and torch.equal(pgot, pwant)
    assert torch.equal(D.flash_decode_paged(q, kp, vp, bt, pos, n_splits=3),
                       pwant)


def _warp_merge_rounding(q, k, v, pos, *, window, bk=64, kpw=8):
    """In plain torch and fp32, the order in which the kernel sums: each
    slot's live rows in tiles of ``bk`` keys, each tile scored by warps of
    ``kpw`` keys that take their own max ``m_w`` (at least -1e30) and sum
    ``l_w``, merged once a tile with the running state by the factors
    exp(m_w - m_new). One split over the whole cache; fp32 out."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh) * (1.0 / math.sqrt(dh))
    out = torch.zeros(b, sq, hkv, g, dh)
    for s in range(b):
        p0 = int(pos[s])
        start = 0 if window is None else max(0, p0 - window + 1)
        m = torch.full((sq, hkv, g), NEG_INF)
        l = torch.zeros(sq, hkv, g)
        acc = torch.zeros(sq, hkv, g, dh)
        qp = p0 + torch.arange(sq)
        for t0 in range(start, p0 + sq, bk):
            kp = torch.arange(t0, t0 + bk)
            ok = kp < p0 + sq
            kt = torch.zeros(bk, hkv, dh)
            vt = torch.zeros(bk, hkv, dh)
            kt[ok] = k[s, kp[ok]].float()
            vt[ok] = v[s, kp[ok]].float()
            live = ok[None] & (kp[None] <= qp[:, None])
            if window is not None:
                live &= kp[None] > qp[:, None] - window
            sc = torch.einsum("jhgd,khd->jhgk", qf[s], kt)
            sc = sc.masked_fill(~live[:, None, None], -math.inf)
            sw = sc.reshape(sq, hkv, g, bk // kpw, kpw)
            mw = sw.amax(-1).clamp_min(NEG_INF)
            pw = torch.exp(sw - mw[..., None])
            m_new = torch.maximum(m, mw.amax(-1))
            alpha = torch.exp(m - m_new)
            cw = torch.exp(mw - m_new[..., None])
            vw = vt.reshape(bk // kpw, kpw, hkv, dh)
            part = torch.einsum("jhgwk,wkhd->jhgwd", pw, vw)
            acc = acc * alpha[..., None] + (cw[..., None] * part).sum(-2)
            l = l * alpha + (cw * pw.sum(-1)).sum(-1)
            m = m_new
        out[s] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, dh)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("skv", [509, 512])
def test_warp_merge_within_decode_budget(skv, window):
    """The kernel's summation order (64-key tiles, 8-key warps, one merge
    a tile) at yi-9b head shapes (H=32, Hkv=4, Dh=128), Sq 1 and 4, bf16
    inputs: within the unchanged 1e-4 of JAX's fp32 oracle on the same
    values, and of its Pallas kernel in interpret mode."""
    for sq in (1, 4):
        q, k, v = _case(2, skv, 32, 4, 128, sq, seed=6)
        tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
        pos = [skv // 3, skv - sq]
        got = f32(_warp_merge_rounding(tq, tk, tv, pos, window=window))
        jx = _jax(f32(tq), f32(tk), f32(tv))
        jpos = jnp.asarray(pos, jnp.int32)
        oracle = JD.ref_decode(*jx, jpos, window=window)
        assert np.abs(got - f32(oracle)).max() <= 1e-4
        if sq == 1:
            kern = JD.flash_decode(*jx, jpos, window=window, bk=128,
                                   n_splits=2, interpret=True)
            assert np.abs(got - f32(kern)).max() <= 1e-4
