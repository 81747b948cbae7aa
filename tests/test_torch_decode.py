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
    # yi-9b serving: 8 slots x 4 KV heads = 32 blocks a split
    assert D.default_splits(8, 4, 100) == 5
    assert 8 * 4 * D.default_splits(8, 4, 100) >= D.H100_SMS
    assert D.default_splits(8, 4, 3) == 3          # no more than blocks
    bound, split_len, n = D.split_plan(8, 4, 2048, 128, None, 600)
    assert (bound, n) == (600, 5) and split_len * n >= bound


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
