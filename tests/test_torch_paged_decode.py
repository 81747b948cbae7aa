"""Paged split-KV decode of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs the paged CUDA kernel's plain version
(``ref_decode_paged_partials``, the kernel's own split boundaries) and
the split combine. Both it and the dense paged oracle ``ref_decode_paged``
are held against JAX's Pallas ``flash_decode_paged`` in interpret mode
and its ``ref_decode_paged``, over the reference's matrix: page sizes 4,
8 and 16, out-of-order tables, dead table columns holding garbage page
ids, window none and set, Sq 1 and 4, and a ``kv_len`` page bound. fp32
agrees within 1e-5 (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import decode as JD
from repro.kernels.attention import ops as JOPS
from repro.models import attention as JA
from repro_torch import kernels as K
from repro_torch.kernels.attention import decode as D
from repro_torch.kernels.attention import ops
from repro_torch.models import attention as A

from _torch_common import f32

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [
    # (b, skv, h, hkv, dh, sq, window, ps, n_splits, pos)
    (2, 64, 4, 2, 32, 1, None, 16, 1, [40, 30]),           # GQA g=2
    (2, 64, 8, 2, 32, 1, None, 8, 2, [63, 12]),            # g=4, splits
    (3, 80, 4, 1, 32, 1, None, 4, 3, [3, 40, 79]),         # MQA, page 4
    (2, 96, 4, 4, 64, 1, 24, 16, 3, [10, 90]),             # window
    (2, 50, 4, 2, 32, 1, 16, 16, 1, [49, 20]),             # partial page
    (2, 64, 4, 2, 32, 4, None, 8, 2, [17, 60]),            # Sq=4
    (2, 72, 8, 2, 32, 4, 20, 4, 4, [30, 68]),              # Sq=4, window
    (1, 40, 2, 1, 256, 1, None, 16, 2, [37]),              # Dh=256
    (1, 40, 2, 1, 256, 2, 16, 8, 3, [25]),                 # Dh=256, window
    (2, 48, 16, 1, 32, 4, None, 8, 3, [40, 11]),           # G*Sq = 64
]


def _case(b, skv, h, hkv, dh, sq, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]


def _paginate(k, v, ps, pos, sq, seed=1):
    """Page pools (P, ps, Hkv, Dh) holding k, v under a random
    permutation, and the (B, NB) table; columns past each slot's last
    live row hold garbage page ids (the dead columns the kernel must
    never read)."""
    b, skv, hkv, dh = k.shape
    nb = -(-skv // ps)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(b * nb).reshape(b, nb)
    kp = np.zeros((b * nb + 3, ps, hkv, dh), np.float32)
    vp = np.zeros_like(kp)
    for i in range(b):
        for j in range(nb):
            rows = min(ps, skv - j * ps)
            kp[perm[i, j], :rows] = k[i, j * ps:j * ps + rows]
            vp[perm[i, j], :rows] = v[i, j * ps:j * ps + rows]
    kp[b * nb:] = np.nan                  # pages no slot maps
    vp[b * nb:] = np.nan
    bt = perm.copy()
    for i in range(b):
        live = (pos[i] + sq - 1) // ps + 1
        bt[i, live:] = rng.integers(0, kp.shape[0], nb - live)
    return kp, vp, bt.astype(np.int32)


def _dense_window(q, k, v, pos, window):
    """JAX's dense oracle over the unpaged cache."""
    return JD.ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos, jnp.int32), window=window)


@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ps,ns,pos", CASES)
def test_paged_partials_match_jax_kernel(b, skv, h, hkv, dh, sq, window, ps,
                                         ns, pos):
    q, k, v = _case(b, skv, h, hkv, dh, sq)
    kp, vp, bt = _paginate(k, v, ps, pos, sq)
    want = JD.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(pos, jnp.int32), window=window,
                                 n_splits=ns, interpret=True)
    tq, tkp, tvp = (torch.tensor(x) for x in (q, kp, vp))
    tbt, tpos = torch.tensor(bt), torch.tensor(pos, dtype=torch.int32)
    bound, split_len, n = D.paged_split_plan(b, hkv, ps, bt.shape[1], ns)
    o, m, l = D.ref_decode_paged_partials(tq, tkp, tvp, tbt, tpos,
                                          window=window, split_len=split_len,
                                          n_splits=n, bound=bound)
    got = D.combine_splits(o, m, l)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    # the public wrapper on a CPU tensor runs the same plain version
    K.reset_launches()
    routed = D.flash_decode_paged(tq, tkp, tvp, tbt, tpos, window=window,
                                  n_splits=ns)
    assert K.LAUNCHES["flash_decode_paged"] == 0
    np.testing.assert_allclose(f32(routed), f32(want), **TOL)
    # and both agree with the dense oracle on the unpaged cache
    np.testing.assert_allclose(f32(got), f32(_dense_window(q, k, v, pos,
                                                           window)), **TOL)


@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ps,ns,pos", CASES)
def test_ref_decode_paged_matches_jax(b, skv, h, hkv, dh, sq, window, ps, ns,
                                      pos):
    q, k, v = _case(b, skv, h, hkv, dh, sq, seed=2)
    kp, vp, bt = _paginate(k, v, ps, pos, sq, seed=3)
    kp = np.nan_to_num(kp)                # the dense oracle reads every row
    vp = np.nan_to_num(vp)
    want = JD.ref_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(bt),
                               jnp.asarray(pos, jnp.int32), window=window)
    got = D.ref_decode_paged(*(torch.tensor(x) for x in (q, kp, vp, bt)),
                             torch.tensor(pos, dtype=torch.int32),
                             window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_split_boundaries_follow_the_table():
    """bps = ceil(NB / n_splits) pages a split, n_splits <= NB; a split
    past every slot's position is dead (m = -1e30, l = 0, o = 0)."""
    assert D.paged_split_plan(8, 4, 16, 30, None) == (480, 128, 4)
    assert D.paged_split_plan(2, 2, 8, 3, 5) == (24, 8, 3)
    assert D.paged_split_plan(2, 2, 8, 7, 2) == (56, 32, 2)
    q, k, v = _case(2, 64, 4, 2, 32, 1, seed=4)
    pos = [5, 9]
    kp, vp, bt = _paginate(k, v, 8, pos, 1, seed=5)
    tq, tkp, tvp, tbt = (torch.tensor(x) for x in (q, kp, vp, bt))
    o, m, l = D.ref_decode_paged_partials(
        tq, tkp, tvp, tbt, torch.tensor(pos, dtype=torch.int32),
        window=None, split_len=16, n_splits=4, bound=64)
    assert torch.all(m[1:] == D.NEG_INF) and torch.all(l[1:] == 0)
    assert torch.all(o[1:] == 0) and torch.isfinite(o).all()


@pytest.mark.parametrize("kv_len", [None, 22, 40])
def test_ops_page_bound_matches_jax(kv_len):
    """ops.flash_decode_paged reads only the first ceil(kv_len / page)
    table columns: NaN pages named past them change nothing."""
    q, k, v = _case(2, 64, 4, 2, 32, 1, seed=3)
    pos = [9, 21]
    kp, vp, bt = _paginate(k, v, 8, pos, 1, seed=6)
    bt = np.where(bt >= 16, 0, bt).astype(np.int32)
    want = JOPS.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(bt),
                                   jnp.asarray(pos, jnp.int32),
                                   impl="pallas", n_splits=2, kv_len=kv_len)
    tbt = torch.tensor(bt)
    if kv_len is not None:
        tbt[:, -(-kv_len // 8):] = 16     # a NaN page, past the bound
    for impl in ("ref", "auto"):
        got = ops.flash_decode_paged(*(torch.tensor(x) for x in (q, kp, vp)),
                                     tbt, torch.tensor(pos, dtype=torch.int32),
                                     impl=impl, n_splits=2, kv_len=kv_len)
        np.testing.assert_allclose(f32(got), f32(want), err_msg=impl, **TOL)


@pytest.mark.parametrize("impl,kv_len", [("ref", None), ("auto", None),
                                         ("auto", 30)])
def test_decode_attention_paged_route_matches_jax(impl, kv_len):
    """models.attention.decode_attention with block_tables: the ref route
    gathers pages and runs the dense computation, a routed impl or a
    kv_len runs ops.flash_decode_paged; both as the JAX model does."""
    q, k, v = _case(2, 64, 4, 2, 32, 1, seed=7)
    pos = [20, 29]
    kp, vp, bt = _paginate(k, v, 8, pos, 1, seed=8)
    kp, vp = np.nan_to_num(kp), np.nan_to_num(vp)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(pos, jnp.int32),
                               impl="ref", block_tables=jnp.asarray(bt))
    got = A.decode_attention(*(torch.tensor(x) for x in (q, kp, vp)),
                             torch.tensor(pos, dtype=torch.int32), impl=impl,
                             kv_len=kv_len, block_tables=torch.tensor(bt))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_paged_impl_routing_on_cpu():
    q, k, v = (torch.tensor(x) for x in _case(1, 16, 2, 1, 32, 1))
    kp, vp = k.reshape(2, 8, 1, 32), v.reshape(2, 8, 1, 32)
    bt = torch.tensor([[0, 1]], dtype=torch.int32)
    pos = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_decode_paged(q, kp, vp, bt, pos, impl="pallas")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.flash_decode_paged(q, kp, vp, bt, pos, impl="cuda")
    with pytest.raises(ValueError, match="whole number of pages"):
        D.decode_paged_partials(q, kp, vp, bt, pos, split_len=8,
                                n_splits=1, bound=12)
