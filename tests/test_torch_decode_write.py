"""The decode call given the step's new KV rows, against the JAX package.

The port writes the decode step's K and V rows inside the decode call
(one kernel launch on the card). On the CPU the call runs its plain
version: the row write, then the plain decode. Each test holds that one
call against the JAX package's pair of calls on the same numpy inputs:
dense, ``repro.kernels.stores.kv_row_update`` for K and for V and then
the decode; paged, the reference model's scatter (its paged decode
branch, ``repro/models/model.py``) and then the paged decode. The caches
must come out bit for bit equal. The outputs are held against JAX's
dense oracle computed in fp32 on the same (written) values: within 1e-5
in fp32 (summation order only) and, in bf16, within one bf16 ulp at
|x| < 2 (1e-2), since the port computes in fp32 and rounds its output
once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stores as JS
from repro.kernels.attention import decode as JD
from repro.models import attention as JA
from repro_torch import kernels as K
from repro_torch.kernels.attention import ops
from repro_torch.models import attention as A

from _torch_common import f32

torch.set_num_threads(1)

B, S, H, HKV, DH = 3, 24, 4, 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0, atol=1e-2)}


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX array (bf16 or f32)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (sq, pos, window, n_splits): positions inside the cache; a negative one
# (counted from the end) and one past the cache (its start clamps to
# S - Sq); and at Sq = 4 a start that clamps below pos (22 -> 20)
DENSE_CASES = [
    (1, [5, 12, 20], None, 1),
    (1, [-2, 9, 30], 8, 3),
    (4, [0, 10, 17], None, 2),
    (4, [-3, 10, 22], 8, None),
]


@pytest.mark.parametrize("flavor", ["standard", "nt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,pos,window,ns", DENSE_CASES)
def test_dense_decode_with_rows_matches_jax_pair(flavor, dtype, sq, pos,
                                                 window, ns):
    """``ops.flash_decode(..., k_new=, v_new=)`` against JAX's
    ``kv_row_update`` twice and then its decode oracle. JAX's
    interpret-mode ``nt``
    writer clamps each row on its own where a start leaves ``[0, S -
    Sq]``, where the standard path clamps the window; the port clamps the
    window on both flavors, so such cases hold against the standard path.
    A slot at a negative position has queries that see no key, whose
    output each decode defines its own way (the oracle a uniform mean, the
    kernels zeros): its rows are written and checked, its output is not."""
    jd, td = DTYPES[dtype]
    q, k, v, kn, vn = _arrays(0, (B, sq, H, DH), (B, S, HKV, DH),
                              (B, S, HKV, DH), (B, sq, HKV, DH),
                              (B, sq, HKV, DH))
    jpos = jnp.asarray(pos, jnp.int32)
    in_range = all(0 <= p <= S - sq for p in pos)
    jflavor = flavor if in_range else "standard"
    jk = JS.kv_row_update(jnp.asarray(k, jd), jnp.asarray(kn, jd), jpos,
                          flavor=jflavor)
    jv = JS.kv_row_update(jnp.asarray(v, jd), jnp.asarray(vn, jd), jpos,
                          flavor=jflavor)
    want = JD.ref_decode(*(jnp.asarray(x, jd).astype(jnp.float32)
                           for x in (q, jk, jv)), jpos, window=window)
    tk, tv = torch.tensor(k, dtype=td), torch.tensor(v, dtype=td)
    ptrs = (tk.data_ptr(), tv.data_ptr())
    K.reset_launches()
    got = ops.flash_decode(torch.tensor(q, dtype=td), tk, tv,
                           torch.tensor(pos, dtype=torch.int32),
                           window=window, bk=8, n_splits=ns,
                           k_new=torch.tensor(kn, dtype=td),
                           v_new=torch.tensor(vn, dtype=td),
                           store_flavor=flavor)
    assert not any(K.LAUNCHES.values())          # the plain version ran
    assert (tk.data_ptr(), tv.data_ptr()) == ptrs   # written in place
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    assert got.dtype == td
    seen = [i for i, p in enumerate(pos) if p >= 0]
    np.testing.assert_allclose(f32(got)[seen], f32(want)[seen],
                               **TOL[dtype])


def test_dense_decode_with_rows_casts_and_checks():
    """fp32 rows land cast to a bf16 cache, as JAX casts them; rows must
    come as a pair and the flavor must be known."""
    q, k, v, kn, vn = _arrays(1, (B, 1, H, DH), (B, S, HKV, DH),
                              (B, S, HKV, DH), (B, 1, HKV, DH),
                              (B, 1, HKV, DH))
    pos = torch.tensor([3, 7, 11], dtype=torch.int32)
    tk = torch.tensor(k, dtype=torch.bfloat16)
    tv = torch.tensor(v, dtype=torch.bfloat16)
    ops.flash_decode(torch.tensor(q, dtype=torch.bfloat16), tk, tv, pos,
                     k_new=torch.tensor(kn), v_new=torch.tensor(vn))
    want = JS.kv_row_update(jnp.asarray(k, jnp.bfloat16), jnp.asarray(kn),
                            jnp.asarray([3, 7, 11], jnp.int32))
    np.testing.assert_array_equal(_bits(tk), _bits(want))
    with pytest.raises(ValueError, match="come together"):
        ops.flash_decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         pos, k_new=torch.tensor(kn))
    with pytest.raises(ValueError, match="unknown store flavor"):
        ops.flash_decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         pos, k_new=torch.tensor(kn), v_new=torch.tensor(vn),
                         store_flavor="fast")


def _jax_scatter(kc, vc, bt, k_new, v_new, pos):
    """The reference model's paged decode write (``repro/models/model.py``,
    ``_attn_mixer``'s paged branch), on JAX arrays."""
    ps, nb, b = kc.shape[1], bt.shape[1], k_new.shape[0]
    p1 = jnp.broadcast_to(jnp.asarray(pos, jnp.int32).reshape(-1), (b,))
    lp = jnp.minimum(p1 // ps, nb - 1)    # overshoot-retiring clamp
    phys = bt[jnp.arange(b), lp]
    row = p1 % ps
    return (kc.at[phys, row].set(k_new[:, 0].astype(kc.dtype)),
            vc.at[phys, row].set(v_new[:, 0].astype(vc.dtype)))


def _shuffled_pools(k, v, ps, seed):
    """Page pools (P, ps, Hkv, Dh) holding the slot caches under a random
    permutation, two spare pages, and the (B, NB) table."""
    b, skv, hkv, dh = k.shape
    nb = skv // ps
    perm = np.random.default_rng(seed).permutation(b * nb).reshape(b, nb)
    kp = np.zeros((b * nb + 2, ps, hkv, dh), np.float32)
    vp = np.zeros_like(kp)
    for i in range(b):
        for j in range(nb):
            kp[perm[i, j]] = k[i, j * ps:(j + 1) * ps]
            vp[perm[i, j]] = v[i, j * ps:(j + 1) * ps]
    return kp, vp, perm.astype(np.int32)


# (page, pos, kv_len): the last slot's position overshoots the table (its
# row retires onto the last column); a kv_len cut that reads below that
# column (the written column counts the table's full width)
PAGED_CASES = [
    (8, [9, 30, 69], None),
    (8, [9, 30, 69], 32),
    (4, [0, 17, 63], None),
    (16, [15, 16, 40], 20),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,pos,kv_len", PAGED_CASES)
def test_paged_decode_with_rows_matches_jax_scatter(dtype, ps, pos, kv_len):
    """``ops.flash_decode_paged(..., k_new=, v_new=)`` on a shuffled table
    against the reference model's scatter and then JAX's paged decode
    (``decode_attention`` with ``block_tables``, the dense oracle over the
    gathered pages, in fp32 on the written values)."""
    jd, td = DTYPES[dtype]
    skv = 64
    q, k, v, kn, vn = _arrays(2, (B, 1, H, DH), (B, skv, HKV, DH),
                              (B, skv, HKV, DH), (B, 1, HKV, DH),
                              (B, 1, HKV, DH))
    kp, vp, bt = _shuffled_pools(k, v, ps, seed=3)
    jpos = jnp.asarray(pos, jnp.int32)
    jk, jv = _jax_scatter(jnp.asarray(kp, jd), jnp.asarray(vp, jd),
                          jnp.asarray(bt), jnp.asarray(kn, jd),
                          jnp.asarray(vn, jd), jpos)
    want = JA.decode_attention(*(jnp.asarray(x, jd).astype(jnp.float32)
                                 for x in (q, jk, jv)), jpos, impl="ref",
                               kv_len=kv_len, block_tables=jnp.asarray(bt))
    tkp, tvp = torch.tensor(kp, dtype=td), torch.tensor(vp, dtype=td)
    K.reset_launches()
    got = ops.flash_decode_paged(torch.tensor(q, dtype=td), tkp, tvp,
                                 torch.tensor(bt),
                                 torch.tensor(pos, dtype=torch.int32),
                                 kv_len=kv_len,
                                 k_new=torch.tensor(kn, dtype=td),
                                 v_new=torch.tensor(vn, dtype=td))
    assert not any(K.LAUNCHES.values())
    np.testing.assert_array_equal(_bits(tkp), _bits(jk))
    np.testing.assert_array_equal(_bits(tvp), _bits(jv))
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("impl,kv_len", [("ref", None), ("auto", None),
                                         ("auto", 40)])
def test_decode_attention_writes_rows_like_the_reference_model(impl, kv_len):
    """``models.attention.decode_attention`` with the step's rows, dense and
    paged, both routes (the paged ``"ref"`` route without a bound gathers
    the pages after the write): the reference model's write, then its
    ``decode_attention``."""
    skv, ps = 64, 8
    q, k, v, kn, vn = _arrays(4, (B, 1, H, DH), (B, skv, HKV, DH),
                              (B, skv, HKV, DH), (B, 1, HKV, DH),
                              (B, 1, HKV, DH))
    pos = [7, 33, 39]
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos, dtype=torch.int32)
    new = dict(k_new=torch.tensor(kn), v_new=torch.tensor(vn))
    # dense
    jk = JS.kv_row_update(jnp.asarray(k), jnp.asarray(kn), jpos)
    jv = JS.kv_row_update(jnp.asarray(v), jnp.asarray(vn), jpos)
    want = JA.decode_attention(jnp.asarray(q), jk, jv, jpos, impl="ref",
                               kv_len=kv_len)
    tk, tv = torch.tensor(k), torch.tensor(v)
    got = A.decode_attention(torch.tensor(q), tk, tv, tpos, impl=impl,
                             kv_len=kv_len, **new)
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])
    # paged
    kp, vp, bt = _shuffled_pools(k, v, ps, seed=5)
    jkp, jvp = _jax_scatter(jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(bt), jnp.asarray(kn), jnp.asarray(vn),
                            jpos)
    want = JA.decode_attention(jnp.asarray(q), jkp, jvp, jpos, impl="ref",
                               kv_len=kv_len, block_tables=jnp.asarray(bt))
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    got = A.decode_attention(torch.tensor(q), tkp, tvp, tpos, impl=impl,
                             kv_len=kv_len, block_tables=torch.tensor(bt),
                             **new)
    np.testing.assert_array_equal(_bits(tkp), _bits(jkp))
    np.testing.assert_array_equal(_bits(tvp), _bits(jvp))
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])
