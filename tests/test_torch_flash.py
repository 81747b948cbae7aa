"""Flash attention of the PyTorch port against the JAX package.

On the CPU ``ops.flash_attention`` runs the CUDA kernel's plain version,
``ref.attention`` (exact masked softmax in (B, H, S, Dh) layout). It is
held against JAX's Pallas ``flash_attention`` in interpret mode and its
oracle ``ref.attention`` over the reference's matrix (causal, windowed,
GQA, fp32 and bf16; ``tests/test_kernels_attention.py``). fp32 agrees
within 2e-5, as the reference's own test holds its kernel. In bf16 both
sides compute in fp32 from the same bf16 inputs and round the output
once, so they agree within one bf16 ulp at |x| < 4 (2^-6).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import flash as JF
from repro.kernels.attention import ops as JOPS
from repro.kernels.attention import ref as JR
from repro_torch import kernels as K
from repro_torch.kernels.attention import flash as F
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention import ref as R

from _torch_common import f32

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0, atol=2 ** -6)

CASES = [
    # (h, hkv, s, dh, window, bq, bk): the reference's kernel matrix
    (4, 2, 256, 64, None, 64, 64),
    (8, 8, 128, 32, None, 32, 64),
    (4, 1, 256, 64, 96, 64, 32),
    (2, 2, 192, 128, None, 64, 64),
    (8, 4, 128, 64, 64, 32, 32),
    (2, 1, 64, 256, None, 32, 32),    # Dh=256 (gemma3-4b's head_dim)
    (4, 2, 64, 256, 24, 32, 32),      # Dh=256, GQA, window
]


def _qkv(h, hkv, s, dh, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32) for sh in
            ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh))]


@pytest.mark.parametrize("h,hkv,s,dh,window,bq,bk", CASES)
def test_attention_matches_jax_kernel(h, hkv, s, dh, window, bq, bk):
    q, k, v = _qkv(h, hkv, s, dh)
    want = JF.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), bq=bq,
                              bk=bk, window=window, interpret=True)
    K.reset_launches()
    got = ops.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                              window=window, bq=bq, bk=bk)
    assert K.LAUNCHES["flash_attention"] == 0   # the plain version ran
    np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("s", [77, 128])
def test_attention_matches_jax_oracle(causal, window, s):
    """Ragged S, causal or not, with and without a window, GQA g=4."""
    q, k, v = _qkv(8, 2, s, 32, seed=1)
    want = JR.attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                        window=window)
    got = R.attention(*(torch.tensor(x) for x in (q, k, v)), causal=causal,
                      window=window)
    np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)


@pytest.mark.parametrize("window", [None, 48])
def test_attention_bf16_matches_jax(window):
    q, k, v = _qkv(4, 2, 128, 64, seed=2, b=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = JF.flash_attention(jq, jk, jv, bq=64, bk=64, window=window,
                              interpret=True)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
    oracle = JR.attention(jq, jk, jv, window=window)
    np.testing.assert_allclose(f32(got), f32(oracle), **BF16_TOL)


@pytest.mark.parametrize("window", [None, 24])
def test_attention_bf16_dh256_matches_jax(window):
    """gemma3-4b's head_dim 256 in bf16, against JAX's Pallas kernel in
    interpret mode and its oracle."""
    q, k, v = _qkv(2, 1, 64, 256, seed=4, b=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = JF.flash_attention(jq, jk, jv, bq=32, bk=32, window=window,
                              interpret=True)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
    oracle = JR.attention(jq, jk, jv, window=window)
    np.testing.assert_allclose(f32(got), f32(oracle), **BF16_TOL)


def test_default_key_tile_fits_shared_memory():
    """fp32 takes 64-key tiles, but 32 at Dh=256, where the fp32 body's
    64-key tile would not fit the H100's shared memory; bf16 takes 128,
    but 64 at Dh=256, where four 128-key stages would not."""
    assert F.default_bk(torch.bfloat16, 256) == 64
    assert F.default_bk(torch.float32, 128) == 64
    assert F.default_bk(torch.float32, 256) == 32
    assert F.default_bk(torch.bfloat16, 128) == 128
    assert 256 in F.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_kernel_tiles_fit_shared_memory(dtype, dh):
    """Every key tile a body takes at a head dim fits one block's 232,448
    bytes of shared memory and the default is the largest. Where the
    shared memory limits it (bf16 everywhere, fp32 at Dh=256) the next
    tile up would not fit; fp32 stops at 64 keys anyway, its scalar body
    being capped by the fp32 rate, not by its tile."""
    taken = [bk for bk in F.KERNEL_KEY_TILES
             if bk <= F.default_bk(dtype, dh)]
    assert taken and max(taken) == F.default_bk(dtype, dh)
    for bk in taken:
        assert F.shared_memory_bytes(dtype, dh, bk) <= F.SHARED_MEMORY_LIMIT
    nxt = 2 * F.default_bk(dtype, dh)
    if dtype == torch.bfloat16 or dh == 256:
        assert nxt not in F.KERNEL_KEY_TILES or \
            F.shared_memory_bytes(dtype, dh, nxt) > F.SHARED_MEMORY_LIMIT


def test_shared_memory_bytes_of_the_served_tiles():
    """The byte counts of ``csrc/flash.cu``: bf16 at yi-9b's heads (Dh 128,
    128-key tiles) and gemma3-4b's (Dh 256, 64-key tiles); fp32 at Dh 256
    with 32-key tiles (214 KB) and the 64-key tile it cannot take."""
    assert F.shared_memory_bytes(torch.bfloat16, 128, 128) == 164992
    assert F.shared_memory_bytes(torch.bfloat16, 256, 64) == 197760
    assert F.shared_memory_bytes(torch.float32, 256, 32) == 219136
    assert F.shared_memory_bytes(torch.float32, 256, 64) > \
        F.SHARED_MEMORY_LIMIT


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None), (False, 70)])
@pytest.mark.parametrize("s,bq,bk", [(509, 42, 128), (2048, 64, 64),
                                     (100, 16, 32)])
def test_key_tiles_count_the_live_keys(s, bq, bk, causal, window):
    """``key_tiles`` counts, for each query tile, the key tiles from its
    first live key (the window's) to its last (the causal edge, or S)."""
    i = np.arange(s)
    live = np.ones((s, s), bool)
    if causal:
        live &= i[None, :] <= i[:, None]
    if window is not None:
        live &= i[None, :] > i[:, None] - window
    want = []
    for q0 in range(0, s, bq):
        keys = np.nonzero(live[q0:q0 + bq].any(0))[0]
        want.append(-(-(keys.max() + 1 - keys.min()) // bk))
    assert F.key_tiles(s, bq, bk, causal, window) == want


@pytest.mark.parametrize("s,bq,bk,causal,per,split", [
    (2048, 64, 64, True, 4, True),      # gemma3-4b's heads: 128 blocks
    (2048, 16, 128, True, 4, False),    # yi-9b's: 512 blocks
    (2048, 64, 64, False, 4, False),    # one wave of equal tiles
    (2048, 128, 128, False, 1, True),   # 16 blocks on 132 SMs
    (2048, 128, 128, True, 1, True),    # a lone causal head
])
def test_block_plan_splits_and_orders_the_longest_tiles(s, bq, bk, causal,
                                                         per, split):
    """``block_plan`` splits tiles of at least 4 key tiles only where the
    modelled schedule of 132 SMs finishes sooner (gemma3-4b's causal heads,
    a lone head; not yi-9b's 512 blocks, not one wave of equal blocks), and
    lists every query tile once whole or twice as halves, longest first."""
    tiles = F.key_tiles(s, bq, bk, causal, None)
    qs, order = F.block_plan(s, bq, bk, causal, None, per, 132)
    assert (qs < len(tiles)) == split
    assert min(tiles[qs:], default=4) >= 4
    want = sorted([qt * 3 for qt in range(qs)] +
                  [qt * 3 + h for qt in range(qs, len(tiles)) for h in (1, 2)])
    assert sorted(order) == want
    cost = [tiles[c // 3] if c % 3 == 0 else
            (tiles[c // 3] // 2 if c % 3 == 1 else
             tiles[c // 3] - tiles[c // 3] // 2) + F.MERGE_OVERHEAD_TILES
            for c in order]
    assert cost == sorted(cost, reverse=True)


@pytest.mark.parametrize("h,hkv", [(32, 4), (8, 4), (6, 2), (8, 1), (4, 4)])
def test_default_query_tile_packs_at_most_128_rows(h, hkv):
    """``default_bq`` packs as many query positions as fill the 128 rows of
    the two consumer warpgroups, and at least one."""
    g = h // hkv
    bq = F.default_bq(h, hkv)
    assert 1 <= bq and bq * g <= F.KERNEL_MAX_ROWS
    assert (bq + 1) * g > F.KERNEL_MAX_ROWS


def test_bshd_adapter_matches_jax():
    q, k, v = _qkv(4, 2, 96, 32, seed=3)
    t = [np.swapaxes(x, 1, 2).copy() for x in (q, k, v)]
    want = JOPS.flash_attention_bshd(*(jnp.asarray(x) for x in t),
                                     impl="ref", window=24)
    got = ops.flash_attention_bshd(*(torch.tensor(x) for x in t), window=24)
    assert tuple(got.shape) == t[0].shape
    np.testing.assert_allclose(f32(got), f32(want), **F32_TOL)


def test_flash_impl_routing_on_cpu():
    q, k, v = (torch.tensor(x) for x in _qkv(2, 1, 16, 32))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.flash_attention(q, k, v, impl="cuda")
    np.testing.assert_array_equal(
        f32(ops.flash_attention(q, k, v, impl="ref")),
        f32(ops.flash_attention(q, k, v, impl="auto")))


def _tensor_core_rounding(q, k, v, *, window, pair=True):
    """In plain torch, what a bf16 tensor-core body rounds: bf16 q.k
    products summed in fp32, 1/sqrt(Dh) on the fp32 scores, an fp32
    softmax whose unnormalised weights P go to the value product either
    as the bf16 pair hi = bf16(P), lo = bf16(P - hi) (``pair``, the
    ``mma.sync`` body before the ``wgmma`` one) or once as bf16(P) (the
    ``wgmma`` body), divided by the fp32 sum of P, fp32 accumulators, one
    bf16 rounding of the output. Causal, (B, H, S, Dh) bf16 in."""
    b, h, s, dh = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    sc = (q.float() @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    i = torch.arange(s)
    live = i[None, :] <= i[:, None]
    if window is not None:
        live &= i[None, :] > i[:, None] - window
    sc = sc.masked_fill(~live, -math.inf)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float() if pair else torch.zeros_like(hi)
    o = (hi @ vf + lo @ vf) / p.sum(-1, keepdim=True)
    return o.bfloat16()


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("s", [509, 512])
def test_tensor_core_rounding_within_bf16_budget(s, window):
    """The bf16 kernel's roundings at yi-9b head shapes (H=32, Hkv=4,
    Dh=128) stay within the unchanged 2^-6 of the fp32 oracle on the same
    bf16 inputs (the port's ``ref.attention`` and JAX's), and of JAX's
    Pallas kernel in interpret mode where S tiles (512)."""
    q, k, v = _qkv(32, 4, s, 128, seed=5, b=1)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = f32(_tensor_core_rounding(tq, tk, tv, window=window))
    want = R.attention(tq.float(), tk.float(), tv.float(), window=window)
    assert np.abs(got - f32(want)).max() <= 2 ** -6
    jq, jk, jv = (jnp.asarray(f32(x)) for x in (tq, tk, tv))
    oracle = JR.attention(jq, jk, jv, window=window)
    assert np.abs(got - f32(oracle)).max() <= 2 ** -6
    if s % 512 == 0:
        kern = JF.flash_attention(jq, jk, jv, bq=512, bk=512, window=window,
                                  interpret=True)
        assert np.abs(got - f32(kern)).max() <= 2 ** -6


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("s", [509, 512])
def test_tensor_core_rounding_within_bf16_budget_dh256(s, window):
    """The same roundings at gemma3-4b's heads (H=8, Hkv=4, Dh=256): a
    score sums 256 bf16 products, still within 2^-6 of the fp32 oracle
    and of JAX's Pallas kernel in interpret mode where S tiles (512)."""
    q, k, v = _qkv(8, 4, s, 256, seed=6, b=1)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = f32(_tensor_core_rounding(tq, tk, tv, window=window))
    want = R.attention(tq.float(), tk.float(), tv.float(), window=window)
    assert np.abs(got - f32(want)).max() <= 2 ** -6
    if s % 512 == 0:
        jq, jk, jv = (jnp.asarray(f32(x)) for x in (tq, tk, tv))
        kern = JF.flash_attention(jq, jk, jv, bq=512, bk=512, window=window,
                                  interpret=True)
        assert np.abs(got - f32(kern)).max() <= 2 ** -6


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("s", [509, 512])
def test_single_product_rounding_within_bf16_budget(s, window):
    """The ``wgmma`` body's roundings (P once in bf16, no lo product) at
    yi-9b head shapes stay within the unchanged 2^-6 of the fp32 oracle
    (the port's and JAX's) and of JAX's Pallas kernel in interpret mode
    where S tiles (512)."""
    q, k, v = _qkv(32, 4, s, 128, seed=5, b=1)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = f32(_tensor_core_rounding(tq, tk, tv, window=window, pair=False))
    want = R.attention(tq.float(), tk.float(), tv.float(), window=window)
    assert np.abs(got - f32(want)).max() <= 2 ** -6
    jq, jk, jv = (jnp.asarray(f32(x)) for x in (tq, tk, tv))
    oracle = JR.attention(jq, jk, jv, window=window)
    assert np.abs(got - f32(oracle)).max() <= 2 ** -6
    if s % 512 == 0:
        kern = JF.flash_attention(jq, jk, jv, bq=512, bk=512, window=window,
                                  interpret=True)
        assert np.abs(got - f32(kern)).max() <= 2 ** -6


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("s", [509, 512])
def test_single_product_rounding_within_bf16_budget_dh256(s, window):
    """The ``wgmma`` body's roundings at gemma3-4b's heads (H=8, Hkv=4,
    Dh=256), within 2^-6 of the fp32 oracle and of JAX's Pallas kernel in
    interpret mode where S tiles (512)."""
    q, k, v = _qkv(8, 4, s, 256, seed=6, b=1)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = f32(_tensor_core_rounding(tq, tk, tv, window=window, pair=False))
    want = R.attention(tq.float(), tk.float(), tv.float(), window=window)
    assert np.abs(got - f32(want)).max() <= 2 ** -6
    jq, jk, jv = (jnp.asarray(f32(x)) for x in (tq, tk, tv))
    oracle = JR.attention(jq, jk, jv, window=window)
    assert np.abs(got - f32(oracle)).max() <= 2 ** -6
    if s % 512 == 0:
        kern = JF.flash_attention(jq, jk, jv, bq=512, bk=512, window=window,
                                  interpret=True)
        assert np.abs(got - f32(kern)).max() <= 2 ** -6
