"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe.moe_ffn``.

The same numpy weights and tokens, made from a seed, go through both.
In fp32 the outputs agree within 1e-5 (summation order only) and so do
the aux losses, at capacities that drop tokens: a token routed or
dropped differently would move its output by O(1). The routing itself
(top-k experts, renormalized weights, queue places and the keep mask)
is held against the reference's own formulas run in JAX on the same
inputs. In bf16 the inputs are the same bits and the outputs agree
within 5e-2 of their largest magnitude (both frameworks round the
expert products at different points); only the outputs are held there,
since a one-ulp difference upstream may flip a near tie of the router.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro_torch.models import bridge
from repro_torch.models import moe as MoE

from _torch_common import f32

torch.set_num_threads(1)

D, F_ = 32, 24


def _inputs(e, act, b, s, dtype, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, e)) * D ** -0.5,
         "w_up": rng.standard_normal((e, D, F_)) * D ** -0.5,
         "w_down": rng.standard_normal((e, F_, D)) * F_ ** -0.5}
    if act == "swiglu":
        p["w_gate"] = rng.standard_normal((e, D, F_)) * D ** -0.5
    x = rng.standard_normal((b, s, D))
    pj = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    xj = jnp.asarray(x, dtype)
    pt = {k: bridge.to_tensor(np.asarray(v), "cpu") for k, v in pj.items()}
    return pj, xj, pt, bridge.to_tensor(np.asarray(xj), "cpu")


def _jax_route(xg, router, e, k, cap):
    """The routing of ``repro.models.moe.moe_ffn`` (its lines, in JAX)."""
    probs = jax.nn.softmax(xg.astype(jnp.float32)
                           @ router.astype(jnp.float32), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    slot_oh = jax.nn.one_hot(top_e.reshape(xg.shape[0], -1), e,
                             dtype=jnp.int32)
    pos = (jnp.cumsum(slot_oh, axis=1) * slot_oh - 1).max(axis=-1)
    keep = pos < cap
    return top_p, top_e, keep, jnp.where(keep, pos, 0)


#: (experts, top_k, capacity factor, group size, act, batch, seq): groups
#: of 12 tokens over 4 experts at capacity 6 (top-2) and 2 (top-1, factor
#: 0.5), 2 groups of 20 at 8 experts top-3 (capacity 6), GELU experts
CASES = [(4, 2, 1.0, 12, "swiglu", 2, 12), (4, 1, 0.5, 12, "swiglu", 2, 12),
         (8, 3, 0.75, 20, "gelu", 1, 40)]


@pytest.mark.parametrize("e,k,factor,group,act,b,s", CASES)
def test_moe_matches_jax_fp32(e, k, factor, group, act, b, s):
    pj, xj, pt, xt = _inputs(e, act, b, s, jnp.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=factor,
              group_size=group, act=act)
    want, aux_j = JMoE.moe_ffn(pj, xj, **kw)
    got, aux_t = MoE.moe_ffn(pt, xt, **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)

    g = max(1, b * s // group)
    sg = b * s // g
    cap = max(k, int(round(k * sg * factor / e)))
    rj = _jax_route(xj.reshape(g, sg, D), pj["router"], e, k, cap)
    _, top_p, top_e, keep, pos = MoE.route(
        xt.reshape(g, sg, D), pt["router"], n_experts=e, top_k=k, cap=cap)
    assert not bool(keep.all()), "the case drops no token"
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(rj[1]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rj[2]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rj[3]))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(rj[0]), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_matches_jax_bf16(act):
    """The same bf16 bits in; outputs within 5e-2 of their largest."""
    pj, xj, pt, xt = _inputs(4, act, 2, 24, jnp.bfloat16, seed=3)
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.0, group_size=16,
              act=act)
    want, aux_j = JMoE.moe_ffn(pj, xj, **kw)
    got, aux_t = MoE.moe_ffn(pt, xt, **kw)
    assert got.dtype == torch.bfloat16
    w = f32(want)
    assert np.abs(f32(got) - w).max() <= 5e-2 * np.abs(w).max()
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_group_cannot_split_tokens():
    """2501 tokens in groups of 1024 make G = 2, which 2501 is no multiple
    of: JAX's reshape fails, and the port raises a ValueError."""
    pj, xj, pt, xt = _inputs(4, "swiglu", 1, 2501, jnp.float32)
    kw = dict(n_experts=4, top_k=2, group_size=1024)
    with pytest.raises(TypeError):
        JMoE.moe_ffn(pj, xj, **kw)
    with pytest.raises(ValueError, match="2501 tokens do not split into 2"):
        MoE.moe_ffn(pt, xt, **kw)
    # 2048 tokens split into 2 groups of 1024
    out, _ = MoE.moe_ffn(pt, xt[:, :2048], **kw)
    assert out.shape == (1, 2048, D)
