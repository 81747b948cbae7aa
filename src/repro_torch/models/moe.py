"""Mixture-of-Experts FFN with grouped dense dispatch (counterpart of
``repro/models/moe.py``).

Tokens are cut into groups, routed top-k by an fp32 softmax router and
queued per expert up to a capacity; tokens past it are dropped (Switch
style) and a load-balance aux loss is returned. Dispatch and combine are
products with one-hot ``(G, Sg, E, C)`` tensors in the activation dtype,
the reference's arithmetic, so the same tokens land in the same expert
slots and the same ones are dropped.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _group(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(B, S, d) -> (G, Sg, d) with G = max(1, B*S // group_size).

    As in the JAX package, B*S must be a multiple of G; where it is not
    (2501 tokens in groups of 1024) the reshape cannot be made and this
    raises ``ValueError``. Regrouping would change which tokens drop.
    """
    b, s, d = x.shape
    t = b * s
    g = max(1, t // group_size)
    if t % g:
        raise ValueError(f"moe: {t} tokens do not split into {g} groups "
                         f"(group_size {group_size}); the JAX reference "
                         f"cannot reshape them either")
    return x.reshape(g, t // g, d)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``idx`` (...) as (..., n) one-hot rows in ``dtype``; made by a
    comparison, so no host sync on a CUDA tensor."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(xg: torch.Tensor, router: torch.Tensor, *, n_experts: int,
          top_k: int, cap: int, renormalize: bool = True,
          reduce=None) -> tuple:
    """Route grouped tokens xg (G, Sg, d): fp32 router and softmax, top-k,
    renormalized weights, and each (token, k) slot's place in its
    expert's queue, counted over the group's Sg*K slots in order.
    ``reduce``, when given, sums the router logits over the ranks holding
    slices of d before the softmax.

    Returns ``(probs (G, Sg, E), top_p (G, Sg, K), top_e (G, Sg, K),
    keep (G, Sg*K), pos (G, Sg*K))``: ``keep`` is False for a slot past
    the capacity ``cap`` (dropped), ``pos`` its queue place (0 if
    dropped).
    """
    g, sg, _ = xg.shape
    logits = xg.float() @ router.float()
    if reduce is not None:
        logits = reduce(logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    if renormalize:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    slot_oh = _one_hot(top_e.reshape(g, sg * top_k), n_experts, torch.int32)
    pos = (torch.cumsum(slot_oh, dim=1) * slot_oh - 1).amax(-1)
    keep = pos < cap
    return probs, top_p, top_e, keep, torch.where(keep, pos, 0)


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 1024,
            act: str = "swiglu", renormalize: bool = True, on_shards=None):
    """Top-k routed MoE MLP.

    p: ``router (d, E)``, ``w_up (E, d, f)``, ``w_down (E, f, d)``
    [, ``w_gate (E, d, f)`` for SwiGLU]. x: (B, S, d).
    Returns ``(out (B, S, d), aux_loss 0-d fp32)``.

    The routing (:func:`route_core`) and the experts (:func:`expert_core`)
    are two calls; ``on_shards(routing, experts, x, p)``, when given, runs
    them on each rank's shards under a mesh (``models.model``) and
    returns what they return. The aux loss is taken from the routing's
    sums over every token of every group.
    """
    b, s, d = x.shape
    t = b * s
    g = max(1, t // group_size)
    sg = t // g
    cap = max(top_k, int(round(top_k * sg * capacity_factor / n_experts)))
    routing = functools.partial(route_core, group_size=group_size,
                                n_experts=n_experts, top_k=top_k, cap=cap,
                                renormalize=renormalize)
    experts = functools.partial(expert_core, group_size=group_size,
                                n_experts=n_experts, top_k=top_k, cap=cap,
                                act=act)
    if on_shards is None:
        top_p, top_e, keep, pos, tok_sum, prob_sum = routing(x, p["router"])
        out = experts(x, top_p, top_e, keep, pos, p["w_up"], p.get("w_gate"),
                      p["w_down"])
    else:
        out, tok_sum, prob_sum = on_shards(routing, experts, x, p)
    # Switch aux loss: E * sum(fraction of tokens * mean probability)
    aux = n_experts * ((tok_sum / t) * (prob_sum / t)).sum()
    return out, aux


def route_core(x: torch.Tensor, router: torch.Tensor, *, group_size: int,
               n_experts: int, top_k: int, cap: int, renormalize: bool,
               reduce=None) -> tuple:
    """Group the tokens of x (B, S, d) and route them (:func:`route`).

    Returns ``(top_p, top_e, keep, pos)`` as :func:`route` does and the
    sums over the groups' tokens of the top-1 one-hot and of the router
    probabilities, (E,) fp32 each (the aux loss's numerators). ``reduce``
    goes to :func:`route`."""
    probs, top_p, top_e, keep, pos = route(
        _group(x, group_size), router, n_experts=n_experts, top_k=top_k,
        cap=cap, renormalize=renormalize, reduce=reduce)
    tok_sum = _one_hot(top_e[..., 0], n_experts, torch.float32).sum((0, 1))
    return top_p, top_e, keep, pos, tok_sum, probs.sum((0, 1))


def expert_core(x, top_p, top_e, keep, pos, w_up, w_gate, w_down, *,
                group_size: int, n_experts: int, top_k: int, cap: int,
                act: str, expert0: int = 0, reduce=None) -> torch.Tensor:
    """The dispatch, the expert MLPs and the combine of routed tokens.

    ``w_*`` may hold a slice of the experts, ``expert0`` .. ``expert0 +
    E_loc - 1`` (each rank's slice of the dispatch and combine one-hots
    is taken), or a slice of their FFN width, or of d (``reduce`` then
    sums the up and gate products over the ranks holding d's slices);
    the output is then the slice's partial sum, or its slice of d.
    Returns out (B, S, d_out)."""
    b, s, _ = x.shape
    xg = _group(x, group_size)                       # (G, Sg, d)
    g, sg, _ = xg.shape
    e = w_up.shape[0]
    dtype = xg.dtype
    slot_e = top_e.reshape(g, sg * top_k) - expert0  # (G, SgK)
    oh_e = _one_hot(slot_e, e, dtype)                # (G, SgK, E_loc)
    oh_c = _one_hot(pos, cap, dtype) * keep[..., None].to(dtype)
    disp_k = (oh_e[..., :, None] * oh_c[..., None, :]).reshape(
        g, sg, top_k, e, cap)
    dispatch = disp_k.sum(2)                         # (G, Sg, E, C)
    combine = (disp_k * top_p.to(dtype)[..., None, None]).sum(2)

    # experts
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)        # (G, E, C, d)
    up = torch.einsum("gecd,edf->gecf", xe, w_up)
    if reduce is not None:
        up = reduce(up)
    if act == "swiglu":
        gate = torch.einsum("gecd,edf->gecf", xe, w_gate)
        if reduce is not None:
            gate = reduce(gate)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, w_down)           # (G, E, C, d)

    out = torch.einsum("gsec,gecd->gsd", combine, ye)         # (G, Sg, d)
    return out.reshape(b, s, out.shape[-1])
