"""Mamba-1 selective state-space mixer (counterpart of
``repro/models/ssm.py``), as in Jamba.

Prefill runs the reference's chunkwise two-pass scan: pass 1 scans every
chunk from a zero state at once, keeping each chunk's local final state
and decay product; a short scan over chunks stitches the true state
entering each chunk; pass 2 scans again from those states and emits
``y_t = C_t . h_t``. Decode takes the exact sequential step. The state
``h`` is fp32; the conv state comes back in the compute dtype. The time
loops are Python loops over steps (the JAX package's ``lax.scan``s are
not Pallas kernels), written as ``utils.loops.repeat`` loops so that a
trace lowering records one step of each.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.utils.loops import repeat


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, T, C), w: (K, C).

    ``cache`` (B, K-1, C), given at decode, is prepended (in x's dtype);
    the updated cache (the last K-1 raw inputs) is always returned.
    """
    k = w.shape[0]
    if cache is not None:
        xx = torch.cat([cache.to(x.dtype), x], dim=1)
    else:
        xx = F.pad(x, (0, 0, k - 1, 0))
    new_cache = xx[:, xx.shape[1] - (k - 1):, :] if k > 1 else \
        x.new_zeros((x.shape[0], 0, x.shape[2]))
    t = x.shape[1]
    out = xx[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xx[:, i:i + t] * w[i]
    return out, new_cache


def _to_steps(z: torch.Tensor, nc: int, chunk: int) -> torch.Tensor:
    """(B, T, ...) -> (L, B, nc, ...)."""
    b = z.shape[0]
    return z.reshape(b, nc, chunk, *z.shape[2:]).movedim(2, 0)


def _bridge(pr: torch.Tensor, h_loc: torch.Tensor, h0: torch.Tensor):
    """The state entering each chunk, (B, nc, D, N), and the final state,
    from each chunk's decay product and local final state."""
    st = {"h": h0.float()}
    h_init = pr.new_empty(pr.shape)

    def step(c):
        h_init[:, c] = st["h"]
        st["h"] = pr[:, c] * st["h"] + h_loc[:, c]
    repeat(pr.shape[1], step)
    return h_init, st["h"]


def _two_passes(a_u, c_s, shape: tuple, h0, chunk: int):
    """The two scans of the chunkwise method over ``chunk`` steps, every
    chunk at once (``a_u(i)`` the step's decay and input, (B, nc, D, N);
    ``c_s`` the C rows by step): pass 1 from a zero state keeps each
    chunk's local final state and decay product, :func:`_bridge` the
    state entering each chunk, pass 2 emits ``y_t = C_t . h_t``. Each
    pass is a :func:`~repro_torch.utils.loops.repeat` loop (a trace
    lowering records one step), as the reference's ``lax.scan``s.
    Returns y (B, nc, chunk, D) fp32 and h_T."""
    b, nc, d, n = shape
    st = {"h": torch.zeros(shape, dtype=torch.float32, device=c_s.device)}
    st["pr"] = torch.ones_like(st["h"])

    def pass1(i):
        a_t, u_t = a_u(i)
        st["h"] = a_t * st["h"] + u_t
        st["pr"] = st["pr"] * a_t
    repeat(chunk, pass1)
    h_init, h_final = _bridge(st["pr"], st["h"], h0)
    st["h"] = h_init
    ys = torch.empty((b, nc, chunk, d), dtype=torch.float32,
                     device=c_s.device)

    def pass2(i):
        a_t, u_t = a_u(i)
        st["h"] = a_t * st["h"] + u_t
        ys[:, :, i] = torch.einsum("bgdn,bgn->bgd", st["h"], c_s[i])
    repeat(chunk, pass2)
    return ys, h_final


def _ssm_scan_chunked(a_in, u_b, c_mat, h0, chunk: int):
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + u_t, y_t = C_t . h_t.

    a_in: (B, T, D, N) decay in (0, 1]; u_b: (B, T, D, N) input;
    c_mat: (B, T, N); h0: (B, D, N). Returns y (B, T, D), h_T (B, D, N).
    A T that is no multiple of the chunk is padded with identity steps
    (a = 1, u = 0), so the final state stays exact.
    """
    b, t, d, n = a_in.shape
    chunk = min(chunk, t)
    if t % chunk:
        tp = -(-t // chunk) * chunk
        y, h_final = _ssm_scan_chunked(
            F.pad(a_in, (0, 0, 0, 0, 0, tp - t), value=1.0),
            F.pad(u_b, (0, 0, 0, 0, 0, tp - t)),
            F.pad(c_mat, (0, 0, 0, tp - t)), h0, chunk)
        return y[:, :t], h_final
    nc = t // chunk
    a_s, u_s, c_s = (_to_steps(z, nc, chunk) for z in (a_in, u_b, c_mat))
    ys, h_final = _two_passes(lambda i: (a_s[i], u_s[i]), c_s,
                              (b, nc, d, n), h0, chunk)
    return ys.reshape(b, t, d), h_final               # (B, nc, L, D)


def _ssm_scan_chunked_fused(dt, b_mat, c_mat, xif, a, h0, chunk: int):
    """:func:`_ssm_scan_chunked` with the decay a_t = exp(dt_t * A) and
    input u_t = dt_t * x_t * B_t made inside each step from the (B, T, D)
    streams, so no (B, T, D, N) tensor is materialized.

    dt, xif: (B, T, D); b_mat, c_mat: (B, T, N); a: (D, N); h0: (B, D, N).
    Padding steps have dt = 0: a = 1, u = 0, identity steps.
    """
    b, t, d = dt.shape
    n = a.shape[1]
    chunk = min(chunk, t)
    if t % chunk:
        tp = -(-t // chunk) * chunk
        pad = (0, 0, 0, tp - t)
        y, h_final = _ssm_scan_chunked_fused(
            F.pad(dt, pad), F.pad(b_mat, pad), F.pad(c_mat, pad),
            F.pad(xif, pad), a, h0, chunk)
        return y[:, :t], h_final
    nc = t // chunk
    dt_s, b_s, c_s, x_s = (_to_steps(z, nc, chunk)
                           for z in (dt, b_mat, c_mat, xif))

    def a_u(i):
        a_t = torch.exp(dt_s[i][..., None] * a)          # (B, nc, D, N)
        u_t = (dt_s[i] * x_s[i])[..., None] * b_s[i][:, :, None, :]
        return a_t, u_t

    ys, h_final = _two_passes(a_u, c_s, (b, nc, d, n), h0, chunk)
    return ys.reshape(b, t, d), h_final


def mamba_mixer(p: dict, x: torch.Tensor, *, d_state: int, conv_dim: int,
                chunk: int = 128, state: dict | None = None,
                want_state: bool = False, fuse: bool = True,
                on_shards=None):
    """Mamba-1 mixer. x: (B, T, d_model), already normed.

    p: ``in_x``/``in_z`` (d, di), ``conv_w`` (K, di), ``conv_b`` (di,),
    ``x_dbc`` (di, R+2N), ``dt_w`` (R, di), ``dt_b`` (di,) fp32, ``a_log``
    (di, N) fp32, ``d_skip`` (di,), ``out_proj`` (di, d).
    state (decode): ``{"h": (B, di, N) fp32, "conv": (B, K-1, di)}``.
    Returns ``(y (B, T, d), new_state | None)``; the new ``h`` is fp32,
    the new ``conv`` in x's dtype.

    The input and output projections are products on whatever tensors
    they are given (DTensors under a mesh); everything between them,
    the time loops included, is :func:`mamba_core` over the channels,
    run by ``on_shards(core, args)`` when given (each rank's channel
    shard under a mesh, ``models.model``), else called as it is.
    """
    z = x @ p["in_z"]
    xi_raw = x @ p["in_x"]                            # (B, T, di)
    args = (xi_raw, z, p["conv_w"], p["conv_b"], p["x_dbc"], p["dt_w"],
            p["dt_b"], p["a_log"], p["d_skip"],
            state["conv"] if state is not None else None,
            state["h"] if state is not None else None)
    core = functools.partial(mamba_core, d_state=d_state, chunk=chunk,
                             fuse=fuse)
    y, h_t, new_conv = core(*args) if on_shards is None \
        else on_shards(core, args)
    out = y @ p["out_proj"]
    return out, ({"h": h_t, "conv": new_conv} if want_state else None)


def mamba_core(xi_raw, z, conv_w, conv_b, x_dbc, dt_w, dt_b, a_log, d_skip,
               conv0, h0, *, d_state: int, chunk: int, fuse: bool,
               reduce=None):
    """The mixer between its projections, channel by channel: the causal
    conv, the ``x_dbc`` product, dt, the scan (chunkwise from a zero
    state, or the exact sequential step from ``h0``) and the gate.

    Every per-channel tensor may be any slice of the channels: the one
    product that mixes them, ``xi @ x_dbc`` (di -> R+2N), is summed over
    the slices by ``reduce`` when given (an all-reduce over the ranks
    holding them). Returns ``(y (B, T, di) in xi_raw's dtype, h (B, di, N)
    fp32, conv (B, K-1, di))``.
    """
    b, t, di = xi_raw.shape
    dt_rank = dt_w.shape[0]
    xi, new_conv = causal_conv1d(xi_raw, conv_w, conv0)
    xi = F.silu(xi + conv_b)

    dbc = xi @ x_dbc                                  # (B, T, R+2N)
    if reduce is not None:
        dbc = reduce(dbc)
    dt_low = dbc[..., :dt_rank]
    b_mat = dbc[..., dt_rank:dt_rank + d_state].float()
    c_mat = dbc[..., dt_rank + d_state:].float()
    # the fp32 bias promotes the sum to fp32; XLA then keeps the bf16
    # product's fp32 accumulator unrounded, so the product is taken in fp32
    dt = F.softplus(dt_low.float() @ dt_w.float() + dt_b)

    a = -torch.exp(a_log.float())                     # (di, N), negative
    xif = xi.float()

    if h0 is None:
        h0 = torch.zeros((b, di, d_state), dtype=torch.float32,
                         device=xi_raw.device)
        if fuse:
            y, h_t = _ssm_scan_chunked_fused(dt, b_mat, c_mat, xif, a, h0,
                                             chunk)
        else:
            a_bar = torch.exp(dt[..., None] * a)      # (B, T, di, N)
            u = (dt * xif)[..., None] * b_mat[..., None, :]
            y, h_t = _ssm_scan_chunked(a_bar, u, c_mat, h0, chunk)
    else:
        a_bar = torch.exp(dt[..., None] * a)
        u = (dt * xif)[..., None] * b_mat[..., None, :]
        h_t, ys = h0.float(), []
        for i in range(t):
            h_t = a_bar[:, i] * h_t + u[:, i]
            ys.append(torch.einsum("bdn,bn->bd", h_t, c_mat[:, i]))
        y = torch.stack(ys, dim=1)

    y = y + xif * d_skip.float()
    y = y.to(xi_raw.dtype) * F.silu(z)
    return y, h_t, new_conv
