"""xLSTM mixers (counterpart of ``repro/models/xlstm.py``): mLSTM (matrix
memory) and sLSTM (scalar memory, head-block-diagonal recurrent gate
mixing), both with stabilized exponential gating.

mLSTM prefills chunkwise: inside a chunk the recurrence is a
decay-masked attention product, across chunks a loop carries
``(C, n, m)``; decode takes the exact sequential step, which is also the
chunkwise form's oracle. sLSTM is sequential by nature: its prefill is a
Python loop over steps (the JAX package's ``lax.scan``, not a Pallas
kernel), chunked as the reference chunks it. Every state is fp32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.utils.loops import repeat
from repro_torch.utils.sharding import sc, whole_dim

NEG = -1e30


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h)


def _gates(p: dict, x: torch.Tensor):
    """(log input gate, forget gate pre-activation), each (B, T, H) fp32;
    the cores take the forget gate's log-sigmoid."""
    g = (whole_dim(torch.einsum("btd,dgh->btgh", x, p["w_if"]), -1)
         + p["b_if"]).float()
    return g[..., 0, :], g[..., 1, :]


def _qkv(p: dict, x: torch.Tensor, h: int):
    """q, k (scaled), v: (B, T, H, Dh). Under a mesh the products are
    row-parallel: their partial sums are all-reduced here, and each comes
    whole over its heads before the view cuts them."""
    dh = x.shape[-1] // h
    q = _heads(whole_dim(x @ p["wq"], -1), h)
    k = _heads(whole_dim(x @ p["wk"], -1), h) * (dh ** -0.5)
    v = _heads(whole_dim(x @ p["wv"], -1), h)
    return q, k, v


def _zero_state(b: int, h: int, dh: int, device):
    return (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            torch.full((b, h), NEG, dtype=torch.float32, device=device))


def _mlstm_inputs(p: dict, x: torch.Tensor, h: int, state0) -> tuple:
    """The head-wise inputs of an mLSTM core: q, k, v, log i, the forget
    gate's pre-activation and the state ``(C, n, m)`` (zero when
    ``state0`` is None)."""
    q, k, v = _qkv(p, x, h)
    log_i, log_f = _gates(p, x)                       # (B, T, H)
    b, _, di = x.shape
    c0, n0, m0 = state0 if state0 is not None else \
        _zero_state(b, h, di // h, x.device)
    return q, k, v, log_i, log_f, c0, n0, m0


def _run(core, args, on_shards):
    return core(*args) if on_shards is None else on_shards(core, args)


def mlstm_chunkwise(p: dict, x: torch.Tensor, *, n_heads: int,
                    chunk: int = 64, state0=None, want_state: bool = False,
                    on_shards=None):
    """Chunkwise-parallel stabilized mLSTM. x: (B, T, di).

    A T that is no multiple of the chunk is padded with steps that leave
    the state as it is (input gate exp(NEG) = 0, forget gate 1).
    Returns ``(y (B, T, di), (C, n, m) | None)``. The recurrence runs
    head by head (:func:`mlstm_chunkwise_core`), through
    ``on_shards(core, args)`` when given (each rank's heads under a
    mesh).
    """
    b, t, di = x.shape
    core = functools.partial(mlstm_chunkwise_core, chunk=min(chunk, t),
                             dtype=x.dtype)
    y, *st = _run(core, _mlstm_inputs(p, x, n_heads, state0), on_shards)
    return y.reshape(b, t, di), (tuple(st) if want_state else None)


def mlstm_chunkwise_core(q, k, v, log_i, log_f, c0, n0, m0, *, chunk: int,
                         dtype):
    """The chunkwise recurrence over whatever heads it is given: q, k, v
    (B, T, H, Dh), gates (B, T, H; the forget gate's pre-activation),
    state (C, n, m). Returns ``(y (B, T, H, Dh) in dtype, C, n, m)``."""
    b, t, h, dh = q.shape
    log_f = F.logsigmoid(log_f)
    tp = -(-t // chunk) * chunk
    if tp != t:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, tp - t)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, tp - t), value=NEG)
        log_f = F.pad(log_f, (0, 0, 0, tp - t), value=0.0)
    nc = tp // chunk
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qf, kf, vf = (a[:, sl].float() for a in (q, k, v))
        li_c, lf_c = log_i[:, sl], log_f[:, sl]       # (B, L, H)
        f_cum = torch.cumsum(lf_c, dim=1)             # F_t
        # a[t, s] = F_t - F_s + log i_s for s <= t
        a = f_cum[:, :, None, :] - f_cum[:, None, :, :] + li_c[:, None, :, :]
        a = torch.where(causal, a, NEG)               # (B, Tq, Ts, H)
        inter = f_cum + m0[:, None, :]                # (B, L, H)
        m_t = torch.maximum(a.amax(dim=2), inter)
        d_mat = torch.exp(a - m_t[:, :, None, :])
        w_inter = torch.exp(inter - m_t)

        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * d_mat
        num = torch.einsum("btsh,bshd->bthd", scores, vf) + \
            w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qf,
                                              c0.transpose(-1, -2))
        den = scores.sum(dim=2) + \
            w_inter * torch.einsum("bthd,bhd->bth", qf, n0)
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])

        # the state at the chunk's end
        f_last = f_cum[:, -1]                         # (B, H)
        g = f_last[:, None, :] - f_cum + li_c         # decay to the end
        m_new = torch.maximum(f_last + m0, g.amax(dim=1))
        w_old = torch.exp(f_last + m0 - m_new)
        w_in = torch.exp(g - m_new[:, None, :])       # (B, L, H)
        c0 = w_old[..., None, None] * c0 + torch.einsum(
            "bshd,bshe->bhde", w_in[..., None] * vf, kf)
        n0 = w_old[..., None] * n0 + torch.einsum("bsh,bshd->bhd", w_in, kf)
        m0 = m_new
    y = torch.cat(ys, dim=1).to(dtype)[:, :t]
    return y, c0, n0, m0


def mlstm_sequential(p: dict, x: torch.Tensor, *, n_heads: int,
                     state0=None, want_state: bool = False, on_shards=None):
    """The exact per-step recurrence (decode, and the chunkwise oracle)."""
    b, t, di = x.shape
    core = functools.partial(mlstm_sequential_core, dtype=x.dtype)
    y, *st = _run(core, _mlstm_inputs(p, x, n_heads, state0), on_shards)
    return y.reshape(b, t, di), (tuple(st) if want_state else None)


def mlstm_sequential_core(q, k, v, log_i, log_f, c, n, m, *, dtype):
    """The per-step recurrence over whatever heads it is given (as
    :func:`mlstm_chunkwise_core`)."""
    log_f = F.logsigmoid(log_f)
    ys = []
    for i in range(q.shape[1]):
        li_t, lf_t = log_i[:, i], log_f[:, i]
        m_new = torch.maximum(lf_t + m, li_t)
        i_p = torch.exp(li_t - m_new)
        f_p = torch.exp(lf_t + m - m_new)
        kf, vf, qf = k[:, i].float(), v[:, i].float(), q[:, i].float()
        c = f_p[..., None, None] * c + i_p[..., None, None] * (
            vf[..., :, None] * kf[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * kf
        num = torch.einsum("bhvk,bhk->bhv", c, qf)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                            torch.exp(-m_new))[..., None]
        ys.append(num / den)
        m = m_new
    return torch.stack(ys, dim=1).to(dtype), c, n, m


def mlstm_mixer(p: dict, x: torch.Tensor, *, n_heads: int, chunk: int = 64,
                state: dict | None = None, want_state: bool = False,
                on_shards=None):
    """Chunkwise for a prompt, sequential for one decode step. Returns
    ``(y @ out, {"c", "n", "m"} | None)``."""
    st0 = (state["c"], state["n"], state["m"]) if state is not None else None
    if x.shape[1] > 1 or state is None:
        y, st = mlstm_chunkwise(p, x, n_heads=n_heads, chunk=chunk,
                                state0=st0, want_state=want_state,
                                on_shards=on_shards)
    else:
        y, st = mlstm_sequential(p, x, n_heads=n_heads, state0=st0,
                                 want_state=want_state, on_shards=on_shards)
    new_state = {"c": st[0], "n": st[1], "m": st[2]} \
        if want_state and st is not None else None
    # the row-parallel product's layout, taken explicitly: its gradient
    # then comes back whole over the heads to the view that made y
    return sc(y, "act_batch", None, "ssm_inner") @ p["out"], new_state


def slstm_mixer(p: dict, x: torch.Tensor, *, n_heads: int, chunk: int = 128,
                state: dict | None = None, want_state: bool = False,
                on_shards=None):
    """sLSTM: scalar memory, head-block-diagonal recurrent weights.

    p: ``w (d, 4, d)``, ``b (4, d)``, ``r (H, Dh, 4, Dh)``, ``out (d, d)``;
    gate order ``[i, f, z, o]``. The steps run chunk by chunk (the input
    projection a chunk at a time); a T that is no multiple of the chunk
    is padded with masked steps that leave the state as it is. A chunk
    is :func:`slstm_chunk`, through ``on_shards(core, args)`` when given
    (each rank's heads under a mesh).
    """
    b, t, d = x.shape
    h = n_heads
    chunk = min(chunk, t)
    tp = -(-t // chunk) * chunk
    valid = torch.arange(tp, device=x.device) < t
    if tp != t:
        x = F.pad(x, (0, 0, 0, tp - t))
    if state is None:
        carry = (torch.zeros((b, d), dtype=torch.float32, device=x.device),
                 torch.zeros((b, d), dtype=torch.float32, device=x.device),
                 torch.zeros((b, d), dtype=torch.float32, device=x.device),
                 torch.full((b, h), NEG, dtype=torch.float32,
                            device=x.device))
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    ys = []
    for c in range(tp // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        core = functools.partial(slstm_chunk, dh=d // h, valid=valid[sl])
        y_c, *carry = _run(core, (x[:, sl], p["w"], p["b"], p["r"])
                           + tuple(carry), on_shards)
        ys.append(y_c)
    y = torch.cat(ys, dim=1).to(x.dtype)[:, :t]
    cs, ns, hs, ms = carry
    new_state = {"c": cs, "n": ns, "h": hs, "m": ms} if want_state else None
    return y @ p["out"], new_state


def slstm_chunk(x_c, w, b, r, c, n, h_prev, m, *, dh: int,
                valid: torch.Tensor | None = None):
    """One chunk: the input projection of x_c (B, L, d) by ``w`` (d, 4,
    H*Dh) and ``b`` (4, H*Dh), whatever heads they hold, then
    :func:`slstm_steps`."""
    wx = (torch.einsum("btd,dge->btge", x_c, w) + b).float()
    return slstm_steps(wx, r, c, n, h_prev, m, dh=dh, valid=valid)


def slstm_steps(wx: torch.Tensor, r: torch.Tensor, c, n, h_prev, m, *,
                dh: int, valid: torch.Tensor | None = None):
    """The sLSTM recurrence over one chunk, for whatever whole heads it is
    given: wx (B, L, 4, H*Dh) fp32 (the input projection and bias), r
    (H, Dh, 4, Dh), the carry c, n, h (B, H*Dh) and m (B, H). Returns
    ``(h (B, L, H*Dh) fp32, c, n, h, m)``."""
    b, l, _, d = wx.shape
    h = d // dh
    r = r.float()
    if valid is None:
        valid = torch.ones((l,), dtype=torch.bool, device=wx.device)
    st = {"c": c, "n": n, "h": h_prev, "m": m}
    out = wx.new_empty((b, l, d))

    def step(i):
        c, n, h_prev, m = st["c"], st["n"], st["h"], st["m"]
        rec = torch.einsum("bhd,hdge->bghe", h_prev.reshape(b, h, dh), r)
        g = wx[:, i] + rec.reshape(b, 4, d)
        li = g[:, 0].reshape(b, h, dh)
        lf = F.logsigmoid(g[:, 1]).reshape(b, h, dh)
        z = torch.tanh(g[:, 2])
        o = torch.sigmoid(g[:, 3])
        m_new = torch.maximum((lf + m[..., None]).amax(-1), li.amax(-1))
        i_p = torch.exp(li - m_new[..., None]).reshape(b, d)
        f_p = torch.exp(lf + m[..., None] - m_new[..., None]).reshape(b, d)
        c_new = f_p * c + i_p * z
        n_new = f_p * n + i_p
        h_new = o * (c_new / n_new.clamp_min(1e-6))
        # a padded step leaves the state as it was
        ok = valid[i]
        st["c"] = torch.where(ok, c_new, c)
        st["n"] = torch.where(ok, n_new, n)
        st["h"] = torch.where(ok, h_new, h_prev)
        st["m"] = torch.where(ok, m_new, m)
        out[:, i] = st["h"]
    # one step a trip: a trace lowering records one body (a sequence of
    # 32768 steps lowers as one step, as the reference's lax.scan does);
    # a decode step's single step is no loop
    if l == 1:
        step(0)
    else:
        repeat(l, step)
    return out, st["c"], st["n"], st["h"], st["m"]
