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

import torch
import torch.nn.functional as F

NEG = -1e30


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h)


def _gates(p: dict, x: torch.Tensor):
    """(log input gate, log forget gate), each (B, T, H) fp32."""
    g = (torch.einsum("btd,dgh->btgh", x, p["w_if"]) + p["b_if"]).float()
    return g[..., 0, :], F.logsigmoid(g[..., 1, :])


def _qkv(p: dict, x: torch.Tensor, h: int):
    dh = x.shape[-1] // h
    q = _heads(x @ p["wq"], h)
    k = _heads(x @ p["wk"], h) * (dh ** -0.5)
    v = _heads(x @ p["wv"], h)
    return q, k, v


def _zero_state(b: int, h: int, dh: int, device):
    return (torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((b, h, dh), dtype=torch.float32, device=device),
            torch.full((b, h), NEG, dtype=torch.float32, device=device))


def mlstm_chunkwise(p: dict, x: torch.Tensor, *, n_heads: int,
                    chunk: int = 64, state0=None, want_state: bool = False):
    """Chunkwise-parallel stabilized mLSTM. x: (B, T, di).

    A T that is no multiple of the chunk is padded with steps that leave
    the state as it is (input gate exp(NEG) = 0, forget gate 1).
    Returns ``(y (B, T, di), (C, n, m) | None)``.
    """
    b, t, di = x.shape
    h = n_heads
    dh = di // h
    chunk = min(chunk, t)
    q, k, v = _qkv(p, x, h)
    log_i, log_f = _gates(p, x)                       # (B, T, H)
    tp = -(-t // chunk) * chunk
    if tp != t:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, tp - t)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, tp - t), value=NEG)
        log_f = F.pad(log_f, (0, 0, 0, tp - t), value=0.0)
    nc = tp // chunk
    c0, n0, m0 = state0 if state0 is not None else \
        _zero_state(b, h, dh, x.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
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
    y = torch.cat(ys, dim=1).reshape(b, tp, di).to(x.dtype)[:, :t]
    return y, ((c0, n0, m0) if want_state else None)


def mlstm_sequential(p: dict, x: torch.Tensor, *, n_heads: int,
                     state0=None, want_state: bool = False):
    """The exact per-step recurrence (decode, and the chunkwise oracle)."""
    b, t, di = x.shape
    h = n_heads
    dh = di // h
    q, k, v = _qkv(p, x, h)
    log_i, log_f = _gates(p, x)
    c, n, m = state0 if state0 is not None else \
        _zero_state(b, h, dh, x.device)
    ys = []
    for i in range(t):
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
    y = torch.stack(ys, dim=1).reshape(b, t, di).to(x.dtype)
    return y, ((c, n, m) if want_state else None)


def mlstm_mixer(p: dict, x: torch.Tensor, *, n_heads: int, chunk: int = 64,
                state: dict | None = None, want_state: bool = False):
    """Chunkwise for a prompt, sequential for one decode step. Returns
    ``(y @ out, {"c", "n", "m"} | None)``."""
    st0 = (state["c"], state["n"], state["m"]) if state is not None else None
    if x.shape[1] > 1 or state is None:
        y, st = mlstm_chunkwise(p, x, n_heads=n_heads, chunk=chunk,
                                state0=st0, want_state=want_state)
    else:
        y, st = mlstm_sequential(p, x, n_heads=n_heads, state0=st0,
                                 want_state=want_state)
    new_state = {"c": st[0], "n": st[1], "m": st[2]} \
        if want_state and st is not None else None
    return y @ p["out"], new_state


def slstm_mixer(p: dict, x: torch.Tensor, *, n_heads: int, chunk: int = 128,
                state: dict | None = None, want_state: bool = False):
    """sLSTM: scalar memory, head-block-diagonal recurrent weights.

    p: ``w (d, 4, d)``, ``b (4, d)``, ``r (H, Dh, 4, Dh)``, ``out (d, d)``;
    gate order ``[i, f, z, o]``. The steps run chunk by chunk (the input
    projection a chunk at a time); a T that is no multiple of the chunk
    is padded with masked steps that leave the state as it is.
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
        carry, y_c = _slstm_chunk(p, x[:, sl], carry, n_heads=n_heads,
                                  valid=valid[sl])
        ys.append(y_c)
    y = torch.cat(ys, dim=1).to(x.dtype)[:, :t]
    cs, ns, hs, ms = carry
    new_state = {"c": cs, "n": ns, "h": hs, "m": ms} if want_state else None
    return y @ p["out"], new_state


def _slstm_chunk(p: dict, x_c: torch.Tensor, carry: tuple, *, n_heads: int,
                 valid: torch.Tensor | None = None):
    """One chunk of the sLSTM recurrence. x_c: (B, L, d). Returns
    ``(carry, h (B, L, d) fp32)``."""
    b, l, d = x_c.shape
    h = n_heads
    dh = d // h
    wx = (torch.einsum("btd,dge->btge", x_c, p["w"]) + p["b"]).float()
    r = p["r"].float()
    if valid is None:
        valid = torch.ones((l,), dtype=torch.bool, device=x_c.device)
    c, n, h_prev, m = carry
    out = []
    for i in range(l):
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
        c = torch.where(ok, c_new, c)
        n = torch.where(ok, n_new, n)
        h_prev = torch.where(ok, h_new, h_prev)
        m = torch.where(ok, m_new, m)
        out.append(h_prev)
    return (c, n, h_prev, m), torch.stack(out, dim=1)
