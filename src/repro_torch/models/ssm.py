"""Recurrent blocks (port of ``models/ssm.py``), plain torch: the Mamba
selective SSM (jamba) and the xLSTM cells, mLSTM and sLSTM (xlstm-125m).

* Mamba's prefill is chunked as the reference's is: a loop over
  time-chunks carries ``h [B, di, ds]`` while the recurrence inside a
  chunk, ``h_t = dA_t h_{t-1} + dBu_t``, runs as a log-depth
  (Hillis-Steele) scan, where the reference runs ``associative_scan``.
  The two combine the same products in different orders, so f32 results
  agree to rounding (the parity tests hold 1e-5), not bit for bit.
* mLSTM runs chunkwise-parallel (gated-linear-attention style) with the
  xLSTM paper's log-space stabiliser ``m``; :func:`mlstm_seq`, the
  sequential cell, is its oracle and its one-token decode.
* sLSTM has hidden-to-gate recurrence: a Python loop over the sequence.

Every state leaf but the conv tails is f32, as in the reference.

Under a mesh each block takes a ``ch`` (a ``sharding.Channels``) and runs
on the weights of a rank (``sharding.Local.layer``): Mamba on its block of
the channels, with ``x_proj``'s contraction summed over the blocks;
mLSTM on its block of whole heads, its q/k/v and gates from every
channel (the blocks gathered) and its group norm over every channel; the
sLSTM cell whole, its gates' input from the rank's block of their columns
(gathered) and its FFN on the rank's width.  The caller sums a Mamba or
mLSTM block's output projection over the blocks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import mlp_apply, rmsnorm

__all__ = ["causal_conv1d", "conv1d_step", "mamba_dims", "mamba_apply",
           "mamba_state_init", "mamba_decode_step", "mlstm_dims",
           "mlstm_cell_chunked", "mlstm_seq", "mlstm_apply",
           "mlstm_state_init", "mlstm_decode_step", "slstm_ffn_width",
           "slstm_apply", "slstm_state_init", "slstm_decode_step"]


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x ``[B, S, C]``, w ``[dc, C]``, b ``[C]``;
    the taps are summed in order, as the reference does."""
    dc, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, dc - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(dc)) + b


def conv1d_step(conv_state, x_t, w, b):
    """One decode step.  conv_state ``[B, dc-1, C]``, x_t ``[B, C]``;
    returns (new conv_state, out ``[B, C]``), the taps summed in the
    order of :func:`causal_conv1d`."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)        # [B, dc, C]
    out = sum(full[:, i] * w[i] for i in range(w.shape[0])) + b
    return full[:, 1:], out


def _conv_tail(x, dc1):
    """The last ``dc1`` rows of x ``[B, S, C]``, zero-padded in front when
    S is shorter: the conv state after a prompt."""
    S = x.shape[1]
    return x[:, S - dc1:] if S >= dc1 else F.pad(x, (0, 0, dc1 - S, 0))


def _largest_divisor(S, chunk):
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================

def mamba_dims(cfg):
    """(MambaSpec, d_inner, dt_rank)."""
    ms = cfg.mamba
    return ms, ms.expand * cfg.d_model, ms.dt_rank or -(-cfg.d_model // 16)


def _mamba_inner(xc, p, cfg, ch=None):
    """xc: conv+silu output ``[B, L, di]`` -> (dA ``[B, L, di, ds]``, dBu,
    C ``[B, L, ds]``), in f32."""
    ms, _, dtr = mamba_dims(cfg)
    ds = ms.d_state
    dbc = torch.einsum("bld,de->ble", xc, p["x_proj"]).float()
    if ch is not None:
        dbc = ch.sum(dbc)
    dt_raw, Bm, Cm = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.einsum("blr,rd->bld", dt_raw, p["dt_w"].float())
                    + p["dt_b"])                             # [B, L, di]
    A = -torch.exp(p["A_log"])                               # [di, ds]
    dA = torch.exp(dt[..., None] * A)
    dBu = (dt * xc.float())[..., None] * Bm[:, :, None, :]
    return dA, dBu, Cm


def _scan_chunk(h0, dA, dBu):
    """``h_t = dA_t h_{t-1} + dBu_t`` over a chunk.  h0 ``[B, di, ds]``;
    dA/dBu ``[B, L, di, ds]``.  Returns (h_all ``[B, L, di, ds]``, h_L).

    Inclusive prefix of the pairs ``(a, b)`` under ``(a, b) then (a', b')
    = (a a', b a' + b')``, by doubling strides (log2 L steps), then the
    carry: ``h_t = A_t h0 + B_t``."""
    pA, pB = dA, dBu
    L, shift = dA.shape[1], 1
    while shift < L:
        pB = torch.cat([pB[:, :shift],
                        pB[:, :-shift] * pA[:, shift:] + pB[:, shift:]], 1)
        pA = torch.cat([pA[:, :shift], pA[:, :-shift] * pA[:, shift:]], 1)
        shift *= 2
    h_all = pA * h0[:, None] + pB
    return h_all, h_all[:, -1]


def mamba_apply(x, p, cfg, return_state=False, ch=None):
    """Prefill pass.  x ``[B, S, d]`` -> ``[B, S, d]`` (and, with
    ``return_state``, the decode state ``{"conv", "h"}``)."""
    B, S, _ = x.shape
    ms = cfg.mamba
    di = p["A_log"].shape[0]                # p's channels (a rank's own)
    chunk = _largest_divisor(S, ms.chunk)
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(xin, p["conv_w"], p["conv_b"]))
    h = torch.zeros((B, di, ms.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xck = xc[:, c0:c0 + chunk]
        dA, dBu, Cm = _mamba_inner(xck, p, cfg, ch)
        h_all, h = _scan_chunk(h, dA, dBu)
        del dA, dBu
        y = torch.einsum("blds,bls->bld", h_all, Cm)
        ys.append(y + p["D"] * xck.float())
        del h_all
    y = torch.cat(ys, dim=1).to(x.dtype) * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])
    if return_state:
        return out, {"conv": _conv_tail(xin, ms.d_conv - 1), "h": h}
    return out


def mamba_state_init(cfg, B, dtype, device, ways=1):
    """The zero state of ``B`` sequences (of one of ``ways`` blocks of the
    channels)."""
    ms, di, _ = mamba_dims(cfg)
    di //= ways
    return {"conv": torch.zeros((B, ms.d_conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((B, di, ms.d_state), dtype=torch.float32,
                             device=device)}


def mamba_decode_step(x_t, p, cfg, state, ch=None):
    """x_t ``[B, d]`` -> (``[B, d]``, new state)."""
    xz = torch.einsum("bd,de->be", x_t, p["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    conv_state, xc = conv1d_step(state["conv"], xin, p["conv_w"],
                                 p["conv_b"])
    xc = F.silu(xc)
    dA, dBu, Cm = _mamba_inner(xc[:, None], p, cfg, ch)
    h = state["h"] * dA[:, 0] + dBu[:, 0]
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0]) + p["D"] * xc.float()
    y = y.to(x_t.dtype) * F.silu(z)
    out = torch.einsum("bd,de->be", y, p["out_proj"])
    return out, {"conv": conv_state, "h": h}


# ===========================================================================
# mLSTM (xLSTM matrix-memory cell)
# ===========================================================================

def mlstm_dims(cfg):
    """(d_inner, head dim)."""
    di = int(cfg.xlstm.m_proj_factor * cfg.d_model)
    return di, di // cfg.n_heads


def _mlstm_qkvif(xc, xv, p):
    """Per-head q, k, v from the conv output / value path, and the gate
    pre-activations (f32), for the heads of ``p``."""
    B, L, _ = xc.shape
    H = p["w_i"].shape[1]
    dh = p["wq"].shape[1] // H
    q = torch.einsum("bld,de->ble", xc, p["wq"]).reshape(B, L, H, dh)
    k = torch.einsum("bld,de->ble", xc, p["wk"]).reshape(B, L, H, dh)
    v = torch.einsum("bld,de->ble", xv, p["wv"]).reshape(B, L, H, dh)
    xf = xc.float()
    i_pre = torch.einsum("bld,dh->blh", xf, p["w_i"]) + p["b_i"]
    f_pre = torch.einsum("bld,dh->blh", xf, p["w_f"]) + p["b_f"]
    return q, k, v, i_pre, f_pre


def mlstm_cell_chunked(q, k, v, i_pre, f_pre, C0, n0, m0, chunk):
    """Chunkwise-parallel stabilised mLSTM cell.

    q, k, v ``[B, S, H, dh]``; i_pre, f_pre ``[B, S, H]``; carries C0
    ``[B, H, dh, dh]`` (k v^T), n0 ``[B, H, dh]``, m0 ``[B, H]``.  Returns
    (h ``[B, S, H, dh]`` in q's dtype, C, n, m)."""
    B, S, H, dh = q.shape
    L = _largest_divisor(S, chunk)
    scale = 1.0 / math.sqrt(dh)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n, m = C0, n0, m0
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        ib, fb = i_pre[:, sl], f_pre[:, sl]                 # [B, L, H]
        logf = F.logsigmoid(fb)
        b = logf.cumsum(dim=1)                              # inclusive
        a = ib - b
        M = torch.cummax(a, dim=1).values                   # running max
        m_i = b + torch.maximum(m[:, None], M)              # [B, L, H]
        # intra-chunk decay D[i, j] = exp(a_j + b_i - m_i), j <= i
        Dlog = a[:, None, :, :] + b[:, :, None, :] - m_i[:, :, None, :]
        Dm = torch.where(mask[None, :, :, None], torch.exp(Dlog), 0.0)
        qf = q[:, sl].float() * scale
        kf = k[:, sl].float()
        vf = v[:, sl].float()
        S_ij = torch.einsum("bihd,bjhd->bijh", qf, kf) * Dm
        h_intra = torch.einsum("bijh,bjhd->bihd", S_ij, vf)
        n_intra = torch.einsum("bijh,bjhd->bihd", Dm, kf)
        # inter-chunk: the carry decays by exp(b_i + m_prev - m_i)
        dec = torch.exp(b + m[:, None] - m_i)               # [B, L, H]
        h_inter = torch.einsum("bihd,bhde->bihe", qf, C) * dec[..., None]
        n_all = n_intra + n[:, None] * dec[..., None]
        denom = torch.maximum(
            torch.einsum("bihd,bihd->bih", qf, n_all).abs(),
            torch.exp(-m_i))
        hs.append((h_intra + h_inter) / denom[..., None])
        # carry to the chunk's end
        G = b[:, -1]                                        # [B, H]
        m_new = m_i[:, -1]
        w_j = torch.exp(ib + (G[:, None] - b) - m_new[:, None])
        decay = torch.exp(G + m - m_new)
        C = (C * decay[..., None, None]
             + torch.einsum("bjh,bjhd,bjhe->bhde", w_j, kf, vf))
        n = n * decay[..., None] + torch.einsum("bjh,bjhd->bhd", w_j, kf)
        m = m_new
    h = torch.cat(hs, dim=1)
    return h.to(q.dtype), C, n, m


def mlstm_seq(q, k, v, i_pre, f_pre, C0, n0, m0):
    """Sequential oracle of the chunked cell (the same math, step by
    step); also the one-token decode."""
    B, S, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    C, n, m = C0, n0, m0
    hs = []
    for t in range(S):
        qt = q[:, t].float() * scale
        kt = k[:, t].float()
        vt = v[:, t].float()
        logf = F.logsigmoid(f_pre[:, t])
        m_new = torch.maximum(logf + m, i_pre[:, t])
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(i_pre[:, t] - m_new)
        C = C * fp[..., None, None] + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fp[..., None] + ip[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype), C, n, m


def _whole(ch):
    """Every channel of a block of them (``ch.gather``; unsharded, x)."""
    return (lambda x: x) if ch is None else ch.gather


def _whole_pair(a, b, ch):
    """Every channel of two blocks of them, gathered together."""
    if ch is None:
        return a, b
    return ch.gather(torch.cat([a, b], dim=-1), parts=2).chunk(2, dim=-1)


def _mlstm_out(h, xc, z, p, cfg, ch=None):
    """Group norm (over every channel), skip, output gate and down
    projection of the cell's h ``[..., di]``."""
    h = rmsnorm(_whole(ch)(h), p["gn"], cfg.norm_eps)
    if ch is not None:
        h = ch.block(h)
    h = h + p["skip"] * xc
    return torch.einsum("...d,de->...e", h * F.silu(z), p["down_proj"])


def mlstm_apply(x, p, cfg, return_state=False, ch=None):
    """mLSTM block: x ``[B, S, d]`` -> ``[B, S, d]`` (and the state)."""
    B, S, _ = x.shape
    xs = cfg.xlstm
    xz = torch.einsum("bsd,de->bse", x, p["up_proj"])
    xin, z = xz.chunk(2, dim=-1)
    xc = F.silu(causal_conv1d(xin, p["conv_w"], p["conv_b"]))
    q, k, v, i_pre, f_pre = _mlstm_qkvif(*_whole_pair(xc, xin, ch), p)
    st = mlstm_state_init(cfg, B, x.dtype, x.device,
                          cfg.n_heads // p["w_i"].shape[1])
    h, C, n, m = mlstm_cell_chunked(q, k, v, i_pre, f_pre, st["C"], st["n"],
                                    st["m"], min(xs.m_chunk, S))
    out = _mlstm_out(h.reshape(B, S, -1), xc, z, p, cfg, ch)
    if return_state:
        return out, {"conv": _conv_tail(xin, xs.m_conv - 1), "C": C, "n": n,
                     "m": m}
    return out


def mlstm_state_init(cfg, B, dtype, device, ways=1):
    """The zero state of ``B`` sequences (of one of ``ways`` blocks of the
    heads)."""
    di, dh = mlstm_dims(cfg)
    di, H = di // ways, cfg.n_heads // ways
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((B, cfg.xlstm.m_conv - 1, di), dtype=dtype,
                                device=device),
            "C": torch.zeros((B, H, dh, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "m": torch.zeros((B, H), **f32)}


def mlstm_decode_step(x_t, p, cfg, state, ch=None):
    B = x_t.shape[0]
    xz = torch.einsum("bd,de->be", x_t, p["up_proj"])
    xin, z = xz.chunk(2, dim=-1)
    conv_state, xc = conv1d_step(state["conv"], xin, p["conv_w"],
                                 p["conv_b"])
    xc = F.silu(xc)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(
        *(t[:, None] for t in _whole_pair(xc, xin, ch)), p)
    h, C, n, m = mlstm_seq(q, k, v, i_pre, f_pre, state["C"], state["n"],
                           state["m"])
    out = _mlstm_out(h.reshape(B, -1), xc, z, p, cfg, ch)
    return out, {"conv": conv_state, "C": C, "n": n, "m": m}


# ===========================================================================
# sLSTM (xLSTM scalar-memory cell; sequential by construction)
# ===========================================================================

def slstm_ffn_width(cfg) -> int:
    """The sLSTM block's gated-FFN width, rounded up to 8."""
    df = int(cfg.xlstm.s_proj_factor * cfg.d_model)
    return -(-df // 8) * 8


def _slstm_cell(Wx_t, h_prev, c_prev, n_prev, m_prev, R, H):
    """One sLSTM step.  Wx_t ``[B, 4d]`` (the input part, bias included);
    states ``[B, d]``."""
    B, d4 = Wx_t.shape
    d = d4 // 4
    rec = torch.einsum("bhd,hde->bhe", h_prev.reshape(B, H, d // H),
                       R).reshape(B, d4)
    z_pre, i_pre, f_pre, o_pre = (Wx_t + rec).chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m_prev, i_pre)
    ip = torch.exp(i_pre - m_new)
    fp = torch.exp(logf + m_prev - m_new)
    c = fp * c_prev + ip * z
    n = fp * n_prev + ip
    h = o * c / n.clamp(min=1e-6)
    return h, c, n, m_new


def _gates_in(xc, p, ch=None):
    """The gates' input part ``xc W + b`` (f32); under a mesh from this
    rank's block of each gate's columns (``ch.project``)."""
    def proj(u):
        return torch.einsum("...d,de->...e", u, p["W"])

    return (proj(xc) if ch is None else ch.project(xc, proj)).float() + p["b"]


def _slstm_out(x, h, p, cfg, ch=None):
    """Group norm, the cell residual and the block's gated FFN (gelu);
    the model adds x back."""
    out = x + rmsnorm(h, p["gn"], cfg.norm_eps)

    def ffn(u):
        return mlp_apply(u, p["ffn"], act="gelu")

    u = rmsnorm(out, p["ffn_norm"], cfg.norm_eps)
    ff = ffn(u) if ch is None else ch.mlp(u, ffn)
    return out + ff - x


def slstm_apply(x, p, cfg, return_state=False, ch=None):
    """sLSTM block: conv -> cell loop -> group norm -> gated FFN."""
    B, S, d = x.shape
    xc = F.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    Wx = _gates_in(xc, p, ch)
    st = slstm_state_init(cfg, B, x.dtype, x.device)
    h, c, n, m = st["h"], st["c"], st["n"], st["m"]
    hs = []
    for t in range(S):
        h, c, n, m = _slstm_cell(Wx[:, t], h, c, n, m, p["R"], cfg.n_heads)
        hs.append(h)
    y = _slstm_out(x, torch.stack(hs, dim=1).to(x.dtype), p, cfg, ch)
    if return_state:
        return y, {"conv": _conv_tail(x, cfg.xlstm.s_conv - 1), "h": h,
                   "c": c, "n": n, "m": m}
    return y


def slstm_state_init(cfg, B, dtype, device, ways=1):
    """The zero state of ``B`` sequences (the cell is never split:
    ``ways`` is 1)."""
    assert ways == 1, "the sLSTM cell is whole on every rank"
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((B, cfg.xlstm.s_conv - 1, d), dtype=dtype,
                                device=device),
            "h": torch.zeros((B, d), **f32), "c": torch.zeros((B, d), **f32),
            "n": torch.zeros((B, d), **f32), "m": torch.zeros((B, d), **f32)}


def slstm_decode_step(x_t, p, cfg, state, ch=None):
    conv_state, xc = conv1d_step(state["conv"], x_t, p["conv_w"],
                                 p["conv_b"])
    xc = F.silu(xc)
    Wx = _gates_in(xc, p, ch)
    h, c, n, m = _slstm_cell(Wx, state["h"], state["c"], state["n"],
                             state["m"], p["R"], cfg.n_heads)
    y = _slstm_out(x_t[:, None], h.to(x_t.dtype)[:, None], p, cfg, ch)[:, 0]
    return y, {"conv": conv_state, "h": h, "c": c, "n": n, "m": m}
