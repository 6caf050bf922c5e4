"""Mixture-of-Experts FFN with grouped capacity dispatch (port of
``models/moe.py``), plain torch.

Tokens are grouped per sequence (``[B]`` is the dispatch group dim), and
each group scatters its tokens into a dense per-expert buffer
``[B, E, C, d]`` followed by one batched expert product (``torch.einsum``,
as the reference leaves it to XLA).  Tokens beyond an expert's per-group
capacity ``C = ceil8(S*k/E * cf)`` are dropped in arrival order; the
residual stream carries them unchanged.  DeepSeek-style shared experts are
a dense gated MLP of width ``n_shared * d_ff_expert``.

The router's weight is float32 even in a bf16 model, and the router runs
in f32.  The reference's ``aux_load_balance_loss`` is training (ROADMAP
A12.5) and has no counterpart here yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import mlp_apply

__all__ = ["capacity", "route", "dispatch", "moe_apply"]


def capacity(group_tokens: int, cfg) -> int:
    """Per-expert slots of a dispatch group of ``group_tokens`` tokens,
    rounded up to 8 (at least 8)."""
    m = cfg.moe
    c = int(group_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(x, router_w, cfg):
    """Router.  x ``[B, S, d]`` -> (idx ``[B, S, k]``, gates ``[B, S, k]``,
    probs ``[B, S, E]``), in f32.  ``torch.topk`` sorts descending, as
    ``jax.lax.top_k``; on exact ties the two may pick different experts
    (the reference takes the lower index)."""
    m = cfg.moe
    logits = torch.einsum("bsd,de->bse", x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    if m.router_norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return idx, gates, probs


def dispatch(e_flat, E: int, C: int):
    """The reference's arrival-order capacity law.  e_flat ``[B, N]`` (the
    expert of each (token, choice) in order) -> (slot ``[B, N]`` into the
    group's ``E*C`` rows, keep ``[B, N]``): a choice's position is the
    number of earlier choices of its expert in the group, kept while below
    C; a dropped choice's slot is clamped to the expert's last row."""
    counts = F.one_hot(e_flat, E).cumsum(dim=1)            # [B, N, E]
    pos = counts.gather(2, e_flat[..., None])[..., 0] - 1  # exclusive
    keep = pos < C
    return e_flat * C + pos.clamp(max=C - 1), keep


def moe_apply(x, p, cfg):
    """x ``[B, S, d]`` -> ``[B, S, d]``.

    Decode (S == 1, B > 1): the whole batch is one dispatch group, as in
    the reference, so ``C = capacity(B)``."""
    B, S, d = x.shape
    if S == 1 and B > 1:
        return moe_apply(x.reshape(1, B, d), p, cfg).reshape(B, 1, d)
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    C = capacity(S, cfg)

    idx, gates, _ = route(x, p["router"], cfg)            # [B, S, k]
    slot, keep = dispatch(idx.reshape(B, S * k), E, C)    # [B, S*k]

    # dispatch: scatter-add of the (duplicated) tokens into [B, E*C, d].
    # Rows of two choices coincide only at a clamped slot, where all but
    # one added row are the zeros of dropped choices: exact in any order.
    src = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    base = torch.arange(B, device=x.device)[:, None] * (E * C)
    xe = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, (slot + base).reshape(-1), src.reshape(B * S * k, d))
    xe = xe.reshape(B, E, C, d)
    del src

    # batched expert MLP (B and E are pure batch dims)
    g = torch.einsum("becd,edf->becf", xe, p["w_gate"])
    u = torch.einsum("becd,edf->becf", xe, p["w_up"])
    a = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    del g
    ye = torch.einsum("becf,efd->becd", a * u, p["w_down"])
    del a, u

    # combine: gather each (token, choice) row, weight in f32, sum over k
    yf = ye.reshape(B, E * C, d)[torch.arange(B, device=x.device)[:, None],
                                 slot]                    # [B, S*k, d]
    w = gates.reshape(B, S * k) * keep
    out = (yf.float() * w[..., None]).reshape(B, S, k, d).sum(2)
    out = out.to(x.dtype)

    if m.n_shared:
        out = out + mlp_apply(x, p["shared"], cfg.act)
    return out
