"""Mixture-of-Experts FFN with grouped capacity dispatch (port of
``models/moe.py``), plain torch.

Tokens are grouped per sequence (``[B]`` is the dispatch group dim), and
each group scatters its tokens into a dense per-expert buffer
``[B, E, C, d]`` followed by one batched expert product (``torch.einsum``,
as the reference leaves it to XLA).  Tokens beyond an expert's per-group
capacity ``C = ceil8(S*k/E * cf)`` are dropped in arrival order; the
residual stream carries them unchanged.  DeepSeek-style shared experts are
a dense gated MLP of width ``n_shared * d_ff_expert``.  Under a mesh the
experts split over ranks (:func:`moe_apply`'s ``loc``).

The router's weight is float32 even in a bf16 model, and the router runs
in f32.  :func:`aux_load_balance_loss` is training's Switch-style
load-balance term.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import mlp_apply

__all__ = ["capacity", "route", "dispatch", "moe_apply",
           "aux_load_balance_loss"]


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


def _routed(x, p, cfg, first=0):
    """The routed experts' output of x ``[B, S, d]``, f32, from the experts
    ``first ..`` whose weights ``p`` holds (all of them unsharded): the
    routing and the capacity law see every expert, and a choice of an
    expert outside the block adds nothing.

    Decode (S == 1, B > 1): the whole batch is one dispatch group, as in
    the reference, so ``C = capacity(B)``."""
    B, S, d = x.shape
    if S == 1 and B > 1:
        return _routed(x.reshape(1, B, d), p, cfg, first).reshape(B, 1, d)
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    C = capacity(S, cfg)

    idx, gates, _ = route(x, p["router"], cfg)            # [B, S, k]
    slot, keep = dispatch(idx.reshape(B, S * k), E, C)    # [B, S*k]
    rows = p["w_gate"].shape[0] * C                       # the block's E*C
    slot = slot - first * C
    keep = keep & (slot >= 0) & (slot < rows)
    slot = slot.clamp(0, rows - 1)

    # dispatch: scatter-add of the (duplicated) tokens into [B, E*C, d].
    # Rows of two choices coincide only at a clamped slot, where all but
    # one added row are the zeros of dropped choices: exact in any order.
    src = x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)
    base = torch.arange(B, device=x.device)[:, None] * rows
    xe = torch.zeros((B * rows, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, (slot + base).reshape(-1), src.reshape(B * S * k, d))
    xe = xe.reshape(B, rows // C, C, d)
    del src

    # batched expert MLP (B and E are pure batch dims)
    g = torch.einsum("becd,edf->becf", xe, p["w_gate"])
    u = torch.einsum("becd,edf->becf", xe, p["w_up"])
    a = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    del g
    ye = torch.einsum("becf,efd->becd", a * u, p["w_down"])
    del a, u

    # combine: gather each (token, choice) row, weight in f32, sum over k
    yf = ye.reshape(B, rows, d)[torch.arange(B, device=x.device)[:, None],
                                slot]                     # [B, S*k, d]
    w = gates.reshape(B, S * k) * keep
    return (yf.float() * w[..., None]).reshape(B, S, k, d).sum(2)


def moe_apply(x, p, cfg, loc=None, layer=None):
    """x ``[B, S, d]`` -> ``[B, S, d]``: the routed experts, plus the
    shared ones.

    Under a mesh (``loc``, a ``sharding.Local``; ``p`` layer ``layer``'s
    weights from ``loc.layer``) ``x`` is this rank's rows.  Serving
    gathers them into the whole batch, so that routing, capacity and
    drops are the unsharded ones (at decode the whole batch is one
    dispatch group); training (``loc.train``) routes each rank's rows,
    whose groups (sequences) are whole on it, gathered only over the
    batch axes the experts or their width split over.  The rank runs its
    experts on its block of their width, the partial outputs (in x's
    dtype) are summed over the expert and width axes, and the rank's rows
    taken back.  The shared experts are a dense MLP on the rank's block
    of their width, their partial output summed with the routed one's
    where the two split over the same axes."""
    act = cfg.act

    def shared(h):
        return mlp_apply(h, p["shared"], act)

    if loc is None:
        out = _routed(x, p, cfg).to(x.dtype)
        return out + shared(x) if cfg.moe.n_shared else out
    first, axes = loc.experts(layer)
    g = loc._batch_axes_of(axes) if loc.train else loc.b_axes
    whole = loc.cat(x, g) if g else x
    out = _routed(whole, p, cfg, first).to(x.dtype)
    if not cfg.moe.n_shared:
        return loc.reduce(out, axes, g)
    s_axes = loc.shared_axes(layer)
    if s_axes == axes:                  # one sum for both partials
        return loc.reduce(out + shared(whole), axes, g)
    return (loc.reduce(out, axes, g)
            + loc.mlp(s_axes, x, shared))


def aux_load_balance_loss(x, router_w, cfg, loc=None):
    """Switch-style load-balance auxiliary loss, ``E * sum_e f_e * P_e``:
    f_e the share of tokens whose first choice is expert e, P_e the mean
    router probability of e.  Its gradient flows through P only.

    Under a mesh (``loc``) ``x`` is this rank's rows and ``router_w`` the
    whole router: f and P are means over the whole batch, their sums
    added over the batch axes before the product."""
    m = cfg.moe
    idx, _, probs = route(x, router_w, cfg)
    frac = F.one_hot(idx[..., 0], m.n_experts).float()
    if loc is None:
        return (frac.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum() \
            * m.n_experts
    n = loc.B * x.shape[1]              # the whole batch's tokens
    frac = loc.sum(frac.sum(dim=(0, 1)), loc.b_axes) / n
    mean_p = loc.sum(probs.sum(dim=(0, 1)), loc.b_axes) / n
    return (frac * mean_p).sum() * m.n_experts
