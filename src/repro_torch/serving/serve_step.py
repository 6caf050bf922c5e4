"""Serving steps (port of ``serving/serve_step.py``): prefill and
single-token decode for dense attention decoders.

Two cache regimes, selected by ``budget``:
  * budget == 0: unbounded contiguous KV buffers of ``max_len`` slots;
    slot index == token position;
  * budget > 0: the paper's bounded slot pool; each attention layer holds
    ``budget`` physical slots managed per sequence by DynamicAdaptiveClimb
    (:mod:`.kv_cache`), so a decoded token attends over O(budget) slots
    whatever the context length.

On CUDA tensors the prefill's attention is kernel B2
(``kernels.flash_attention``) and each decode step's is kernel B3
(``kernels.decode_attention``), whose per-slot mass is DAC's hit signal;
``impl="plain"`` runs their plain versions instead.

The state is ``{"pos": [B] int32, "layers": [one dict per layer]}``.
Unlike the reference (whose arrays are immutable), :func:`decode_step`
writes each token's K/V into the layer's buffers in place and returns the
same state with new ``pos`` and ``ctrl``: a copy of every buffer per
token would cost as much memory traffic as the attention itself.
"""
from __future__ import annotations

import torch

from ..models.config import ArchConfig
from ..models.layers import attend_decode, attn_qkv, mlp_apply, rmsnorm
from ..models.model import (check_supported, embed_inputs, forward,
                            layer_spec, logits_head)
from . import kv_cache as kvc

__all__ = ["init_serve_state", "decode_step", "prefill", "bounded_fill"]


def _layer_state(cfg: ArchConfig, B, max_len, budget, k0, device):
    L = budget if budget else max_len
    shape = (B, L, cfg.n_kv_heads, cfg.head_dim)
    st = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
          "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if budget:
        # serving starts at the full pool: DAC shrinks when hits concentrate
        # rather than evicting from a quarter-size start, unless a fleet
        # admission share k0 says otherwise
        st["ctrl"] = kvc.control_init(B, budget,
                                      k0=budget if k0 is None else k0,
                                      device=device)
    return st


def init_serve_state(cfg: ArchConfig, B: int, max_len: int, budget: int = 0,
                     k0: int | None = None, device="cuda") -> dict:
    """Fresh serve state.  budget > 0 => bounded DAC pool; ``k0`` starts
    each sequence's active budget below the full pool."""
    check_supported(cfg)
    return {"pos": torch.zeros(B, dtype=torch.int32, device=device),
            "layers": [_layer_state(cfg, B, max_len, budget, k0, device)
                       for _ in range(cfg.n_layers)]}


def _top_slot(mass, valid):
    """argmax of the mass over valid slots (first on ties), -1 when none."""
    masked = torch.where(valid, mass, float("-inf"))
    top = masked.argmax(dim=-1).to(torch.int32)
    return torch.where(valid.any(dim=-1), top, -1).to(torch.int32)


def _decode_attn(x, p, st, cfg, spec, pos, eps, k_min, kv_caps, impl):
    """One attention layer's decode (bounded or unbounded).  x ``[B, 1, d]``.
    Writes the token's K/V into ``st`` in place."""
    B = x.shape[0]
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = attn_qkv(h, p["attn"], cfg, pos[:, None])   # [B, 1, H|Hkv, hd]
    bidx = torch.arange(B, device=x.device)
    if "ctrl" in st:                                       # bounded (DAC)
        ctrl, slot = kvc.insert(st["ctrl"], pos)           # miss event
        st["k"][bidx, slot.long()] = k[:, 0]
        st["v"][bidx, slot.long()] = v[:, 0]
        valid = kvc.valid_slots(ctrl)
        if spec.window:
            valid = valid & (ctrl["slot_pos"] > (pos[:, None] - spec.window))
        o, mass = attend_decode(q[:, 0], st["k"], st["v"], valid,
                                softcap=cfg.attn_softcap, impl=impl)
        ctrl = kvc.hit(ctrl, _top_slot(mass, valid))       # hit event
        st["ctrl"] = kvc.resize(ctrl, eps=eps, k_min=k_min, cap=kv_caps)
    else:                                                  # unbounded
        st["k"][bidx, pos.long()] = k[:, 0]
        st["v"][bidx, pos.long()] = v[:, 0]
        ar = torch.arange(st["k"].shape[1], device=x.device)[None]
        valid = ar <= pos[:, None]
        if spec.window:
            valid = valid & (ar > pos[:, None] - spec.window)
        o, _ = attend_decode(q[:, 0], st["k"], st["v"], valid,
                             softcap=cfg.attn_softcap, impl=impl)
    att = torch.einsum("bhk,hkd->bd", o, p["attn"]["wo"])
    return x + att[:, None]


def decode_step(params, cfg: ArchConfig, state, token=None, embed=None,
                eps: float = 0.5, k_min: int = 16, kv_caps=None,
                impl="kernel"):
    """One decode step.  token ``[B]`` int (or embed ``[B, d]`` for
    stub-frontend archs).  Returns ``(state, logits [B, V] f32)``; the
    K/V buffers of ``state`` are updated in place.

    ``kv_caps`` (``[B]`` int32, optional) caps each sequence's bounded-pool
    growth for this step, the same for every layer; ``None`` = uncapped."""
    check_supported(cfg)
    pos = state["pos"]
    x = embed_inputs(params, cfg, token, embed)[:, None]    # [B, 1, d]
    for layer, (p, st) in enumerate(zip(params["layers"], state["layers"])):
        x = _decode_attn(x, p, st, cfg, layer_spec(cfg, layer), pos, eps,
                         k_min, kv_caps, impl)
        if "mlp" in p:
            h = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
            x = x + mlp_apply(h, p["mlp"], cfg.act)
    logits = logits_head(params, cfg, x)[:, 0]
    state["pos"] = pos + 1
    return state, logits


def bounded_fill(ctrl, S: int):
    """Replay S insert-only DAC steps (positions 0..S-1) from ``ctrl``.
    Returns ``(ctrl, last)``: the control state after the fill and, per
    sequence and physical slot, the position of the last token written
    there (-1 where none was).

    The reference replays this scan in every layer (``_bounded_fill``);
    the insert law reads no KV data, so every layer that starts from the
    same state follows the same trajectory, and the port runs it once.
    The slot a token lands in may be overwritten by a later token, so each
    slot takes its *last* writer, found with a max-reduction (no scatter
    with duplicate indices)."""
    B, Bmax = ctrl["rank2slot"].shape
    dev = ctrl["rank2slot"].device
    slots = []
    for t in range(S):
        ctrl, slot = kvc.insert(ctrl, torch.full((B,), t, dtype=torch.int32,
                                                 device=dev))
        slots.append(slot)
    seq = torch.stack(slots, dim=1).long()                 # [B, S]
    last = torch.full((B, Bmax), -1, dtype=torch.long, device=dev)
    t_idx = torch.arange(S, device=dev).expand(B, S)
    last = last.scatter_reduce(1, seq, t_idx, reduce="amax")
    return ctrl, last


def prefill(params, cfg: ArchConfig, tokens=None, embeds=None,
            max_len: int = 0, budget: int = 0, k0: int | None = None,
            impl="kernel"):
    """Run the prompt through the stack and build the serve state.

    Returns ``(serve_state, last_logits [B, V])``.  ``k0`` (bounded regime
    only) admits each sequence at an active budget below the full pool."""
    x = tokens if tokens is not None else embeds
    B, S = x.shape[:2]
    dev = x.device
    max_len = max_len or 2 * S
    logits, caches = forward(params, cfg, tokens=tokens, embeds=embeds,
                             impl=impl, want_cache=True, last_only=True)
    state = init_serve_state(cfg, B, max_len, budget, k0, device=dev)
    if budget:
        ctrl, last = bounded_fill(state["layers"][0]["ctrl"], S)
        bidx = torch.arange(B, device=dev)[:, None]
        src = last.clamp(min=0)
        hold = (last >= 0)[..., None, None]
    for st in state["layers"]:
        ca = caches.pop(0)                      # free each layer's K/V early
        if budget:
            st["ctrl"] = ctrl
            for name in ("k", "v"):
                st[name] = torch.where(hold, ca[name][bidx, src], st[name])
        else:
            st["k"][:, :S] = ca["k"]
            st["v"][:, :S] = ca["v"]
    state["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
    return state, logits[:, -1]
