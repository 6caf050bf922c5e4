"""Serving steps (port of ``serving/serve_step.py``): prefill and
single-token decode for every architecture of the repo's configurations.

Two cache regimes, selected by ``budget``:
  * budget == 0: unbounded contiguous KV buffers of ``max_len`` slots;
    slot index == token position;
  * budget > 0: the paper's bounded slot pool; each attention and MLA
    layer holds ``budget`` physical slots managed per sequence by
    DynamicAdaptiveClimb (:mod:`.kv_cache`), so a decoded token attends
    over O(budget) slots whatever the context length.

Recurrent layers (mamba, mlstm, slstm) carry O(1) state and ignore the
budget.  An MLA layer caches ``latent [B, L, r]`` and ``krope [B, L, dr]``
and attends in the absorbed form (``models.mla.mla_attend``, plain
torch), whose per-slot mass is its hit signal as B3's is an attention
layer's.

On CUDA tensors the prefill's attention (and MLA's) is kernel B2
(``kernels.flash_attention``) and each attention layer's decode is kernel
B3 (``kernels.decode_attention``); ``impl="plain"`` runs their plain
versions instead.

With ``sctx`` (a ``models.sharding.ShardCtx`` over a mesh of ranks),
:func:`prefill` and :func:`decode_step` run sharded for every
configuration: each rank holds its blocks of the parameters and of the
state, takes the whole batch's tokens and returns the whole batch's
logits.  B2 and B3 run on each rank's heads (attention and MLA), and
DAC's hit signal sums their per-slot mass (MLA's absorbed decode's) over
the model ranks in a fixed order, so that the control state is the same
on every model rank.  The state's blocks (``sharding.Local``): the batch
rows of the rank; an attention layer's KV heads; MLA's latent and
``k_rope`` whole on each model rank; Mamba's and mLSTM's states over the
layer's channel blocks (``Local.state_rows`` rows), sLSTM's whole; DAC's
control rows whole on each model rank.  :func:`serve_state_shardings`
(the reference's tables) says where these differ from the reference.

The state is ``{"pos": [B] int32, "layers": [one dict per layer]}``.
Unlike the reference (whose arrays are immutable), :func:`decode_step`
writes each token's K/V (or latent) into the layer's buffers in place and
returns the same state with new ``pos``, ``ctrl`` and recurrent states: a
copy of every buffer per token would cost as much memory traffic as the
attention itself.
"""
from __future__ import annotations

import torch

from ..models import mla, ssm
from ..models.config import ArchConfig
from ..models.layers import attend_decode, attn_qkv, rmsnorm
from ..models.model import (embed_inputs, ffn, forward, layer_spec,
                            local_view, logits_head)
from ..models.sharding import serve_state_shardings
from . import kv_cache as kvc

__all__ = ["init_serve_state", "serve_state_specs", "decode_step", "prefill",
           "bounded_fill", "kv_bytes", "serve_state_shardings"]

# the recurrent layers' state and one-token step, by kind
RECURRENT = {"mamba": (ssm.mamba_state_init, ssm.mamba_decode_step),
             "mlstm": (ssm.mlstm_state_init, ssm.mlstm_decode_step),
             "slstm": (ssm.slstm_state_init, ssm.slstm_decode_step)}
# the buffers that hold a slot's cache entry, by layer kind
CACHE_KEYS = {"attn": ("k", "v"), "mla": ("latent", "krope")}


def _layer_state(cfg: ArchConfig, kind, B, max_len, budget, k0, device,
                 n_kv, ways=1):
    if kind in RECURRENT:
        return RECURRENT[kind][0](cfg, B, cfg.dtype, device, ways)
    L = budget if budget else max_len
    kw = dict(dtype=cfg.dtype, device=device)
    if kind == "attn":
        shape = (B, L, n_kv, cfg.head_dim)
        st = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
    else:                                                  # mla
        st = {"latent": torch.zeros((B, L, cfg.kv_lora_rank), **kw),
              "krope": torch.zeros((B, L, cfg.qk_rope_head_dim), **kw)}
    if budget:
        # serving starts at the full pool: DAC shrinks when hits concentrate
        # rather than evicting from a quarter-size start, unless a fleet
        # admission share k0 says otherwise
        st["ctrl"] = kvc.control_init(B, budget,
                                      k0=budget if k0 is None else k0,
                                      device=device)
    return st


def init_serve_state(cfg: ArchConfig, B: int, max_len: int, budget: int = 0,
                     k0: int | None = None, device="cuda",
                     sctx=None) -> dict:
    """Fresh serve state.  budget > 0 => bounded DAC pool; ``k0`` starts
    each sequence's active budget below the full pool.  With ``sctx``,
    this rank's block of the state of ``B`` sequences."""
    kinds = [layer_spec(cfg, layer).kind for layer in range(cfg.n_layers)]
    if sctx is None:
        return {"pos": torch.zeros(B, dtype=torch.int32, device=device),
                "layers": [_layer_state(cfg, kind, B, max_len, budget, k0,
                                        device, cfg.n_kv_heads)
                           for kind in kinds]}
    loc = local_view(cfg, sctx, B)
    layers = []
    for layer, kind in enumerate(kinds):
        rows, ways = loc.batch, 1
        if kind in RECURRENT:
            rows, ways = loc.state_rows(layer), loc.channels(layer).ways
        layers.append(_layer_state(cfg, kind, rows, max_len, budget, k0,
                                   device, loc.local_heads(cfg.n_kv_heads),
                                   ways))
    return {"pos": torch.zeros(loc.batch, dtype=torch.int32, device=device),
            "layers": layers}


def serve_state_specs(cfg: ArchConfig, B: int, max_len: int,
                      budget: int = 0, sctx=None, device="cuda",
                      mode=None) -> dict:
    """:func:`init_serve_state` under a ``FakeTensorMode`` (``mode``, else a
    new one): the state (with ``sctx``, this rank's block of it) as fake
    tensors on ``device``, nothing allocated.

    >>> from repro_torch.configs import ARCHS
    >>> st = serve_state_specs(ARCHS["deepseek-7b"], 8, 2048, device="cpu")
    >>> kv_bytes(st) == 30 * 2 * 8 * 2048 * 32 * 128 * 2   # K, V in bf16
    True
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    with mode or FakeTensorMode():
        return init_serve_state(cfg, B, max_len, budget, device=device,
                                sctx=sctx)


def kv_bytes(state) -> int:
    """Bytes the state's cache buffers (K/V, latent/krope) hold, allocated
    whether live or not."""
    return sum(st[n].numel() * st[n].element_size()
               for st in state["layers"] for names in CACHE_KEYS.values()
               for n in names if n in st)


def _top_slot(mass, valid):
    """argmax of the mass over valid slots (first on ties), -1 when none."""
    masked = torch.where(valid, mass, float("-inf"))
    top = masked.argmax(dim=-1).to(torch.int32)
    return torch.where(valid.any(dim=-1), top, -1).to(torch.int32)


def _insert(st, names, rows, pos, window):
    """Write one token's cache rows (``rows[i]`` ``[B, ...]`` into buffer
    ``names[i]``) at its slot, in place: DAC's insert (a miss event) picks
    the slot in the bounded regime, the position is the slot otherwise.
    Returns (the new ctrl, None when unbounded; the valid slots
    ``[B, L]``, the window applied)."""
    if "ctrl" in st:                                       # bounded (DAC)
        ctrl, slot = kvc.insert(st["ctrl"], pos)
        valid = kvc.valid_slots(ctrl)
        slot_pos = ctrl["slot_pos"]
    else:                                                  # unbounded
        ctrl, slot = None, pos
        slot_pos = torch.arange(st[names[0]].shape[1],
                                device=pos.device)[None]
        valid = slot_pos <= pos[:, None]
    bidx = torch.arange(pos.shape[0], device=pos.device)
    for name, row in zip(names, rows):
        st[name][bidx, slot.long()] = row
    if window:
        valid = valid & (slot_pos > pos[:, None] - window)
    return ctrl, valid


def _hit(st, ctrl, mass, valid, eps, k_min, kv_caps):
    """Bounded regime: the top slot of the mass is DAC's hit event, then
    the resize check."""
    if ctrl is not None:
        ctrl = kvc.hit(ctrl, _top_slot(mass, valid))
        st["ctrl"] = kvc.resize(ctrl, eps=eps, k_min=k_min, cap=kv_caps)


def _decode_attn(h, p, st, cfg, spec, pos, impl, loc=None, **dac):
    """One attention layer's decode.  h ``[B, 1, d]`` (normed); writes the
    token's K/V into ``st`` in place; returns ``[B, d]``.  Under a mesh
    (``loc``) the rank's rows and heads, the mass summed over the model
    ranks; the output is the rank's heads' part."""
    q, k, v = attn_qkv(h, p["attn"], cfg, pos[:, None])   # [B, 1, H|Hkv, hd]
    ctrl, valid = _insert(st, ("k", "v"), (k[:, 0], v[:, 0]), pos,
                          spec.window)
    o, mass = attend_decode(q[:, 0], st["k"], st["v"], valid,
                            softcap=cfg.attn_softcap, impl=impl)
    _hit(st, ctrl, mass if loc is None else loc.heads_sum(mass), valid,
         **dac)
    return torch.einsum("bhk,hkd->bd", o, p["attn"]["wo"])


def _decode_mla(h, p, st, cfg, pos, loc=None, **dac):
    """One MLA layer's decode: the token's (latent, k_rope) written into
    the cache, then the absorbed attention (plain torch in both impls).
    Under a mesh (``loc``) on the rank's rows and heads over the whole
    latent cache, the mass summed over the model ranks; the output is the
    rank's heads' part."""
    latent, krope = mla.mla_latent(h, p["attn"], cfg, pos[:, None])
    ctrl, valid = _insert(st, ("latent", "krope"),
                          (latent[:, 0], krope[:, 0, 0]), pos, None)
    out, mass = mla.mla_attend(h, p["attn"], cfg, st["latent"], st["krope"],
                               valid, pos)
    _hit(st, ctrl, mass if loc is None else loc.heads_sum(mass), valid,
         **dac)
    return out


def decode_step(params, cfg: ArchConfig, state, token=None, embed=None,
                eps: float = 0.5, k_min: int = 16, kv_caps=None,
                impl="kernel", sctx=None):
    """One decode step.  token ``[B]`` int (or embed ``[B, d]`` for
    stub-frontend archs).  Returns ``(state, logits [B, V] f32)``; the
    cache buffers and recurrent states of ``state`` are updated in place.

    ``kv_caps`` (``[B]`` int32, optional) caps each sequence's bounded-pool
    growth for this step, the same for every attention and MLA layer;
    ``None`` = uncapped.  With ``sctx``, ``params`` and ``state`` are this
    rank's blocks, ``token`` (or ``embed``) and ``kv_caps`` the whole
    batch's, and the logits the whole batch's on every rank."""
    loc = None
    if sctx is not None:
        loc = local_view(cfg, sctx,
                         (token if token is not None else embed).shape[0])
        if kv_caps is not None:
            kv_caps = loc.rows(kv_caps)
    dac = dict(eps=eps, k_min=k_min, kv_caps=kv_caps)
    pos = state["pos"]
    x = embed_inputs(params, cfg, token, embed, loc)[:, None]   # [B, 1, d]
    for layer, (p, st) in enumerate(zip(params["layers"], state["layers"])):
        spec, ch = layer_spec(cfg, layer), None
        if loc is not None:
            p, ch = loc.layer(layer, p), loc.channels(layer)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if spec.kind == "attn":
            out = _decode_attn(h, p, st, cfg, spec, pos, impl, loc, **dac)
        elif spec.kind == "mla":
            out = _decode_mla(h, p, st, cfg, pos, loc, **dac)
        else:
            if loc is not None:
                h = loc.mixer_in(layer, h)
            out, new = RECURRENT[spec.kind][1](h[:, 0], p[spec.kind], cfg,
                                               st, ch)
            st.update(new)
        if loc is not None:
            out = loc.mixer_out(layer, out)
        x = ffn(x + out[:, None], p, cfg, loc, layer)
    logits = logits_head(params, cfg, x, loc)[:, 0]
    state["pos"] = pos + 1
    return state, logits


def bounded_fill(ctrl, S: int):
    """Replay S insert-only DAC steps (positions 0..S-1) from ``ctrl``.
    Returns ``(ctrl, last)``: the control state after the fill and, per
    sequence and physical slot, the position of the last token written
    there (-1 where none was).

    The reference replays this scan in every attention and MLA layer
    (``_bounded_fill``); the insert law reads no cache data, so every
    layer that starts from the same state follows the same trajectory,
    and the port runs it once.  The slot a token lands in may be
    overwritten by a later token, so each slot takes its *last* writer,
    found with a max-reduction (no scatter with duplicate indices)."""
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
            impl="kernel", sctx=None):
    """Run the prompt through the stack and build the serve state.

    Returns ``(serve_state, last_logits [B, V])``.  ``k0`` (bounded regime
    only) admits each sequence at an active budget below the full pool.
    With ``sctx``, ``params`` are this rank's blocks, ``tokens`` (or
    ``embeds``) the whole batch, the state this rank's block and the
    logits the whole batch's."""
    x = tokens if tokens is not None else embeds
    B, S = x.shape[:2]
    dev = x.device
    max_len = max_len or 2 * S
    logits, caches = forward(params, cfg, tokens=tokens, embeds=embeds,
                             impl=impl, want_cache=True, last_only=True,
                             sctx=sctx)
    state = init_serve_state(cfg, B, max_len, budget, k0, device=dev,
                             sctx=sctx)
    B = state["pos"].shape[0]
    pooled = [st for st in state["layers"] if "ctrl" in st]
    if pooled:
        ctrl, last = bounded_fill(pooled[0]["ctrl"], S)
        bidx = torch.arange(B, device=dev)[:, None]
        src = last.clamp(min=0)
        hold = last >= 0
    for layer, st in enumerate(state["layers"]):
        ca = caches[layer]
        caches[layer] = None                    # free each layer's cache early
        kind = layer_spec(cfg, layer).kind
        if kind in RECURRENT:
            st.update(ca)                       # the state after the prompt
            continue
        for name in CACHE_KEYS[kind]:
            if budget:
                keep = hold.reshape(hold.shape + (1,) * (ca[name].dim() - 2))
                st[name] = torch.where(keep, ca[name][bidx, src], st[name])
            else:
                st[name][:, :S] = ca[name]
        if budget:
            st["ctrl"] = ctrl
    state["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
    return state, logits[:, -1]
