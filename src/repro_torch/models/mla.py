"""Multi-head Latent Attention, DeepSeek-V2 (port of ``models/mla.py``).

KV is compressed into a per-token latent ``c_kv`` of rank
``kv_lora_rank`` plus one shared rotary key ``k_rope`` of dim
``qk_rope_head_dim``; per-head keys and values are up-projected from the
latent.  The decode path caches only (latent, k_rope), ``(512 + 64)``
values a token instead of ``2 * H * head_dim``, and attends in the
*absorbed* form (q projected into latent space through ``w_kb``), never
materialising per-head K/V.  Queries optionally go through a
rank-``q_lora_rank`` bottleneck (the 236B config).

The prefill materialises per-head K = ``[k_nope | k_rope]`` (D = dn + dr)
and V (Dv = dv) and runs them through kernel B2 (``layers.attend_prefill``)
where the reference runs ``chunked_attention``.  The absorbed decode
(:func:`mla_attend`) is plain torch, as the reference's is jnp: as one
attention it is H query heads over a single shared head of D = r + dr and
Dv = r, past what kernel B3 takes (D, Dv <= 256).

Both run on the heads of the weights they are given: under a mesh a
rank's block of ``w_q``/``w_qb``, ``w_kvb`` and ``wo`` (heads over
``model``), with the latent and ``k_rope`` whole.  The caller sums the
output projection and the per-slot mass over the model ranks.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import NEG_INF
from .layers import apply_rope, attend_prefill, rmsnorm

__all__ = ["mla_latent", "mla_apply", "mla_attend", "absorbed_attention"]


def _queries(x, p, cfg, positions):
    """x ``[B, S, d]`` -> (q_nope ``[B, S, H, dn]``, q_rope ``[B, S, H, dr]``
    rotated)."""
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        qa = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["w_qa"]), p["q_norm"],
                     cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", qa, p["w_qb"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["w_q"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_latent(x, p, cfg, positions):
    """x -> (latent ``[B, S, r]``, k_rope ``[B, S, 1, dr]``): the KV cache."""
    r = cfg.kv_lora_rank
    kva = torch.einsum("bsd,dr->bsr", x, p["w_kva"])
    latent = rmsnorm(kva[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kva[..., None, r:], positions, cfg.rope_theta)
    return latent, k_rope


def mla_apply(x, p, cfg, positions, impl="kernel", want_cache=False):
    """Full-sequence MLA (prefill): per-head K/V materialised from the
    latent, causal attention through kernel B2 at its default scale
    ``1/sqrt(D)``, which is the reference's ``1/sqrt(dn + dr)`` since q is
    ``[q_nope | q_rope]``.  Returns the block's output and, with
    ``want_cache``, ``{"latent" [B, S, r], "krope" [B, S, dr]}``."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _queries(x, p, cfg, positions)
    H = q_nope.shape[2]                     # the heads of p (a rank's own)
    latent, k_rope = mla_latent(x, p, cfg, positions)
    kvb = torch.einsum("bsr,rhk->bshk", latent, p["w_kvb"])
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    del q_nope, q_rope, k_nope, kvb
    o = attend_prefill(q, k, v, impl=impl)
    del q, k, v
    out = torch.einsum("bshv,hvd->bsd", o, p["wo"])
    if want_cache:
        return out, {"latent": latent, "krope": k_rope[:, :, 0]}
    return out


def mla_attend(x, p, cfg, latent_cache, krope_cache, valid, position):
    """Absorbed-form single-token decode attention.

    x ``[B, 1, d]`` (the normed block input); latent_cache ``[B, L, r]``;
    krope_cache ``[B, L, dr]``; valid ``[B, L]`` bool; position ``[B]``.
    The caller writes the new token's (latent, k_rope) into the cache
    before attending, so the token sees itself.  Returns (out ``[B, d]``,
    per-slot attention mass ``[B, L]``, the mean over heads: DAC's hit
    signal).  The casts are the reference's: the scores in q's dtype, the
    softmax and ``o_lat`` in f32, ``o_lat`` back to x's dtype before
    ``w_vb``."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _queries(x, p, cfg, position[:, None])  # [B, 1, H, *]
    w_kb = p["w_kvb"][..., :dn]                             # [r, H, dn]
    w_vb = p["w_kvb"][..., dn:]                             # [r, H, dv]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_kb)    # [B, 1, H, r]
    pr, o_lat = absorbed_attention(q_lat, q_rope, latent_cache, krope_cache,
                                   valid, 1.0 / math.sqrt(dn + dr))
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), w_vb)
    out = torch.einsum("bhv,hvd->bd", o, p["wo"])
    return out, pr.mean(dim=1)


def absorbed_attention(q_lat, q_rope, latent_cache, krope_cache, valid,
                       scale):
    """The attention inside :func:`mla_attend` (the reference's
    ``decode_attention_jnp`` scope): the scores over the latent and rotary
    caches, the softmax over the ``valid`` slots and the latent output.
    Returns (probabilities ``[B, H, L]`` f32, ``o_lat`` ``[B, H, r]``
    f32)."""
    s = torch.einsum("bshr,btr->bhst", q_lat, latent_cache.to(q_lat.dtype))
    s = s + torch.einsum("bshk,btk->bhst", q_rope,
                         krope_cache.to(q_rope.dtype))
    s = (s.float() * scale)[:, :, 0]                        # [B, H, L]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    return pr, torch.einsum("bhs,bsr->bhr", pr, latent_cache.float())
