"""Core transformer layers (port of ``models/layers.py``), plain torch.

Parameters are plain dicts of tensors in the reference's layouts
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``w_gate [d, ff]``), so the parity
tests compare like with like.  The large products go to ``torch.einsum``,
as the reference leaves them to XLA.

Attention runs through the port's kernels: :func:`attn_apply` (and the
prefill in :mod:`.model`) calls kernel B2, ``kernels.flash_attention``,
where the reference runs ``chunked_attention``; the serve step calls
kernel B3, ``kernels.decode_attention``.  Their plain versions are
:func:`attention_dense` and :func:`decode_attention_plain`, the
reference's ``attention_dense`` and ``decode_attention`` in torch.
``impl="plain"`` selects them on any device (the on-card comparison of
the kernels against their plain versions); the default, ``"kernel"``,
calls the wrappers, which run the plain versions only on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import (decode_attention,
                                        decode_attention_plain)
from ..kernels.flash_attention import attention_dense, flash_attention

__all__ = ["rmsnorm", "rope_freqs", "apply_rope", "attend_prefill",
           "attend_decode", "attn_qkv", "attn_apply", "mlp_apply"]

IMPLS = ("kernel", "plain")


def rmsnorm(x, p, eps=1e-6):
    """RMS norm in f32 with a ``1 + scale`` gain, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].float())).to(dt)


def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta):
    """x ``[..., S, H, D]`` (D even), positions ``[..., S]`` int; rotates
    the split halves in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    ang = positions[..., None].float() * freqs               # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def attend_prefill(q, k, v, *, window=None, softcap=0.0, impl="kernel"):
    """Causal self-attention of a prompt: kernel B2 or its plain version."""
    _check_impl(impl)
    fn = flash_attention if impl == "kernel" else attention_dense
    return fn(q, k, v, causal=True, window=window, softcap=softcap)


def attend_decode(q, k_cache, v_cache, valid, *, softcap=0.0,
                  impl="kernel"):
    """One-token attention over a slot table, with the per-slot mass:
    kernel B3 or its plain version."""
    _check_impl(impl)
    fn = decode_attention if impl == "kernel" else decode_attention_plain
    return fn(q, k_cache, v_cache, valid, softcap=softcap)


def attn_qkv(x, p, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(x, p, cfg, spec, positions, impl="kernel", want_cache=False):
    """Full-sequence (prefill) attention block body.  Returns the block's
    output and, with ``want_cache``, ``{"k", "v"}`` for the serve state."""
    q, k, v = attn_qkv(x, p, cfg, positions)
    o = attend_prefill(q, k, v, window=spec.window, softcap=cfg.attn_softcap,
                       impl=impl)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return (out, {"k": k, "v": v}) if want_cache else out


def mlp_apply(x, p, act="silu"):
    """Gated MLP; ``gelu`` is the tanh form, as ``jax.nn.gelu``'s default."""
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", a * u, p["w_down"])
