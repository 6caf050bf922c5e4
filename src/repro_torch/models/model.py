"""Decoder stack (port of ``models/model.py``) for attention layers with a
dense MLP.

``init_params(cfg, generator, device)`` builds the parameters;
``forward`` runs the stack for logits or for prefill (logits + per-layer
K/V).  The reference stacks each period's parameters along a leading
``n_periods`` axis and scans; the port keeps one dict per layer in
``params["layers"]`` (layer ``l`` is period ``l // len(period)``, slot
``l % len(period)`` of the reference's stack; ``convert.py`` maps the
two) and runs a Python loop.

Layer kinds ``mla``, ``mamba``, ``mlstm``, ``slstm`` and MoE FFNs are not
ported yet (ROADMAP A12) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from .config import ArchConfig, LayerSpec
from .layers import attn_apply, mlp_apply, rmsnorm

__all__ = ["init_params", "forward", "param_count", "check_supported"]


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless every layer is ``attn`` with a dense (or no) FFN."""
    for spec in cfg.period:
        if spec.kind != "attn" or (spec.moe and cfg.moe):
            raise NotImplementedError(
                f"{cfg.name}: layer kind {spec.kind!r}"
                f"{' with an MoE FFN' if spec.moe and cfg.moe else ''} is "
                f"not ported yet (ROADMAP A12: MLA, MoE, SSM and xLSTM "
                f"layers)")


def _layer_shapes(cfg: ArchConfig):
    """``{group: {name: (shape, fan_in or None for zeros)}}`` of one
    attention layer, in the reference's layout."""
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": ((d, H, hd), d), "wk": ((d, Hkv, hd), d),
            "wv": ((d, Hkv, hd), d), "wo": ((H, hd, d), H * hd)}
    if cfg.qkv_bias:
        attn.update(bq=((H, hd), None), bk=((Hkv, hd), None),
                    bv=((Hkv, hd), None))
    shapes = {"attn_norm": {"scale": ((d,), None)}, "attn": attn}
    if cfg.d_ff:
        ff = cfg.d_ff
        shapes["ffn_norm"] = {"scale": ((d,), None)}
        shapes["mlp"] = {"w_gate": ((d, ff), d), "w_up": ((d, ff), d),
                         "w_down": ((ff, d), ff)}
    return shapes


def _normal(shape, std, dtype, generator, device):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted), built on ``device``.  The scheme is
    the reference's (normal / sqrt(fan_in) for projections, 0.02 for the
    embedding, zeros for norms and biases); its numbers are torch's, not
    ``jax.random``'s, so the parity tests carry the reference's weights
    across with ``convert.params_from_reference`` instead."""
    check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = cfg.dtype

    def make(shape, fan_in):
        if fan_in is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return _normal(shape, 1.0 / math.sqrt(fan_in), dt, generator, device)

    params = {"embed": _normal((cfg.vocab, cfg.d_model), 0.02, dt, generator,
                               device)}
    params["layers"] = [
        {grp: {n: make(*sf) for n, sf in names.items()}
         for grp, names in _layer_shapes(cfg).items()}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = {"scale": torch.zeros(cfg.d_model, dtype=dt,
                                                 device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = make((cfg.d_model, cfg.vocab), cfg.d_model)
    return params


def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count of :func:`init_params`."""
    check_supported(cfg)
    per_layer = sum(math.prod(shape) for names in _layer_shapes(cfg).values()
                    for shape, _ in names.values())
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab
    return (cfg.vocab * cfg.d_model + cfg.n_layers * per_layer
            + cfg.d_model + head)


def layer_spec(cfg: ArchConfig, layer: int) -> LayerSpec:
    return cfg.period[layer % len(cfg.period)]


def embed_inputs(params, cfg: ArchConfig, tokens=None, embeds=None):
    if cfg.embeds_input:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes precomputed embeddings")
        return embeds.to(cfg.dtype)
    return params["embed"][tokens]


def logits_head(params, cfg: ArchConfig, x):
    """Final norm, head (tied or not) and final softcap; f32 logits."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, head).float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def forward(params, cfg: ArchConfig, tokens=None, embeds=None, *,
            impl="kernel", want_cache=False, last_only=False):
    """Run the decoder.

    tokens ``[B, S]`` int (or embeds ``[B, S, d]`` for stub-frontend
    archs).  Returns logits ``[B, S, V]`` f32 and, with ``want_cache``, the
    list of per-layer ``{"k", "v"}`` (``[B, S, Hkv, hd]``).  ``last_only``
    computes logits for the final position only.  ``impl`` picks kernel B2
    (``"kernel"``) or its plain version (``"plain"``) for attention."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                              device=x.device).expand(B, S)
    caches = []
    for layer, p in enumerate(params["layers"]):
        spec = layer_spec(cfg, layer)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        att = attn_apply(h, p["attn"], cfg, spec, positions, impl=impl,
                         want_cache=want_cache)
        if want_cache:
            att, cache = att
            caches.append(cache)
        x = x + att
        if "mlp" in p:
            h = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
            x = x + mlp_apply(h, p["mlp"], cfg.act)
    if last_only:
        x = x[:, -1:]
    logits = logits_head(params, cfg, x)
    return (logits, caches) if want_cache else logits
