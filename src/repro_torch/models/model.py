"""Decoder stack (port of ``models/model.py``) for every layer kind of the
repo's configurations: attention (``attn``), multi-head latent attention
(``mla``), and the recurrent ``mamba``, ``mlstm`` and ``slstm``, each with
a dense MLP, an MoE FFN or no FFN, as the layer's spec says.

``init_params(cfg, generator, device)`` builds the parameters;
``forward`` runs the stack for logits or for prefill (logits + per-layer
caches).  The reference stacks each period's parameters along a leading
``n_periods`` axis and scans; the port keeps one dict per layer in
``params["layers"]`` (layer ``l`` is period ``l // len(period)``, slot
``l % len(period)`` of the reference's stack; ``convert.py`` maps the
two) and runs a Python loop, so a stack cut to any depth runs, whole
periods or not.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import mla, moe, ssm
from .config import ArchConfig, LayerSpec
from .layers import attn_apply, mlp_apply, rmsnorm

__all__ = ["init_params", "forward", "param_count", "layer_spec", "ffn"]


class _Leaf(NamedTuple):
    """One parameter: its shape, its init ``(shape, dtype, generator,
    device) -> tensor`` and its dtype (None: the model's)."""
    shape: tuple
    init: Callable
    dtype: torch.dtype | None = None


def _w(shape, fan_in=None, dtype=None):
    """A projection: normal / sqrt(fan_in), the fan in ``shape[0]`` unless
    given (the reference's ``dense_init``)."""
    std = 1.0 / math.sqrt(fan_in or shape[0])
    return _Leaf(tuple(shape),
                 lambda sh, dt, g, dev: _normal(sh, std, dt, g, dev), dtype)


def _full(value, *shape, dtype=None):
    return _Leaf(tuple(shape), lambda sh, dt, g, dev: torch.full(
        sh, value, dtype=dt, device=dev), dtype)


def _zeros(*shape, dtype=None):
    return _full(0.0, *shape, dtype=dtype)


def _norm(d):
    return {"scale": _zeros(d)}


def _mlp(d, ff):
    return {"w_gate": _w((d, ff)), "w_up": _w((d, ff)),
            "w_down": _w((ff, d))}


F32 = torch.float32


def _attn_shapes(cfg):
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": _w((d, H, hd)), "wk": _w((d, Hkv, hd)),
            "wv": _w((d, Hkv, hd)), "wo": _w((H, hd, d), H * hd)}
    if cfg.qkv_bias:
        attn.update(bq=_zeros(H, hd), bk=_zeros(Hkv, hd),
                    bv=_zeros(Hkv, hd))
    return attn


def _mla_shapes(cfg):
    d, H = cfg.d_model, cfg.n_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    p = {"w_kva": _w((d, r + dr)), "kv_norm": _norm(r),
         "w_kvb": _w((r, H, dn + dv)), "wo": _w((H, dv, d), H * dv)}
    if qr:
        p.update(w_qa=_w((d, qr)), q_norm=_norm(qr),
                 w_qb=_w((qr, H, dn + dr)))
    else:
        p["w_q"] = _w((d, H, dn + dr))
    return p


def _dt_bias(shape, dtype, generator, device):
    """softplus(dt_bias) spans [1e-3, 1e-1] (the Mamba paper)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    dt_ = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt_ + torch.log(-torch.expm1(-dt_))              # inverse softplus


def _a_log(shape, dtype, generator, device):
    """A = -exp(A_log) = -[1 .. d_state] in every channel."""
    di, ds = shape
    a = torch.arange(1, ds + 1, dtype=dtype, device=device)
    return torch.log(a).expand(di, ds).contiguous()


def _mamba_shapes(cfg):
    ms, di, dtr = ssm.mamba_dims(cfg)
    d, ds = cfg.d_model, ms.d_state
    return {"in_proj": _w((d, 2 * di)), "conv_w": _w((ms.d_conv, di)),
            "conv_b": _zeros(di), "x_proj": _w((di, dtr + 2 * ds)),
            "dt_w": _w((dtr, di)), "dt_b": _Leaf((di,), _dt_bias, F32),
            "A_log": _Leaf((di, ds), _a_log, F32),
            "D": _full(1.0, di, dtype=F32),
            "out_proj": _w((di, d))}


def _mlstm_shapes(cfg):
    xs, d, H = cfg.xlstm, cfg.d_model, cfg.n_heads
    di, _ = ssm.mlstm_dims(cfg)
    return {"up_proj": _w((d, 2 * di)), "conv_w": _w((xs.m_conv, di)),
            "conv_b": _zeros(di), "wq": _w((di, di)), "wk": _w((di, di)),
            "wv": _w((di, di)), "w_i": _w((di, H), dtype=F32),
            "b_i": _zeros(H, dtype=F32), "w_f": _w((di, H), dtype=F32),
            # forget bias starts positive: gates start mostly-remember
            "b_f": _full(3.0, H, dtype=F32),
            "skip": _full(1.0, di), "gn": _norm(di),
            "down_proj": _w((di, d))}


def _slstm_b(shape, dtype, generator, device):
    """Gate biases in the order (z, i, f, o): the forget gate's 3.0, the
    rest 0."""
    d = shape[0] // 4
    kw = dict(dtype=dtype, device=device)
    return torch.cat([torch.zeros(2 * d, **kw), torch.full((d,), 3.0, **kw),
                      torch.zeros(d, **kw)])


def _slstm_shapes(cfg):
    xs, d, H = cfg.xlstm, cfg.d_model, cfg.n_heads
    dh = d // H
    return {"conv_w": _w((xs.s_conv, d)), "conv_b": _zeros(d),
            "W": _w((d, 4 * d)), "R": _w((H, dh, 4 * dh), dh, dtype=F32),
            "b": _Leaf((4 * d,), _slstm_b, F32), "gn": _norm(d),
            "ffn": _mlp(d, ssm.slstm_ffn_width(cfg)), "ffn_norm": _norm(d)}


def _moe_shapes(cfg):
    d, m = cfg.d_model, cfg.moe
    E, ff = m.n_experts, m.d_ff_expert
    # the reference's dense_init takes shape[0] (E) as the experts' fan in
    p = {"router": _w((d, E), dtype=F32), "w_gate": _w((E, d, ff)),
         "w_up": _w((E, d, ff)), "w_down": _w((E, ff, d), ff)}
    if m.n_shared:
        p["shared"] = _mlp(d, m.n_shared * ff)
    return p


_MIXER_SHAPES = {"attn": ("attn", _attn_shapes), "mla": ("attn", _mla_shapes),
                 "mamba": ("mamba", _mamba_shapes),
                 "mlstm": ("mlstm", _mlstm_shapes),
                 "slstm": ("slstm", _slstm_shapes)}


def _layer_shapes(cfg: ArchConfig, spec: LayerSpec):
    """The nested ``_Leaf`` dict of one layer, in the reference's layout
    (``_layer_init``): norms, the mixer under ``attn`` (attention and MLA)
    or its kind, then the FFN (``moe`` or ``mlp``) for attn, mla and
    mamba layers."""
    group, shapes = _MIXER_SHAPES[spec.kind]
    p = {"attn_norm": _norm(cfg.d_model), group: shapes(cfg)}
    if spec.kind in ("attn", "mla", "mamba"):
        if spec.moe and cfg.moe:
            p["ffn_norm"] = _norm(cfg.d_model)
            p["moe"] = _moe_shapes(cfg)
        elif cfg.d_ff:
            p["ffn_norm"] = _norm(cfg.d_model)
            p["mlp"] = _mlp(cfg.d_model, cfg.d_ff)
    return p


# a normal draw above this many elements is made in slices along dim 0,
# so that its f32 temporary stays small (one [160, 5120, 1536] expert
# stack would be 5 GB of f32 in one draw)
_DRAW_SLICE = 1 << 29


def _normal(shape, std, dtype, generator, device):
    """normal * std, drawn in f32 and cast: in one draw up to
    ``_DRAW_SLICE`` elements, else one draw per run of leading rows."""
    n = math.prod(shape)
    if n <= _DRAW_SLICE:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, _DRAW_SLICE // (n // shape[0]))
    for r0 in range(0, shape[0], rows):
        out[r0:r0 + rows] = _normal((min(rows, shape[0] - r0),) + shape[1:],
                                    std, dtype, generator, device)
    return out


def _make(leaf: _Leaf, dt, generator, device):
    return leaf.init(leaf.shape, leaf.dtype or dt, generator, device)


def _build(tree, fn):
    if isinstance(tree, dict):
        return {k: _build(v, fn) for k, v in tree.items()}
    return fn(tree)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted), built on ``device``.  The scheme is
    the reference's (normal / sqrt(fan_in) for projections, 0.02 for the
    embedding, zeros for norms and biases, the recurrent layers' own
    inits); its numbers are torch's, not ``jax.random``'s, so the parity
    tests carry the reference's weights across with
    ``convert.params_from_reference`` instead.  The generator draws the
    embedding, then each layer's leaves in ``_layer_shapes`` order, then
    the head; a leaf past ``_DRAW_SLICE`` elements in slices of rows."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = cfg.dtype

    def make(leaf):
        return _make(leaf, dt, generator, device)

    params = {"embed": _normal((cfg.vocab, cfg.d_model), 0.02, dt, generator,
                               device)}
    params["layers"] = [_build(_layer_shapes(cfg, layer_spec(cfg, layer)),
                               make) for layer in range(cfg.n_layers)]
    params["final_norm"] = {"scale": torch.zeros(cfg.d_model, dtype=dt,
                                                 device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = make(_w((cfg.d_model, cfg.vocab)))
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count of :func:`init_params`."""
    layers = sum(math.prod(leaf.shape)
                 for layer in range(cfg.n_layers)
                 for leaf in _leaves(_layer_shapes(cfg, layer_spec(cfg,
                                                                   layer))))
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab
    return cfg.vocab * cfg.d_model + layers + cfg.d_model + head


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


def ffn(x, p, cfg: ArchConfig):
    """The layer's FFN with its residual: MoE, dense MLP or none."""
    if "moe" in p:
        return x + moe.moe_apply(rmsnorm(x, p["ffn_norm"], cfg.norm_eps),
                                 p["moe"], cfg)
    if "mlp" in p:
        return x + mlp_apply(rmsnorm(x, p["ffn_norm"], cfg.norm_eps),
                             p["mlp"], cfg.act)
    return x


_RECURRENT_APPLY = {"mamba": ssm.mamba_apply, "mlstm": ssm.mlstm_apply,
                    "slstm": ssm.slstm_apply}


def forward(params, cfg: ArchConfig, tokens=None, embeds=None, *,
            impl="kernel", want_cache=False, last_only=False):
    """Run the decoder.

    tokens ``[B, S]`` int (or embeds ``[B, S, d]`` for stub-frontend
    archs).  Returns logits ``[B, S, V]`` f32 and, with ``want_cache``, the
    list of per-layer caches: ``{"k", "v"}`` (``[B, S, Hkv, hd]``) of an
    attention layer, ``{"latent", "krope"}`` of an MLA layer, a recurrent
    layer's state after the prompt.  ``last_only`` computes logits for the
    final position only.  ``impl`` picks kernel B2 (``"kernel"``) or its
    plain version (``"plain"``) for attention and MLA."""
    x = embed_inputs(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    caches = []
    for layer, p in enumerate(params["layers"]):
        spec = layer_spec(cfg, layer)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if spec.kind == "attn":
            out = attn_apply(h, p["attn"], cfg, spec, positions, impl=impl,
                             want_cache=want_cache)
        elif spec.kind == "mla":
            out = mla.mla_apply(h, p["attn"], cfg, positions, impl=impl,
                                want_cache=want_cache)
        else:
            out = _RECURRENT_APPLY[spec.kind](h, p[spec.kind], cfg,
                                              return_state=want_cache)
        if want_cache:
            out, cache = out
            caches.append(cache)
        x = ffn(x + out, p, cfg)
    if last_only:
        x = x[:, -1:]
    logits = logits_head(params, cfg, x)
    return (logits, caches) if want_cache else logits
