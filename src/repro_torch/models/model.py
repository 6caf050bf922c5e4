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

import functools
import math
from typing import Callable, NamedTuple

import torch

from . import mla, moe, sharding, ssm
from .config import ArchConfig, LayerSpec
from .layers import attn_apply, mlp_apply, rmsnorm

__all__ = ["init_params", "init_params_shape", "forward", "lm_loss",
           "param_count", "layer_spec", "ffn", "param_shapes",
           "REMAT_POLICIES"]


class _Leaf(NamedTuple):
    """One parameter: its shape, its init ``(shape, dtype, generator,
    device) -> tensor``, its dtype (None: the model's) and, for a normal
    draw, its standard deviation (then ``init`` is unused)."""
    shape: tuple
    init: Callable | None
    dtype: torch.dtype | None = None
    std: float | None = None


def _w(shape, fan_in=None, dtype=None):
    """A projection: normal / sqrt(fan_in), the fan in ``shape[0]`` unless
    given (the reference's ``dense_init``)."""
    return _Leaf(tuple(shape), None, dtype,
                 1.0 / math.sqrt(fan_in or shape[0]))


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


def _normal(shape, std, dtype, generator, device, cut=None):
    """normal * std, drawn in f32 and cast: in one draw up to
    ``_DRAW_SLICE`` elements, else one draw per run of leading rows.
    With ``cut`` (a ``sharding.Cut``) only that block of it is kept, cut
    from each draw."""
    def draw(sh):
        return torch.randn(sh, generator=generator, dtype=torch.float32,
                           device=device).mul_(std)

    n = math.prod(shape)
    if n <= _DRAW_SLICE:
        x = draw(shape)
        return _own((x if cut is None else cut(x)).to(dtype))
    out = torch.empty(shape if cut is None else cut.shape, dtype=dtype,
                      device=device)
    first, count = (0, shape[0]) if cut is None else cut.rows
    rows = max(1, _DRAW_SLICE // (n // shape[0]))
    for r0 in range(0, shape[0], rows):
        r1 = min(r0 + rows, shape[0])
        x = draw((r1 - r0,) + shape[1:])
        lo, hi = max(r0, first), min(r1, first + count)
        if lo < hi:
            x = x[lo - r0:hi - r0]
            out[lo - first:hi - first] = x if cut is None else cut.inner(x)
        del x
    return out


def _own(x):
    """``x`` contiguous in a storage of its own size: a rank's cut of a
    larger draw would otherwise keep the whole draw alive."""
    x = x.contiguous()
    if x.untyped_storage().nbytes() != x.numel() * x.element_size():
        x = x.clone()
    return x


def _make(leaf: _Leaf, dt, generator, device, cut=None):
    dt = leaf.dtype or dt
    if leaf.std is not None:
        return _normal(leaf.shape, leaf.std, dt, generator, device, cut)
    x = leaf.init(leaf.shape, dt, generator, device)
    return x if cut is None else _own(cut(x))


def _build(tree, fn, keys=()):
    if isinstance(tree, dict):
        return {k: _build(v, fn, keys + (k,)) for k, v in tree.items()}
    return fn(tree, keys)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda", sctx=None) -> dict:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 when omitted), built on ``device``.  The scheme is
    the reference's (normal / sqrt(fan_in) for projections, 0.02 for the
    embedding, zeros for norms and biases, the recurrent layers' own
    inits); its numbers are torch's, not ``jax.random``'s, so the parity
    tests carry the reference's weights across with
    ``convert.params_from_reference`` instead.  The generator draws the
    embedding, then each layer's leaves in ``_layer_shapes`` order, then
    the head; a leaf past ``_DRAW_SLICE`` elements in slices of rows.

    With ``sctx`` (a :class:`~.sharding.ShardCtx` over a ``DeviceMesh``),
    this rank's blocks under ``param_specs``: what ``sharding.shard_tree``
    cuts from the whole model, built without it (each leaf drawn as for
    the whole model, slice by slice, and the rank's block kept)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = cfg.dtype
    shapes = param_shapes(cfg)
    specs = (None if sctx is None
             else sharding.param_specs(shapes, cfg, sctx))

    def make(leaf, keys):
        cut = None
        if specs is not None:
            spec = specs
            for k in keys:
                spec = spec[k]
            cut = sharding.Cut(spec, leaf.shape, sctx.mesh, keys[-1])
        return _make(leaf, dt, generator, device, cut)

    params = {"embed": make(shapes["embed"], ("embed",))}
    params["layers"] = [_build(layer, make, ("layers", i))
                        for i, layer in enumerate(shapes["layers"])]
    params["final_norm"] = _build(shapes["final_norm"], make,
                                  ("final_norm",))
    if not cfg.tie_embeddings:
        params["lm_head"] = make(shapes["lm_head"], ("lm_head",))
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count of :func:`init_params`.

    ``active_only``: less the routed-expert parameters a token does not
    touch (MoE), the N_active of the 6 N_active D roofline bookkeeping
    (the reference's law).

    >>> from repro_torch.configs import ARCHS
    >>> cfg = ARCHS["mixtral-8x22b"]
    >>> param_count(cfg) > param_count(cfg, active_only=True)
    True
    """
    layers = sum(math.prod(leaf.shape)
                 for layer in range(cfg.n_layers)
                 for leaf in _leaves(_layer_shapes(cfg, layer_spec(cfg,
                                                                   layer))))
    head = 0 if cfg.tie_embeddings else cfg.d_model * cfg.vocab
    n = cfg.vocab * cfg.d_model + layers + cfg.d_model + head
    if active_only and cfg.moe is not None:
        m = cfg.moe
        per_layer = 3 * cfg.d_model * m.d_ff_expert * (m.n_experts - m.top_k)
        n -= per_layer * sum(1 for s in cfg.layer_specs() if s.moe)
    return n


def init_params_shape(cfg: ArchConfig, sctx=None, device="cuda",
                      mode=None) -> dict:
    """:func:`init_params` under a ``FakeTensorMode`` (``mode``, else a new
    one): the parameter tree (with ``sctx``, this rank's blocks of it) as
    fake tensors on ``device``, nothing allocated or drawn.  The generator
    is a CPU one: a fake draw reads none.

    >>> from repro_torch.configs import ARCHS
    >>> init_params_shape(ARCHS["deepseek-7b"], device="cpu")["embed"].shape
    torch.Size([102400, 4096])
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    with mode or FakeTensorMode():
        return init_params(cfg, torch.Generator(), device=device, sctx=sctx)


def param_shapes(cfg: ArchConfig) -> dict:
    """The tree of :func:`init_params` with each leaf's ``_Leaf`` (its
    ``shape``) in place of a tensor: the sharding rules' input at full
    shapes, whatever block of them a rank holds."""
    shapes = {"embed": _Leaf((cfg.vocab, cfg.d_model), None, None, 0.02),
              "layers": [_layer_shapes(cfg, layer_spec(cfg, layer))
                         for layer in range(cfg.n_layers)],
              "final_norm": _norm(cfg.d_model)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = _w((cfg.d_model, cfg.vocab))
    return shapes


def local_view(cfg: ArchConfig, sctx, B: int, train=False):
    """The :class:`~.sharding.Local` view of ``sctx`` for a batch of ``B``
    sequences (``train``: the inputs are each rank's rows)."""
    return sharding.Local(sctx, cfg, B,
                          sharding.param_specs(param_shapes(cfg), cfg, sctx),
                          train)


def layer_spec(cfg: ArchConfig, layer: int) -> LayerSpec:
    return cfg.period[layer % len(cfg.period)]


def embed_inputs(params, cfg: ArchConfig, tokens=None, embeds=None,
                 loc=None):
    """The stack's input ``[B, ..., d]``; under a mesh (``loc``, a
    :class:`~.sharding.Local`) this rank's rows of it (in training the
    inputs are the rank's rows already)."""
    if cfg.embeds_input:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes precomputed embeddings")
        x = embeds.to(cfg.dtype)
        return x if loc is None or loc.train else loc.rows(x)
    if loc is None:
        return params["embed"][tokens]
    return loc.embed(params["embed"], tokens)


def logits_head(params, cfg: ArchConfig, x, loc=None, whole=True):
    """Final norm, head (tied or not) and final softcap; f32 logits.
    Under a mesh (``loc``) ``x`` is this rank's rows and the logits are
    the whole batch's, or with ``whole=False`` this rank's block of them
    (``loc.head``'s rows and vocabulary)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if loc is None:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    else:
        x, head = loc.head(x, params)
    logits = torch.einsum("bsd,dv->bsv", x, head).float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits if loc is None or not whole else loc.logits(logits)


def ffn(x, p, cfg: ArchConfig, loc=None, layer=None):
    """The layer's FFN with its residual: MoE, dense MLP or none.  Under a
    mesh (``loc``) ``p`` is layer ``layer``'s weights from
    ``loc.layer``."""
    if "moe" in p:
        return x + moe.moe_apply(rmsnorm(x, p["ffn_norm"], cfg.norm_eps),
                                 p["moe"], cfg, loc, layer)
    if "mlp" in p:
        def apply(h):
            return mlp_apply(h, p["mlp"], cfg.act)
        h = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
        return x + (apply(h) if loc is None
                    else loc.mlp(loc.ff_axes[layer], h, apply))
    return x


_RECURRENT_APPLY = {"mamba": ssm.mamba_apply, "mlstm": ssm.mlstm_apply,
                    "slstm": ssm.slstm_apply}

# the matmuls that remat "dots" saves; "dots_no_batch" saves those without
# a batch dim (``mm`` / ``addmm``: einsums whose batch dims fold into rows)
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
REMAT_POLICIES = {"none": None, "full": (), "dots": _MM + _BMM,
                  "dots_no_batch": _MM}


def _period(x, layers, first, cfg, positions, impl, want_cache, loc=None):
    """The layers ``first, first + 1, ...`` of the stack (one period): each
    mixer with its residual, then the FFN's.  Returns ``(x, caches)``.
    Under a mesh (``loc``) ``x`` is this rank's rows, and the caches and
    states are its blocks (``loc.mixer_in``'s rows)."""
    caches = []
    for i, p in enumerate(layers):
        spec, ch = layer_spec(cfg, first + i), None
        if loc is not None:
            p, ch = loc.layer(first + i, p), loc.channels(first + i)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if loc is not None:
            h = loc.mixer_in(first + i, h)
        if spec.kind == "attn":
            out = attn_apply(h, p["attn"], cfg, spec, positions, impl=impl,
                             want_cache=want_cache)
        elif spec.kind == "mla":
            out = mla.mla_apply(h, p["attn"], cfg, positions, impl=impl,
                                want_cache=want_cache)
        else:
            out = _RECURRENT_APPLY[spec.kind](h, p[spec.kind], cfg,
                                              return_state=want_cache, ch=ch)
        if want_cache:
            out, cache = out
            caches.append(cache)
        if loc is not None:
            out = loc.mixer_out(first + i, out)
        x = ffn(x + out, p, cfg, loc, first + i)
    return x, caches


def _remat(fn, remat):
    """``fn`` under activation checkpointing (the reference's
    ``jax.checkpoint`` with ``REMAT_POLICIES[remat]``): "full" saves
    nothing and recomputes the period in the backward pass; "dots" and
    "dots_no_batch" save the outputs of their matmuls."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {sorted(REMAT_POLICIES)}, "
                         f"got {remat!r}")
    saved = REMAT_POLICIES[remat]
    if saved is None:
        return fn
    from torch.utils import checkpoint as ckpt

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    kw = {}
    if saved:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def _stack(params, cfg: ArchConfig, x, impl, remat, want_cache, loc):
    """The decoder layers on the stack's input ``x``: ``(x, caches)``."""
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    run = _remat(functools.partial(_period, cfg=cfg, positions=positions,
                                   impl=impl, want_cache=want_cache,
                                   loc=loc), remat)
    layers, plen, caches = params["layers"], len(cfg.period), []
    for first in range(0, len(layers), plen):
        x, period_caches = run(x, layers[first:first + plen], first)
        caches += period_caches
    return x, caches


def forward(params, cfg: ArchConfig, tokens=None, embeds=None, *,
            impl="kernel", remat="none", want_cache=False, last_only=False,
            sctx=None):
    """Run the decoder.

    tokens ``[B, S]`` int (or embeds ``[B, S, d]`` for stub-frontend
    archs).  Returns logits ``[B, S, V]`` f32 and, with ``want_cache``, the
    list of per-layer caches: ``{"k", "v"}`` (``[B, S, Hkv, hd]``) of an
    attention layer, ``{"latent", "krope"}`` of an MLA layer, a recurrent
    layer's state after the prompt.  ``last_only`` computes logits for the
    final position only.  ``impl`` picks kernel B2 (``"kernel"``) or its
    plain version (``"plain"``) for attention and MLA; B2 has no backward,
    so a forward that autograd records takes ``"plain"``.  ``remat``
    checkpoints each period's activations for the backward pass (one of
    ``REMAT_POLICIES``; the default ``"none"`` keeps them).

    With ``sctx`` (a :class:`~.sharding.ShardCtx`), ``params`` are this
    rank's blocks of the parameters (``sharding.shard_tree`` under
    ``param_specs``) and the stack runs sharded over the mesh; every rank
    passes the whole batch and gets the whole batch's logits; its caches
    and states are this rank's blocks.  The collectives are
    differentiable, so autograd and ``remat`` run under a mesh too
    (training takes each rank's rows: :func:`lm_loss`)."""
    loc = None
    if sctx is not None:
        loc = local_view(cfg, sctx,
                         (tokens if tokens is not None else embeds).shape[0])
    x = embed_inputs(params, cfg, tokens, embeds, loc)
    x, caches = _stack(params, cfg, x, impl, remat, want_cache, loc)
    if last_only:
        x = x[:, -1:]
    logits = logits_head(params, cfg, x, loc)
    return (logits, caches) if want_cache else logits


def lm_loss(params, cfg: ArchConfig, batch, *, impl="plain", remat="full",
            sctx=None):
    """Next-token cross-entropy (port of the reference's ``lm_loss``).

    batch: ``{"tokens" | "embeds", "labels", "mask"?}``.  The masked mean of
    the labels' log-probabilities, plus, for an MoE model, 0.01 times the
    mean of :func:`moe.aux_load_balance_loss` over the first period's MoE
    routers, taken on the stack's input (the raw embedding) as the
    reference does.  ``impl`` defaults to the plain attention, the
    reference's ``"jnp"``: kernel B2 has no backward.

    With ``sctx`` (a :class:`~.sharding.ShardCtx`), ``params`` are this
    rank's blocks and ``batch`` is this rank's rows of the global batch
    (split over the ctx's batch axes); the loss is the global one on
    every rank: the masked sums added over the batch axes, then divided
    by the global mask count (not a mean of the ranks' means), and the
    auxiliary term's shares and mean probabilities taken over the whole
    batch.  Its gradients are each rank's parts (``launch.mesh``)."""
    tokens, embeds = batch.get("tokens"), batch.get("embeds")
    loc = None
    if sctx is not None:
        rows = (tokens if tokens is not None else embeds).shape[0]
        loc = local_view(cfg, sctx, rows * sctx._bsz(), train=True)
    x0 = embed_inputs(params, cfg, tokens, embeds, loc)
    x, _ = _stack(params, cfg, x0, impl, remat, False, loc)
    logits = logits_head(params, cfg, x, loc, whole=False)
    labels = batch["labels"]
    if loc is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0] - lse
    else:
        ll = loc.label_logprobs(logits, labels)
    mask = batch.get("mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    total, count = (ll * mask).sum(), mask.sum()
    if loc is not None:
        total = loc.sum(total, loc.b_axes)
        count = loc.sum(count.detach(), loc.b_axes)
    loss = -total / torch.clamp(count, min=1.0)
    if cfg.moe is not None:
        aux = []
        for i, spec in enumerate(cfg.period):
            if not (spec.moe and i < len(params["layers"])
                    and "moe" in params["layers"][i]):
                continue
            router = params["layers"][i]["moe"]["router"]
            if loc is not None:
                rspec = loc.specs["layers"][i]["moe"]["router"]
                router = loc.use(router, rspec, ((),) * router.dim())
            aux.append(moe.aux_load_balance_loss(x0, router, cfg, loc))
        if aux:
            loss = loss + 0.01 * sum(aux) / len(aux)
    return loss
