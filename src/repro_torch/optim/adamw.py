"""AdamW with cosine schedule, global-norm clipping, and optional 8-bit
block-quantized moments (port of ``optim/adamw.py``).

Pure functions on tensors: ``init(params, cfg) -> state`` and
``update(grads, state, params, cfg) -> (params, state, stats)``, the step
count a 0-dim int32 tensor on the parameters' device.  ``update`` writes
the new parameters into the given tensors under ``torch.no_grad()`` and
returns the same tree.

A leaf of ``params`` (and of ``grads``) is a tensor or a list of tensors
of one shape: the slices ``[0], [1], ...`` of one stacked leaf, as
``models.convert.stacked_view`` gives the port's per-layer parameters in
the reference's period-stacked layout.  The moments keep that stacked
layout.  It matters for int8 moments: the reference quantizes each of its
leaves in blocks of ``BLOCK`` elements along its flattening, and where one
layer's slice is not a multiple of ``BLOCK`` elements a block straddles two
layers, so quantizing each layer alone would give other ``q`` and
``scale``.

The moment quantization is symmetric blockwise (block 64 along the
flattened leaf) with f32 scales; the second moment is quantized in the
sqrt domain (``quantize(..., sqrt_domain=True)``).

Under a mesh (``place``: a tree of ``models.sharding.Cut`` in the
parameters' stacked structure, one for each leaf's whole shape and
placement) the parameters, gradients and moments are this rank's blocks,
the moments' blocks following their parameters' placement.  The global
norm adds each leaf's squares over the axes it splits over, counting a
copy held whole on several ranks once, so that the clip scale is the same
on every rank and the unsharded one.  An int8 moment is the whole leaf's
quantization in blocks along its flattening: where the rank's elements
make runs of whole blocks (``Cut.run``), the block's own; elsewhere the
leaf is updated whole on every rank (its gradient and parameter
gathered) and its moments held whole, since quantizing the block alone
would give other ``q`` and ``scale``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["BLOCK", "AdamWConfig", "schedule", "quantize", "dequantize",
           "init", "global_norm", "update", "whole_state", "cut_state"]

BLOCK = 64


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # float32 | int8


def schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine down to ``min_lr_frac * lr``; f32, in
    the reference's order of operations."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


# --- blockwise int8 moment quantization ------------------------------------

def _sqrt(x):
    """f32 ``sqrt`` correctly rounded on every device.  CUDA's ``sqrtf`` is
    IEEE; torch's vectorised CPU ``sqrt`` (the AVX-512 one) can be one ulp
    off, so a CPU tensor takes it in f64 and rounds once back to f32, which
    is exact: the f64 root of an f32 rounds to the f32 root."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def quantize(x, sqrt_domain: bool = False):
    """f32 tensor -> ``{"q": int8 [blocks, BLOCK], "scale": f32 [blocks]}``
    over its flattening, zero-padded to whole blocks.

    ``sqrt_domain=True`` quantizes ``sqrt(x)`` (x >= 0), as for the second
    moment, whose quadratic range would otherwise round small-|g| elements
    to v = 0 while their m survives.  The square root is correctly rounded
    (:func:`_sqrt`), as XLA's is, so that the scales are the reference's
    bit for bit on any host."""
    flat = x.reshape(-1)
    if sqrt_domain:
        flat = _sqrt(torch.clamp(flat, min=0.0))
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % BLOCK))
    flat = flat.reshape(-1, BLOCK)
    # the divisor on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which can round otherwise
    scale = flat.abs().amax(dim=1) / torch.full(
        (), 127.0, dtype=torch.float32, device=flat.device)
    q = torch.round(flat / torch.clamp(scale[:, None], min=1e-20))
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize(qd, shape, sqrt_domain: bool = False):
    flat = qd["q"].float() * qd["scale"][:, None]
    if sqrt_domain:
        flat = flat.square()
    return flat.reshape(-1)[:math.prod(shape)].reshape(shape)


def _wrap_moment(x, dtype, sqrt_domain=False):
    return quantize(x, sqrt_domain) if dtype == "int8" else x


def _unwrap_moment(m, shape, dtype, sqrt_domain=False):
    return dequantize(m, shape, sqrt_domain) if dtype == "int8" else m


# --- trees -------------------------------------------------------------------

def _map(fn, *trees):
    """``fn`` over the leaves of ``trees`` (nested dicts of one structure;
    a leaf is a tensor, a list of slices, or an int8 moment's dict)."""
    first = trees[0]
    if isinstance(first, dict) and set(first) != {"q", "scale"}:
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _shape(p):
    """The stacked shape of a leaf (``[n_slices, ...]`` for slices)."""
    if isinstance(p, list):
        return (len(p),) + tuple(p[0].shape)
    return tuple(p.shape)


def _device(p):
    return (p[0] if isinstance(p, list) else p).device


def _stacked(p):
    return torch.stack(p) if isinstance(p, list) else p


def _cut_of(pl):
    """The leaf's ``Cut`` (a list leaf's slices share one), or None."""
    return pl[0] if isinstance(pl, list) else pl


def _lead(p):
    """The leading dimensions a leaf's stack adds before the layer's."""
    return 1 if isinstance(p, list) else 0


def _local_moments(cut, dtype) -> bool:
    """Whether a leaf's moments are its block's (else whole: int8 where
    the rank's runs are not whole quantization blocks)."""
    return (cut is None or dtype != "int8" or not cut.axes
            or cut.run % BLOCK == 0)


# --- optimizer --------------------------------------------------------------

def _moment_shape(p, pl, dtype):
    cut = _cut_of(pl)
    if _local_moments(cut, dtype):
        return _shape(p)
    return _shape(p)[:_lead(p)] + cut.full


def init(params, cfg: AdamWConfig, place=None):
    """Zero moments (f32, or int8's ``{"q", "scale"}``) and step 0; under
    a mesh (``place``) each leaf's block's, or its whole leaf's (see the
    module's docstring)."""
    def zero_like(p, pl=None):
        z = torch.zeros(_moment_shape(p, pl, cfg.moment_dtype),
                        dtype=torch.float32, device=_device(p))
        return _wrap_moment(z, cfg.moment_dtype)

    first = next(_leaves(params))
    trees = (params,) if place is None else (params, place)
    return {"m": _map(zero_like, *trees), "v": _map(zero_like, *trees),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(first))}


def global_norm(tree, place=None):
    """sqrt of the sum of squares of every element, in f32 (a list leaf
    counts each slice).  Under a mesh (``place``) each leaf's sum is
    added over the axes the leaf splits over, the leaves grouped by
    those axes (one sum a group), in the same order on every rank."""
    sq, groups, pairs = [], {}, []
    if place is None:
        pairs = [(leaf, None) for leaf in _leaves(tree)]
    else:                               # paired by key, not by order
        _map(lambda leaf, pl: pairs.append((leaf, pl)), tree, place)
    for leaf, pl in pairs:
        part = [x.float().square().sum()
                for x in (leaf if isinstance(leaf, list) else [leaf])]
        if pl is None:
            sq += part
        else:
            groups.setdefault(_cut_of(pl).axes, []).append(
                torch.stack(part).sum())
    if place is None:
        return _sqrt(torch.stack(sq).sum())
    from ..launch.mesh import seq_sum
    mesh = _cut_of(next(_leaves(place))).mesh
    total = [seq_sum(torch.stack(parts).sum(), mesh, axes)
             for axes, parts in groups.items()]
    return _sqrt(torch.stack(total).sum())


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, place=None):
    """One AdamW step: writes the new values into ``params``' tensors and
    returns ``(params, new_state, {"lr", "grad_norm"})``.  Under a mesh
    (``place``) each rank passes its blocks and its leaves' whole
    gradients' blocks (every replica's parts added)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, place)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.clip_norm else 1.0

    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    def leaf(p, g, m, v, pl=None):
        cut, lead = _cut_of(pl), _lead(p)
        whole = not _local_moments(cut, cfg.moment_dtype)
        pf = _stacked(p).float()
        g = _stacked(g).float() * scale
        if whole:                       # gathered, updated on every rank
            pf, g = cut.whole(pf, lead), cut.whole(g, lead)
        shape = tuple(pf.shape)
        m_f = _unwrap_moment(m, shape, cfg.moment_dtype)
        v_f = _unwrap_moment(v, shape, cfg.moment_dtype, sqrt_domain=True)
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g.square()
        del g
        upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * pf
        new_p = pf - lr * upd
        del upd, pf
        if whole:
            new_p = cut.cut(new_p, lead)
        if isinstance(p, list):
            for dst, src in zip(p, new_p):
                dst.copy_(src)
        else:
            p.copy_(new_p)
        return (_wrap_moment(m_f, cfg.moment_dtype),
                _wrap_moment(v_f, cfg.moment_dtype, sqrt_domain=True))

    trees = (params, grads, state["m"], state["v"])
    out = _map(leaf, *(trees if place is None else trees + (place,)))
    new_m = _map(lambda pair: pair[0], out)
    new_v = _map(lambda pair: pair[1], out)
    return params, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


# --- a rank's state and the whole one ----------------------------------------

def _moment_whole(m, cut, shape, lead, dtype):
    """A moment from a rank's block (every rank runs it)."""
    if not _local_moments(cut, dtype) or not cut.axes:
        return m
    if dtype != "int8":
        return cut.whole(m, lead)
    # each of the block's quantization blocks lies whole in one of the
    # leaf's: gather q by its elements, the scales one an element
    q = cut.whole(m["q"].reshape(shape), lead).reshape(-1, BLOCK)
    per = m["scale"].repeat_interleave(BLOCK).reshape(shape)
    return {"q": q, "scale": cut.whole(per, lead).reshape(-1, BLOCK)[:, 0]
            .contiguous()}


def _moment_cut(m, cut, shape, lead, dtype):
    """A rank's block of a whole moment (``shape``: the whole stacked
    leaf's)."""
    if not _local_moments(cut, dtype) or not cut.axes:
        return m
    if dtype != "int8":
        return cut.cut(m, lead).contiguous()
    q = cut.cut(m["q"].reshape(shape), lead).reshape(-1, BLOCK)
    per = m["scale"].repeat_interleave(BLOCK).reshape(shape)
    return {"q": q.contiguous(),
            "scale": cut.cut(per, lead).reshape(-1, BLOCK)[:, 0]
            .contiguous()}


def whole_state(state, params, place, cfg: AdamWConfig):
    """The optimizer state of the whole model (the unsharded layout, as a
    checkpoint holds it) from this rank's (``init(params, cfg, place)``'s
    layout; ``params`` this rank's blocks, for the shapes).  Every rank
    runs it: it gathers over the mesh."""
    def leaf(p, m, v, pl):
        cut, lead = _cut_of(pl), _lead(p)
        shape = _shape(p)
        return tuple(_moment_whole(x, cut, shape, lead, cfg.moment_dtype)
                     for x in (m, v))

    out = _map(leaf, params, state["m"], state["v"], place)
    return {"m": _map(lambda pair: pair[0], out),
            "v": _map(lambda pair: pair[1], out), "step": state["step"]}


def cut_state(state, params, place, cfg: AdamWConfig):
    """This rank's optimizer state (``init(params, cfg, place)``'s layout)
    from the whole model's (a checkpoint's), for the mesh of ``place``:
    the inverse of :func:`whole_state`, for any mesh, so that a run saved
    on one mesh resumes on another."""
    def leaf(p, m, v, pl):
        cut, lead = _cut_of(pl), _lead(p)
        shape = _shape(p)[:lead] + cut.full
        return tuple(_moment_cut(x, cut, shape, lead, cfg.moment_dtype)
                     for x in (m, v))

    out = _map(leaf, params, state["m"], state["v"], place)
    return {"m": _map(lambda pair: pair[0], out),
            "v": _map(lambda pair: pair[1], out), "step": state["step"]}
