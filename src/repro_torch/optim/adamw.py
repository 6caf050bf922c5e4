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
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["BLOCK", "AdamWConfig", "schedule", "quantize", "dequantize",
           "init", "global_norm", "update"]

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

def quantize(x, sqrt_domain: bool = False):
    """f32 tensor -> ``{"q": int8 [blocks, BLOCK], "scale": f32 [blocks]}``
    over its flattening, zero-padded to whole blocks.

    ``sqrt_domain=True`` quantizes ``sqrt(x)`` (x >= 0), as for the second
    moment, whose quadratic range would otherwise round small-|g| elements
    to v = 0 while their m survives."""
    flat = x.reshape(-1)
    if sqrt_domain:
        flat = torch.sqrt(torch.clamp(flat, min=0.0))
    flat = torch.nn.functional.pad(flat, (0, -flat.numel() % BLOCK))
    flat = flat.reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1) / 127.0
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


# --- optimizer --------------------------------------------------------------

def init(params, cfg: AdamWConfig):
    def zero_like(p):
        z = torch.zeros(_shape(p), dtype=torch.float32, device=_device(p))
        return _wrap_moment(z, cfg.moment_dtype)

    first = next(_leaves(params))
    return {"m": _map(zero_like, params), "v": _map(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(first))}


def global_norm(tree):
    """sqrt of the sum of squares of every element, in f32 (a list leaf
    counts each slice)."""
    sq = []
    for leaf in _leaves(tree):
        for x in (leaf if isinstance(leaf, list) else [leaf]):
            sq.append(x.float().square().sum())
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step: writes the new values into ``params``' tensors and
    returns ``(params, new_state, {"lr", "grad_norm"})``."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.clip_norm else 1.0

    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    def leaf(p, g, m, v):
        shape = _shape(p)
        pf = _stacked(p).float()
        g = _stacked(g).float() * scale
        m_f = _unwrap_moment(m, shape, cfg.moment_dtype)
        v_f = _unwrap_moment(v, shape, cfg.moment_dtype, sqrt_domain=True)
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g.square()
        del g
        upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        upd = upd + cfg.weight_decay * pf
        new_p = pf - lr * upd
        del upd, pf
        if isinstance(p, list):
            for dst, src in zip(p, new_p):
                dst.copy_(src)
        else:
            p.copy_(new_p)
        return (_wrap_moment(m_f, cfg.moment_dtype),
                _wrap_moment(v_f, cfg.moment_dtype, sqrt_domain=True))

    out = _map(leaf, params, grads, state["m"], state["v"])
    new_m = _map(lambda pair: pair[0], out)
    new_v = _map(lambda pair: pair[1], out)
    return params, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
