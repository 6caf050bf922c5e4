"""The training step (port of ``train/train_step.py``): gradients averaged
over microbatches, then AdamW.

The reference's multi-pod step with int8 error-feedback gradient
compression (``make_compressed_train_step``, ``init_ef_state``,
``train/compression.py``) is sharded training, ROADMAP A13.3.
"""
from __future__ import annotations

import torch

from ..models.convert import stacked_view
from ..models.model import lm_loss
from ..optim import adamw

__all__ = ["make_train_step"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _like(tree, leaves):
    """``leaves`` (in :func:`_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _value_and_grad(loss_fn, params, batch):
    leaves = list(_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _like(params, grads)


def _accumulated_grads(loss_fn, params, batch, n_micro):
    """Mean loss and gradients over ``n_micro`` microbatches: for one, the
    gradients in the parameters' dtypes; else summed in f32 accumulators
    and scaled by ``1 / n_micro``, as the reference's scan does."""
    if n_micro == 1:
        return _value_and_grad(loss_fn, params, batch)
    leaves = list(_leaves(params))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
    for i in range(n_micro):
        mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                           + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
        loss, g = _value_and_grad(loss_fn, params, mb)
        for a, gi in zip(acc, _leaves(g)):
            a.add_(gi.float())
        loss_sum = loss_sum + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, _like(params, [a * inv for a in acc])


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, n_microbatches: int = 1,
                    remat: str = "full", impl: str = "plain"):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` the port's (per-layer) parameters, which it
    updates in place and returns; ``opt_state`` :func:`adamw.init` of
    ``stacked_view(params, cfg)``; ``batch`` tensors on the parameters'
    device with the global batch first; metrics ``loss``, ``lr`` and
    ``grad_norm`` as 0-dim tensors.  ``impl`` defaults to the plain
    attention: kernel B2 has no backward and raises under autograd."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got "
                         f"{n_microbatches}")

    def loss_fn(p, mb):
        return lm_loss(p, cfg, mb, impl=impl, remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = _accumulated_grads(loss_fn, params, batch,
                                         n_microbatches)
        _, opt_state, stats = adamw.update(
            stacked_view(grads, cfg), opt_state, stacked_view(params, cfg),
            opt_cfg)
        return params, opt_state, {"loss": loss, **stats}

    return train_step
