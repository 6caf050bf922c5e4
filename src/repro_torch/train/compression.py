"""Gradient compression for the slow cross-pod links (port of
``train/compression.py``): int8 blockwise quantization with error
feedback, synced with an all-gather of the int8 payload instead of an f32
sum.

Why an all-gather: only a collective that carries the int8 tensors
themselves moves fewer bytes.  A ring f32 all-reduce moves ~2 x 4 bytes
an element; gathering the P pods' int8 blocks moves (P - 1) bytes an
element (plus an f32 scale every ``BLOCK``), ~8x fewer at P = 2, and the
dequantize and mean stay local.

Error feedback (Seide et al., EF-SGD) keeps the quantization unbiased over
time: the residual ``e = g - deq(quant(g))`` is carried and added to the
next step's gradient, so long-run drift vanishes.

:func:`ef_allgather_mean` runs on each rank of a ``torch.distributed``
mesh with the rank's tensors, the mean over the ranks along one axis (the
pod axis).  Its arithmetic is the reference's bit for bit on the CPU:
the scales' division, ``torch.round`` (half to even, as ``jnp.round``),
and the dequantized pods added in pod order, each as a fused
multiply-add, as XLA's dot adds them (:func:`_pod_sum`).
"""
from __future__ import annotations

import math

import torch

__all__ = ["BLOCK", "init_ef", "ef_allgather_mean"]

BLOCK = 256


def _on(x, value):
    """``value`` as a 0-dim f32 tensor on ``x``'s device: a divisor there
    divides (PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal instead, which can round otherwise)."""
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _quantize(x):
    """f32 ``x`` -> (int8 ``[blocks, BLOCK]``, f32 scales ``[blocks]``)
    over its flattening, zero-padded to whole blocks."""
    flat = x.reshape(-1)
    fb = torch.nn.functional.pad(flat, (0, -flat.numel() % BLOCK))
    fb = fb.reshape(-1, BLOCK)
    scale = fb.abs().amax(dim=1) / _on(fb, 127.0)
    q = torch.round(fb / torch.clamp(scale[:, None], min=1e-20))
    return q.to(torch.int8), scale


def _dequantize(q, scale, shape):
    flat = q.float() * scale[:, None]
    return flat.reshape(-1)[:math.prod(shape)].reshape(shape)


def ef_allgather_mean(g, ef, mesh, axis: str):
    """The compressed mean of ``g`` over the ranks along ``axis`` of
    ``mesh``, with error feedback.

    ``g``, ``ef``: this rank's f32 tensors (``ef`` of ``g``'s shape).
    Returns ``(mean, new_ef)``, the mean the same on every rank of the
    axis.  Wire payload: the int8 blocks and their f32 scales."""
    from ..launch.mesh import gather
    x = g.float() + ef
    q, scale = _quantize(x)
    new_ef = x - _dequantize(q, scale, x.shape)
    qs = gather(q, mesh, axis)                      # P x [blocks, BLOCK]
    ss = gather(scale, mesh, axis)                  # P x [blocks]
    mean = (_pod_sum(qs, ss) / _on(x, len(qs))).reshape(-1)
    return mean[:math.prod(x.shape)].reshape(x.shape), new_ef


def _pod_sum(qs, ss):
    """The dequantized pods' f32 sum, added in pod order as XLA's CPU dot
    adds them: each next product folded in with a fused multiply-add.

    The f64 pass exists only to give that bit for bit (the tests hold
    the mean to the reference's): a product of an int8 and an f32 is
    exact in f64, and so is its sum with an f32 unless the two lie ~2^29
    apart, so rounding that sum to f32 is the fused step's one rounding.
    ``chip_smoke.py`` times it against an f32 pass on the card."""
    summed = qs[0].float() * ss[0][:, None]
    for qp, sp in zip(qs[1:], ss[1:]):
        summed = (qp.double() * sp.double()[:, None]
                  + summed.double()).float()
    return summed


def init_ef(params, n_pods: int):
    """Per-pod error-feedback state in the reference's layout: each leaf
    ``[n_pods, *leaf]`` f32 zeros (a list leaf, a stacked view's slices,
    as ``[n_pods, n_slices, *slice]``)."""
    if isinstance(params, dict):
        return {k: init_ef(v, n_pods) for k, v in params.items()}
    shape = ((len(params),) + tuple(params[0].shape)
             if isinstance(params, list) else tuple(params.shape))
    dev = (params[0] if isinstance(params, list) else params).device
    return torch.zeros((n_pods,) + shape, dtype=torch.float32, device=dev)
