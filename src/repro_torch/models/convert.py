"""Carry parameters and serve state between the reference's layout and the
port's, exactly.

The reference stacks each period's parameters (and serve state) along a
leading ``n_periods`` axis, under ``"l{i}"`` for slot ``i`` of the period;
the port keeps a list with one dict per layer.  Layer ``l`` of the port is
slot ``l % len(period)`` of period ``l // len(period)``.

Arrays come in as numpy (``np.asarray`` of the reference's arrays; bf16
arrives as an ``ml_dtypes`` array and is carried by its bits, so nothing
is rounded).  :func:`serve_state_to_numpy` goes back to the reference's
layout, with bf16 widened to f32 (exact).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig

__all__ = ["to_torch", "params_from_reference", "params_to_reference",
           "stacked_view", "serve_state_from_reference",
           "serve_state_to_numpy"]


def to_torch(a, device="cuda") -> torch.Tensor:
    """One numpy array (or array-like, or tensor) as a new tensor on
    ``device`` with the same values and dtype; bf16 by its bits."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _unstack(tree, cfg: ArchConfig, device):
    """Period-stacked ``{"l{i}": subtree[P, ...]}`` -> list of per-layer
    subtrees."""
    plen = len(cfg.period)
    layers = []
    for layer in range(cfg.n_layers):
        p = layer // plen
        layers.append(_tree(tree[f"l{layer % plen}"],
                            lambda a, p=p: to_torch(_row(a, p), device)))
    return layers


def _row(a, p):
    return a[p] if isinstance(a, torch.Tensor) else np.asarray(a)[p]


def params_from_reference(tree, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's ``init_params`` pytree (numpy leaves, or tensors as
    :func:`params_to_reference` gives them) as the port's parameters."""
    out = {"embed": to_torch(tree["embed"], device),
           "layers": _unstack(tree["layers"], cfg, device),
           "final_norm": _tree(tree["final_norm"],
                               lambda a: to_torch(a, device))}
    if "lm_head" in tree:
        out["lm_head"] = to_torch(tree["lm_head"], device)
    return out


def serve_state_from_reference(tree, cfg: ArchConfig, device="cuda") -> dict:
    """The reference's serve state (``init_serve_state`` / ``prefill`` /
    ``decode_step`` output, numpy leaves) as the port's, ``ctrl``
    included."""
    return {"pos": to_torch(tree["pos"], device),
            "layers": _unstack(tree["layers"], cfg, device)}


def _np(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def serve_state_to_numpy(state, cfg: ArchConfig) -> dict:
    """The port's serve state in the reference's period-stacked layout,
    numpy leaves (bf16 widened to f32)."""
    plen = len(cfg.period)
    return {"pos": _np(state["pos"]),
            "layers": {f"l{i}": _stack(state["layers"][i::plen])
                       for i in range(plen)}}


def _stack(trees):
    """Per-layer subtrees of one period slot -> one subtree ``[P, ...]``."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([_np(x) for x in trees])


def stacked_view(tree, cfg: ArchConfig) -> dict:
    """The port's parameters (or a tree of their gradients) in the
    reference's layout without a copy: each ``layers/l{i}/...`` leaf is the
    list of slot ``i``'s per-layer tensors, in period order (the rows of
    the reference's stacked leaf)."""
    plen, layers = len(cfg.period), tree["layers"]
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = {f"l{i}": _slices(layers[i::plen])
                     for i in range(min(plen, len(layers)))}
    return out


def _slices(trees):
    if isinstance(trees[0], dict):
        return {k: _slices([t[k] for t in trees]) for k in trees[0]}
    return list(trees)


def params_to_reference(tree, cfg: ArchConfig) -> dict:
    """The port's parameters in the reference's period-stacked layout, as
    new tensors on their device (``torch.stack`` of :func:`stacked_view`'s
    slices), dtypes kept."""
    def stack(x):
        if isinstance(x, dict):
            return {k: stack(v) for k, v in x.items()}
        if isinstance(x, list):
            return torch.stack([t.detach() for t in x])
        return x.detach().clone()
    return stack(stacked_view(tree, cfg))
