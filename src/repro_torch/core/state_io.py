"""Carry policy state between the reference and the port.

What carrying weights across is to a model, carrying cache state across is
to this system: a state the reference built (as numpy arrays, unbatched
``[...]`` or batched ``[B, ...]``) continues in the port, and back.
"""
from __future__ import annotations

import numpy as np
import torch

from .policy import Policy

__all__ = ["state_from_reference", "state_to_numpy"]


def state_from_reference(policy: Policy, arrays: dict,
                         device="cuda") -> dict:
    """Turn a reference policy state ``{name: ndarray}`` (nested for the
    admission wrapper: ``{"base": {...}, "adm": {...}}``) into the port's
    ``[B, ...]`` state on ``device``.  An unbatched state gets a lane axis
    of 1; dtypes follow the port's ``init`` (int32 rows and scalars, int64
    LRU timestamps).  Keys the port's ``init`` lacks (DAC's arbiter
    ``cap``) are per-lane int32 scalars.

    >>> from repro_torch.core import make_policy
    >>> st = state_from_reference(make_policy("climb"),
    ...     {"cache": np.full(128, -1, np.int32), "len": np.int32(4)},
    ...     device="cpu")
    >>> tuple(st["cache"].shape), st["len"].tolist()
    ((1, 128), [4])
    """
    return _from_tree(policy.init(1, lanes=1, device="cpu"), arrays, device,
                      "state")


def _from_tree(template: dict, arrays: dict, device, path: str) -> dict:
    out = {}
    for name, value in arrays.items():
        like = template.get(name)
        if isinstance(value, dict):
            out[name] = _from_tree(like if isinstance(like, dict) else {},
                                   value, device, f"{path}[{name!r}]")
            continue
        value = np.asarray(value)
        ndim = like.dim() if like is not None else 1
        dtype = like.dtype if like is not None else torch.int32
        if value.ndim == ndim - 1:
            value = value[None]
        elif value.ndim != ndim:
            raise ValueError(
                f"{path}[{name!r}] has {value.ndim} dims; the port expects "
                f"{ndim - 1} (unbatched) or {ndim} (batched)")
        out[name] = torch.tensor(value, dtype=dtype, device=device)
    missing = set(template) - set(out)
    if missing:
        raise ValueError(f"{path} lacks {sorted(missing)}")
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's state as host numpy arrays (nested like the state),
    lane axis kept."""
    return {k: state_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in state.items()}
