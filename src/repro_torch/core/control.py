"""Algorithm 2's scalar control law on int32 tensors (port of
``core/control.py``).

The DynamicAdaptiveClimb plan (:mod:`repro_torch.core.dynamicadaptiveclimb`)
runs these updates over ``[B]`` lanes; the CUDA kernel's DAC plan
(``kernels/csrc/policy_step.cu``) is the same arithmetic written in C.
``tests/test_torch_control.py`` sweeps small int32 domains against the
reference.

Two details keep the port bit-exact:

* ``k // 2`` is floor division, as in jnp (``x >> 1`` in the kernel);
* the shrink threshold ``-ceil(eps * float32(k // 2))`` rounds ``eps`` to
  float32 *before* the multiply, as jnp does with a weak-typed Python float.

>>> i32 = lambda v: torch.tensor([v], dtype=torch.int32)
>>> j, j2, actual = miss_update(i32(4), i32(0), i32(4))
>>> int(j), int(j2), int(actual)
(5, 0, 3)
>>> out = resize_update(i32(8), i32(0), i32(4), eps=0.5, k_min=2,
...                     kmax=i32(16), cap=i32(6))
>>> int(out[0])                    # arbiter cap 6: partial grant
6
"""
from __future__ import annotations

import torch

__all__ = ["hit_update", "miss_update", "resize_update"]


def _half(k):
    return torch.div(k, 2, rounding_mode="floor")


def hit_update(jump, jump2, i, k):
    """Alg. 2 hit path (lines 2.4-2.20) at rank ``i``.  Returns
    ``(jump, jump2, actual)``; the entry moves from rank ``i`` to
    ``i - actual``."""
    half = _half(k)
    jump_h = torch.where(jump > -half, jump - 1, jump)
    top_half = i < half
    jump2_h = torch.where(
        top_half,
        torch.where(jump2 > -half, jump2 - 1, jump2),
        torch.where(jump2 < 0, jump2 + 1, jump2),
    )
    actual = torch.clamp(torch.minimum(jump_h, i), min=1)
    return jump_h, jump2_h, actual


def miss_update(jump, jump2, k):
    """Alg. 2 miss path (lines 2.22-2.27).  Returns
    ``(jump, jump2, actual)``; the caller evicts rank ``k - 1`` and inserts
    at rank ``k - actual``."""
    jump_m = torch.minimum(jump + 1, 2 * k)
    jump2_m = torch.where(jump2 < 0, jump2 + 1, jump2)
    actual = torch.clamp(torch.minimum(k - 1, jump_m), min=1)
    return jump_m, jump2_m, actual


def resize_update(jump, jump2, k, *, eps, k_min, kmax, cap=None):
    """Alg. 2 resize checks (lines 2.30-2.38) with the reference's
    post-resize state choices.  ``cap`` (a capacity grant from an arbiter)
    turns the doubling into ``k -> min(2k, cap, kmax)``.

    Returns ``(k_new, jump, jump2, grow, shrink)``."""
    half = _half(k)
    jump2 = torch.where(jump == 0, 0, jump2)
    eps32 = torch.tensor(eps, dtype=torch.float32, device=k.device)
    shrink_thresh = -torch.ceil(eps32 * half.to(torch.float32)).to(torch.int32)
    if cap is None:
        k_grow = 2 * k
        grow = (jump >= 2 * k) & (2 * k <= kmax)
    else:
        k_grow = torch.minimum(2 * k, torch.minimum(cap, kmax))
        grow = (jump >= 2 * k) & (k_grow > k)
    shrink = ((~grow) & (jump <= -half) & (jump2 <= shrink_thresh)
              & (half >= k_min))

    k_new = torch.where(grow, k_grow, torch.where(shrink, half, k))
    resized = grow | shrink
    jump = torch.where(shrink, 0, torch.minimum(
        torch.maximum(jump, -_half(k_new)), 2 * k_new))
    jump2 = torch.where(resized, 0, jump2)
    return (k_new.to(torch.int32), jump.to(torch.int32),
            jump2.to(torch.int32), grow, shrink)
