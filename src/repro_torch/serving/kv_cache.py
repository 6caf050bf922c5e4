"""Bounded KV-cache slot pool managed by DynamicAdaptiveClimb (port of
``serving/kv_cache.py``).

The paper's control law mapped onto KV-cache management:

  * the per-layer slot table is the cache; ``rank2slot`` is the paper's
    rank-ordered list of *physical slot ids* (rank 0 = top);
  * every decoded token inserts its KV: a **miss** (Alg. 2 miss path:
    jump += 1, insert at rank k - actualJump, evict the bottom rank's slot
    when the active budget is full);
  * the top-attended slot of the decode-attention pass is a **hit**
    (Alg. 2 hit path: jump -= 1, promote by actualJump);
  * DAC resizing drives the active budget ``k_active``: doubling when jump
    reaches 2k, halving when jump and jump' both saturate at -k/2 (the
    freed slots' memory goes back to the pool).

State of one attention layer, batched over B sequences (the reference's
``vmap`` written out as a leading batch dimension):

  rank2slot [B, Bmax] int32   rank -> physical slot (EMPTY past ``length``)
  free      [B, Bmax] bool    physical-slot free bitmap
  length    [B] int32         occupied slots
  k_active  [B] int32         DAC active budget
  jump      [B] int32         Alg. 2 jump  (in [-k/2, 2k])
  jump2     [B] int32         Alg. 2 jump' (in [-k/2, 0])
  slot_pos  [B, Bmax] int32   token position of each slot (window masks)

Every function returns new tensors and leaves its input as it was.  Two
details keep the port equal to the reference bit for bit:

  * "first free slot" and "first rank holding the slot" are the first
    index, as ``jnp.argmax`` on a bool array gives (cast to int32 first:
    ``torch.argmax`` takes no bool on CUDA);
  * a shrink frees the evicted ranks' slots through a scatter whose masked
    lanes land on a spare column, never on slot 0 (the reference's
    ``.at[evicted].max(mask)`` is an OR; a plain torch scatter with
    duplicate indices has no defined order on CUDA).
"""
from __future__ import annotations

import torch

from ..core.control import hit_update, miss_update, resize_update
from ..core.policy import EMPTY

__all__ = ["control_init", "insert", "hit", "resize", "valid_slots"]


def control_init(B: int, budget: int, k0: int | None = None,
                 device="cuda") -> dict:
    """DAC control state for B caches of ``budget`` slots each."""
    k0 = k0 if k0 is not None else max(2, budget // 4)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "rank2slot": torch.full((B, budget), EMPTY, **i32),
        "free": torch.ones((B, budget), dtype=torch.bool, device=device),
        "length": torch.zeros(B, **i32),
        "k_active": torch.full((B,), k0, **i32),
        "jump": torch.full((B,), k0, **i32),
        "jump2": torch.zeros(B, **i32),
        "slot_pos": torch.full((B, budget), -1, **i32),
    }


def _first(mask):
    """Index of the first True in each row (0 when none), int32."""
    return mask.to(torch.int32).argmax(dim=-1).to(torch.int32)


def _promote(rank2slot, i, t, slot):
    """Move ``slot`` from rank i to rank t (t <= i), shifting [t, i-1]
    down one, per row."""
    r = torch.arange(rank2slot.shape[1], dtype=torch.int32,
                     device=rank2slot.device)[None]
    rolled = torch.roll(rank2slot, 1, dims=1)
    i, t = i[:, None], t[:, None]
    return torch.where(r == t, slot[:, None],
                       torch.where((r > t) & (r <= i), rolled, rank2slot))


def _set(x, idx, value):
    """``x`` with ``x[b, idx[b]] = value`` (one index per row); ``value`` a
    Python scalar or a ``[B]`` tensor (no host-to-device copy either way)."""
    idx = idx.long()[:, None]
    if isinstance(value, torch.Tensor):
        return x.scatter(1, idx, value.to(x.dtype)[:, None])
    return x.scatter(1, idx, value)


def insert(ctrl, pos):
    """Batched miss event (a new token's KV).  pos ``[B]`` positions.
    Returns ``(ctrl, slot [B])``; the caller writes the KV at ``slot``."""
    r2s, free, length = ctrl["rank2slot"], ctrl["free"], ctrl["length"]
    k = ctrl["k_active"]
    jump_m, jump2_m, actual = miss_update(ctrl["jump"], ctrl["jump2"], k)
    full = length >= k
    victim = r2s.gather(1, (length - 1).clamp(min=0).long()[:, None])[:, 0]
    fresh = _first(free)
    slot = torch.where(full, victim, fresh)
    t = torch.minimum((k - actual).clamp(min=0), length)  # no gaps filling
    bottom = torch.where(full, length - 1, length)
    new = dict(ctrl,
               rank2slot=_promote(r2s, bottom, t, slot),
               free=_set(free, slot, False),
               length=torch.where(full, length, length + 1),
               jump=jump_m, jump2=jump2_m,
               slot_pos=_set(ctrl["slot_pos"], slot, pos))
    return new, slot


def hit(ctrl, slot):
    """Batched hit event: ``slot [B]`` is the top-attended physical slot
    (-1 = no hit this step)."""
    r2s, length, k = ctrl["rank2slot"], ctrl["length"], ctrl["k_active"]
    jump, jump2 = ctrl["jump"], ctrl["jump2"]
    ok = (slot >= 0) & (length > 0)
    eq = r2s == slot[:, None]
    i = _first(eq)
    found = eq.any(dim=-1) & ok
    jump_h, jump2_h, actual = hit_update(jump, jump2, i, k)
    r2s_h = torch.where((i > 0)[:, None], _promote(r2s, i, i - actual, slot),
                        r2s)
    return dict(ctrl,
                rank2slot=torch.where(found[:, None], r2s_h, r2s),
                jump=torch.where(found, jump_h, jump),
                jump2=torch.where(found, jump2_h, jump2))


def resize(ctrl, eps: float = 0.5, k_min: int = 16, cap=None):
    """Batched DAC resize check (after every request).  ``cap`` (``[B]``
    int32, optional) is an arbiter's per-sequence capacity grant, gating a
    doubling at ``min(2k, cap)``; ``None`` keeps the paper's law."""
    r2s, free, length = ctrl["rank2slot"], ctrl["free"], ctrl["length"]
    B, Bmax = r2s.shape
    k = ctrl["k_active"]
    kmax = torch.full_like(k, Bmax)
    if cap is not None:
        cap = torch.as_tensor(cap, dtype=torch.int32, device=k.device)
    k_new, jump, jump2, _, shrink = resize_update(
        ctrl["jump"], ctrl["jump2"], k, eps=eps, k_min=k_min, kmax=kmax,
        cap=cap)
    r = torch.arange(Bmax, dtype=torch.int32, device=r2s.device)[None]
    evict = (shrink[:, None] & (r >= k_new[:, None]) & (r < length[:, None])
             & (r2s >= 0))
    # live ranks hold distinct slots; masked lanes go to the spare column
    idx = torch.where(evict, r2s, Bmax).long()
    freed = torch.zeros((B, Bmax + 1), dtype=torch.bool, device=r2s.device)
    freed = freed.scatter(1, idx, True)[:, :Bmax]
    return dict(ctrl,
                rank2slot=torch.where(evict, EMPTY, r2s),
                free=free | freed,
                length=torch.where(shrink, torch.minimum(length, k_new),
                                   length),
                k_active=k_new, jump=jump, jump2=jump2)


def valid_slots(ctrl):
    """``[B, Bmax]`` bool: physical slots holding live entries."""
    return ~ctrl["free"]
