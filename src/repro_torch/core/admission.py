"""Size-aware admission layer (port of ``core/admission.py``): a ghost /
count-min utility estimator plus a wrapper that composes with *any*
registry policy.

On a miss the wrapper runs the base policy's step first (for the rank
policies that is ``rank_step``, so kernel B1 on CUDA tensors), reads the
victim off ``StepInfo.evicted_key``, and compares size-normalized
utilities::

    u(key, size) = (freq(key) + boost * in_ghost(key)) / max(size, 1)

A rejected candidate *reverts the base step*: the victim stays resident
and the ``StepInfo`` still charges the miss while reporting no eviction.
A base that declares ``ADAPT_KEYS`` (DAC) keeps those scalars from the
new state, so its resize controller keeps seeing filtered misses.  Hits
always commit.

Every state tensor carries the leading lane axis ``[B, ...]`` (the
reference's ``vmap`` written out): the estimator's sketches are
``[B, rows, W]``, its ring ``[B, G]``.  The revert keeps the old base
state and picks between old and new per lane with ``torch.where``; B1's
wrapper copies the row it is given (``kernels/policy_step.py::_pad``), so
the old state is never written.  The step is free of host syncs, so on
CUDA a replay is the engine's CUDA graph loop like any slot policy's.

>>> from repro_torch.core import Engine, make_policy
>>> pol = make_policy("admit(dac(eps=0.5),filter=tinylfu,size_norm=false)")
>>> pol.base.eps, pol.filter, pol.size_norm
(0.5, 'tinylfu', False)
>>> res = Engine(device="cpu").replay(pol, [0, 1, 0, 2, 0, 1, 2, 0], K=2,
...                                   collect_info=False)
>>> float(res.miss_ratio) <= 1.0
True
>>> off = make_policy("admit(lru,filter=off)")      # pass-through wrapper
>>> a = Engine(device="cpu").replay(off, [3, 1, 3, 2], K=2).metrics
>>> b = Engine(device="cpu").replay("lru", [3, 1, 3, 2], K=2).metrics
>>> int(a.hits) == int(b.hits)
True
"""
from __future__ import annotations

import functools

import torch

from .baselines import _HASH_A, sketch_columns
from .policy import EMPTY, Policy, Request, StepInfo, lane_scalar

__all__ = ["AdmissionPolicy", "FILTERS"]

# admission filter variants:
#   off     - always admit; the wrapper is bit-identical to the bare base
#   tinylfu - frequency + bytes sketches only (no ghost ring)
#   ghost   - sketches + recently-evicted ghost ring boost (the default)
FILTERS = ("off", "tinylfu", "ghost")

# multiply-shift hash constants, one odd constant per sketch row: the
# TinyLFU baseline's, so the two estimators stay comparable
_HASH_MIX = _HASH_A


def _bcast(mask, x):
    """A ``[B]`` mask shaped to broadcast over ``x``'s trailing dims."""
    return mask.view(mask.shape + (1,) * (x.dim() - mask.dim()))


def _tree_where(mask, new, old):
    """Leaf-wise ``where(mask, new, old)`` over nested dicts of ``[B, ...]``
    tensors, the ``[B]`` mask broadcast over each leaf's trailing dims."""
    if isinstance(new, dict):
        return {k: _tree_where(mask, new[k], old[k]) for k in new}
    return torch.where(_bcast(mask, new), new, old)


class AdmissionPolicy(Policy):
    """``admit(<base>, ...)``: size-aware admission around any policy.

    ``filter`` picks the estimator (:data:`FILTERS`); ``size_norm``
    divides utilities by (estimated) object size; ``rows`` /
    ``width_factor`` / ``window_factor`` shape the count-min sketch like
    the TinyLFU baseline; ``ghost_factor`` sizes the ghost ring
    (``ghost_factor * K`` keys) and ``ghost_boost`` is the frequency credit
    for a ghost hit.

    >>> from repro_torch.core import make_policy
    >>> make_policy("admit(dac,filter=ghost)").name
    'admit'
    >>> make_policy("admit(lru)") == make_policy("admit(lru)")
    True
    >>> make_policy("admit(lru,filter=sometimes)")
    Traceback (most recent call last):
        ...
    ValueError: admit filter must be one of ('off', 'tinylfu', 'ghost'), \
got 'sometimes'
    """

    name = "admit"

    def __init__(self, base, filter: str = "ghost", size_norm: bool = True,
                 rows: int = 4, width_factor: int = 16,
                 window_factor: int = 8, ghost_factor: int = 4,
                 ghost_boost: int = 2):
        from . import make_policy
        self.base = make_policy(base)
        if filter not in FILTERS:
            raise ValueError(
                f"admit filter must be one of {FILTERS}, got {filter!r}")
        self.filter = str(filter)
        self.size_norm = bool(size_norm)
        self.rows = int(rows)
        if not 1 <= self.rows <= len(_HASH_MIX):
            raise ValueError(
                f"rows must lie in [1, {len(_HASH_MIX)}], got {rows}")
        self.width_factor = int(width_factor)
        self.window_factor = int(window_factor)
        self.ghost_factor = int(ghost_factor)
        self.ghost_boost = int(ghost_boost)
        if min(self.width_factor, self.window_factor,
               self.ghost_factor) < 1 or self.ghost_boost < 0:
            raise ValueError(
                "width_factor/window_factor/ghost_factor must be >= 1 and "
                "ghost_boost >= 0")

    # --- estimator state -------------------------------------------------

    def _width(self, K: int) -> int:
        w = 1
        while w < K * self.width_factor:
            w *= 2
        return w

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        """Base state nested under ``"base"``; estimator state (when the
        filter is on) under ``"adm"``: fixed shapes derived from ``K``.

        >>> pol = AdmissionPolicy("lru", filter="ghost")
        >>> st = pol.init(4, device="cpu")
        >>> sorted(st), sorted(st["adm"])
        (['adm', 'base'], ['adds', 'bytes', 'ghost', 'head', 'sketch', \
'window'])
        >>> AdmissionPolicy("lru", filter="off").init(4, device="cpu").keys()
        dict_keys(['base'])
        """
        state = {"base": self.base.init(K, lanes, device)}
        if self.filter == "off":
            return state
        shape = (lanes, self.rows, self._width(K))
        adm = {
            "sketch": torch.zeros(shape, dtype=torch.int32, device=device),
            "bytes": torch.zeros(shape, dtype=torch.float32, device=device),
            "adds": lane_scalar(0, lanes, device),
            "window": lane_scalar(self.window_factor * K, lanes, device),
        }
        if self.filter == "ghost":
            adm["ghost"] = torch.full((lanes, self.ghost_factor * K), EMPTY,
                                      dtype=torch.int32, device=device)
            adm["head"] = lane_scalar(0, lanes, device)
        state["adm"] = adm
        return state

    # --- estimator arithmetic (per lane, fixed shape) --------------------

    def _hash(self, key, W):
        """``[B]`` keys -> ``[B, rows, 1]`` sketch columns."""
        return sketch_columns(key, self.rows, W).unsqueeze(-1)

    def _observe(self, adm: dict, req: Request) -> dict:
        """Count the request in both sketches; halve both when the window
        expires (the byte halving floored like the integer one, so the
        mean-size ratio stays exact on unit-size traces)."""
        h = self._hash(req.key, adm["sketch"].shape[-1])
        sketch = adm["sketch"].scatter(
            -1, h, adm["sketch"].gather(-1, h) + 1)
        size = req.size.to(torch.float32).view(-1, 1, 1)
        byts = adm["bytes"].scatter(-1, h, adm["bytes"].gather(-1, h) + size)
        adds = adm["adds"] + 1
        expire = adds >= adm["window"]
        e = _bcast(expire, sketch)
        return dict(adm,
                    sketch=torch.where(e, sketch // 2, sketch),
                    bytes=torch.where(e, torch.floor(byts * 0.5), byts),
                    adds=torch.where(expire, 0, adds))

    def _freq_bytes(self, adm: dict, key):
        """Count-min point estimates per lane: (frequency, bytes)."""
        h = self._hash(key, adm["sketch"].shape[-1])
        return (adm["sketch"].gather(-1, h).squeeze(-1).amin(-1)
                .to(torch.float32),
                adm["bytes"].gather(-1, h).squeeze(-1).amin(-1))

    def _boosted(self, adm: dict, key, freq):
        if self.filter != "ghost":
            return freq
        in_ghost = (adm["ghost"] == key.unsqueeze(-1)).any(-1)
        return freq + self.ghost_boost * in_ghost.to(torch.float32)

    def _utility(self, adm: dict, key, size):
        """Size-normalized estimated utility of caching ``key``."""
        freq, _ = self._freq_bytes(adm, key)
        freq = self._boosted(adm, key, freq)
        if not self.size_norm:
            return freq
        return freq / torch.clamp(size.to(torch.float32), min=1.0)

    def _victim_utility(self, adm: dict, victim):
        """Like :meth:`_utility`, the victim's size estimated from the
        bytes / frequency sketch ratio (no resident metadata)."""
        freq, byts = self._freq_bytes(adm, victim)
        boosted = self._boosted(adm, victim, freq)
        if not self.size_norm:
            return boosted
        mean_size = byts / torch.clamp(freq, min=1.0)
        return boosted / torch.clamp(mean_size, min=1.0)

    def _remember(self, adm: dict, victim, push) -> dict:
        """Push an admitted step's victim into the ghost ring."""
        ghost, head = adm["ghost"], adm["head"]
        G = ghost.shape[-1]
        at = head.long().unsqueeze(-1)
        pushed = ghost.scatter(-1, at, victim.to(torch.int32).unsqueeze(-1))
        return dict(adm,
                    ghost=torch.where(push.unsqueeze(-1), pushed, ghost),
                    head=torch.where(push, (head + 1) % G, head))

    # --- the wrapped step ------------------------------------------------

    def _merge(self, admit, new_base, old_base):
        """Commit or revert the base transition per lane; a rejected miss
        reverts the base state except the ``ADAPT_KEYS`` the base declares
        (DAC's ``jump``/``k`` controller keeps observing filtered misses).
        A base that declares none reverts wholesale."""
        adapt = frozenset(getattr(self.base, "ADAPT_KEYS", ()))
        return {k: new_base[k] if k in adapt
                else _tree_where(admit, new_base[k], old_base[k])
                for k in new_base}

    def _gate(self, state: dict, req: Request, new_base, info: StepInfo):
        """Shared post-step gating: admit or revert the base transition.
        Hits and victimless inserts always commit; contested inserts
        compare utilities (``tinylfu`` keeps the resident on a tie, strict
        ``>``; ``ghost`` admits ties, ``>=``)."""
        adm = self._observe(state["adm"], req)
        victim = info.evicted_key
        u_cand = self._utility(adm, req.key, req.size)
        u_vict = self._victim_utility(adm, victim)
        beats = u_cand >= u_vict if self.filter == "ghost" else \
            u_cand > u_vict
        admit = info.hit | (victim == EMPTY) | beats
        base_out = self._merge(admit, new_base, state["base"])
        if self.filter == "ghost":
            adm = self._remember(adm, victim,
                                 push=admit & ~info.hit & (victim != EMPTY))
        # a rejected miss still charges size and cost, but nothing left
        # the cache
        info = info._replace(evicted_key=torch.where(admit, victim, EMPTY))
        return {"base": base_out, "adm": adm}, info

    def step(self, state: dict, req: Request):
        """Base step first, then the admission gate.

        >>> pol = AdmissionPolicy("lru")
        >>> st, info = pol.step(pol.init(2, device="cpu"),
        ...                     Request.of([7], device="cpu"))
        >>> bool(info.hit[0]), int(info.evicted_key[0]), \
int(st["adm"]["adds"][0])
        (False, -1, 1)
        """
        new_base, info = self.base.step(state["base"], req)
        if self.filter == "off":
            return {"base": new_base}, info
        return self._gate(state, req, new_base, info)

    def _step_budgeted(self, fn, state: dict, req: Request):
        """Budgeted variant: the base's ``step_budgeted``
        (``state["base"]["cap"]`` rides through) with the same gate."""
        new_base, info = fn(state["base"], req)
        if self.filter == "off":
            return {"base": new_base}, info
        return self._gate(state, req, new_base, info)

    # --- conditional delegation -----------------------------------------
    # `observables` / `step_budgeted` exist on the wrapper exactly when the
    # base has them (the engine and the tier feature-detect with hasattr)

    def __getattr__(self, name):
        if name in ("observables", "step_budgeted"):
            base = self.__dict__.get("base")
            fn = getattr(base, name, None)
            if fn is not None:
                if name == "observables":
                    return lambda state: fn(state["base"])
                return functools.partial(self._step_budgeted, fn)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")
