"""The paper's rank policies, the FIFO/LRU baselines and the replay engine
(port of ``repro.core``)::

    policy = make_policy("dac(eps=0.5,growth=4)")
    result = Engine(device="cuda").replay(policy, keys, K)
    result.miss_ratio, result.byte_miss_ratio, result.penalty_ratio
"""
from ..specs import build_kwargs, parse_spec
from .adaptiveclimb import AdaptiveClimb
from .baselines import FIFO, LRU, Climb
from .dynamicadaptiveclimb import DynamicAdaptiveClimb
from .policy import (EMPTY, LANE, Plan, Policy, RankPolicy, Request,
                     StepInfo, lane_pad, padded_row, rank_step, step_info)
from .simulator import (Engine, Metrics, ReplayResult, miss_ratio, mrr,
                        replay_lanes)

POLICIES = {
    "adaptiveclimb": AdaptiveClimb,
    "dynamicadaptiveclimb": DynamicAdaptiveClimb,
    "fifo": FIFO,
    "lru": LRU,
    "climb": Climb,
}

ALIASES = {
    "ac": "adaptiveclimb",
    "dac": "dynamicadaptiveclimb",
}

# reference registry names that later slices port, with their ROADMAP item
_UNPORTED = {
    **dict.fromkeys(("blru", "lfu", "clock", "sieve", "twoq", "2q", "arc",
                     "lirs", "lhd", "tinylfu", "hyperbolic"), "A6"),
    "admit": "A8",
}


def make_policy(spec) -> Policy:
    """Build a policy from a spec string (registry name or alias plus
    optional constructor kwargs); instances pass through.

    >>> make_policy("dac(eps=0.25,growth=2)")
    DynamicAdaptiveClimb(eps=0.25, growth=2, k_min=2)
    >>> make_policy("arc")
    Traceback (most recent call last):
        ...
    ValueError: policy 'arc' is not ported yet (ROADMAP.md queue A, item A6); ported: ['adaptiveclimb', 'climb', 'dynamicadaptiveclimb', 'fifo', 'lru']
    """
    if isinstance(spec, Policy):
        return spec
    name, argstr = parse_spec(spec)
    name = ALIASES.get(name, name)
    if name in _UNPORTED:
        raise ValueError(
            f"policy {name!r} is not ported yet (ROADMAP.md queue A, item "
            f"{_UNPORTED[name]}); ported: {sorted(POLICIES)}")
    if name not in POLICIES:
        raise ValueError(
            f"unknown policy {name!r}; known: {sorted(POLICIES)} "
            f"(aliases: {sorted(ALIASES)})")
    cls = POLICIES[name]
    return cls(**build_kwargs("policy", name, cls.__init__, argstr))


__all__ = [
    "AdaptiveClimb", "DynamicAdaptiveClimb", "Climb", "FIFO", "LRU",
    "EMPTY", "LANE", "Plan", "Policy", "RankPolicy", "Request", "StepInfo",
    "step_info", "rank_step", "lane_pad", "padded_row",
    "POLICIES", "ALIASES", "make_policy",
    "Engine", "Metrics", "ReplayResult", "replay_lanes", "miss_ratio", "mrr",
]
