"""The paper's rank policies, the twelve baselines and the replay engine
(port of ``repro.core``)::

    policy = make_policy("dac(eps=0.5,growth=4)")
    result = Engine(device="cuda").replay(policy, keys, K)
    result.miss_ratio, result.byte_miss_ratio, result.penalty_ratio
"""
from ..specs import build_kwargs, parse_spec
from .adaptiveclimb import AdaptiveClimb
from .baselines import (ARC, BLRU, FIFO, LFU, LRU, Climb, Clock, Hyperbolic,
                        Sieve, TinyLFU, TwoQ)
from .dynamicadaptiveclimb import DynamicAdaptiveClimb
from .lirs_lhd import LHD, LIRS
from .policy import (EMPTY, LANE, Plan, Policy, RankPolicy, Request,
                     StepInfo, lane_pad, padded_row, rank_step, step_info)
from .simulator import (Engine, Metrics, ReplayResult, miss_ratio, mrr,
                        replay_lanes)

POLICIES = {
    "adaptiveclimb": AdaptiveClimb,
    "dynamicadaptiveclimb": DynamicAdaptiveClimb,
    "fifo": FIFO,
    "lru": LRU,
    "blru": BLRU,
    "climb": Climb,
    "lfu": LFU,
    "clock": Clock,
    "sieve": Sieve,
    "twoq": TwoQ,
    "arc": ARC,
    "lirs": LIRS,
    "lhd": LHD,
    "tinylfu": TinyLFU,
    "hyperbolic": Hyperbolic,
}

ALIASES = {
    "ac": "adaptiveclimb",
    "dac": "dynamicadaptiveclimb",
    "2q": "twoq",
}

# reference registry names that later slices port, with their ROADMAP item
_UNPORTED = {"admit": "A8"}


def make_policy(spec) -> Policy:
    """Build a policy from a spec string (registry name or alias plus
    optional constructor kwargs); instances pass through.

    >>> make_policy("dac(eps=0.25,growth=2)")
    DynamicAdaptiveClimb(eps=0.25, growth=2, k_min=2)
    >>> make_policy("2q").name           # aliases resolve
    'twoq'
    >>> make_policy("dac(nope=1)")
    Traceback (most recent call last):
        ...
    ValueError: unknown parameter 'nope' for policy 'dynamicadaptiveclimb'; accepts: ['eps', 'growth', 'k_min']
    >>> make_policy("admit(dac,filter=tinylfu)")
    Traceback (most recent call last):
        ...
    ValueError: policy 'admit' is not ported yet (ROADMAP.md queue A, item A8); ported: ['adaptiveclimb', 'arc', 'blru', 'climb', 'clock', 'dynamicadaptiveclimb', 'fifo', 'hyperbolic', 'lfu', 'lhd', 'lirs', 'lru', 'sieve', 'tinylfu', 'twoq']
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
            f"(aliases: {sorted(ALIASES)}; combinator: admit(<policy>,...))")
    cls = POLICIES[name]
    return cls(**build_kwargs("policy", name, cls.__init__, argstr))


__all__ = [
    "AdaptiveClimb", "DynamicAdaptiveClimb",
    "ARC", "BLRU", "Clock", "Climb", "FIFO", "Hyperbolic", "LFU", "LHD",
    "LIRS", "LRU", "Sieve", "TinyLFU", "TwoQ",
    "EMPTY", "LANE", "Plan", "Policy", "RankPolicy", "Request", "StepInfo",
    "step_info", "rank_step", "lane_pad", "padded_row",
    "POLICIES", "ALIASES", "make_policy",
    "Engine", "Metrics", "ReplayResult", "replay_lanes", "miss_ratio", "mrr",
]
