"""The paper's rank policies, the twelve baselines, the admission
combinator and the replay engine (port of ``repro.core``)::

    policy = make_policy("dac(eps=0.5,growth=4)")
    result = Engine(device="cuda").replay(policy, keys, K)
    result.miss_ratio, result.byte_miss_ratio, result.penalty_ratio
"""
from ..specs import build_kwargs, parse_spec, split_top
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

def _make_admission(argstr):
    """Build the ``admit(<base-spec>, k=v...)`` combinator: the first
    top-level argument is a full policy spec (possibly parenthesized, as
    ``admit(dac(eps=0.5,growth=4),filter=tinylfu)``), the rest are
    ``AdmissionPolicy`` knobs coerced like any constructor kwargs."""
    parts = split_top(argstr)
    if not parts or "=" in parts[0].partition("(")[0]:
        raise ValueError(
            "admit(...) needs a base policy spec as its first argument, "
            "e.g. admit(dac,filter=tinylfu)")
    base = make_policy(parts[0])
    kwargs = build_kwargs("policy", "admit", AdmissionPolicy.__init__,
                          ",".join(parts[1:]), skip=("self", "base"))
    return AdmissionPolicy(base, **kwargs)


def make_policy(spec) -> Policy:
    """Build a policy from a spec string (registry name or alias plus
    optional constructor kwargs, or the ``admit(<policy>, ...)``
    combinator); instances pass through.

    >>> make_policy("dac(eps=0.25,growth=2)")
    DynamicAdaptiveClimb(eps=0.25, growth=2, k_min=2)
    >>> make_policy("2q").name           # aliases resolve
    'twoq'
    >>> make_policy("admit(dac(eps=0.25),filter=tinylfu)").base.eps
    0.25
    >>> make_policy("dac(nope=1)")
    Traceback (most recent call last):
        ...
    ValueError: unknown parameter 'nope' for policy 'dynamicadaptiveclimb'; accepts: ['eps', 'growth', 'k_min']
    """
    if isinstance(spec, Policy):
        return spec
    name, argstr = parse_spec(spec)
    name = ALIASES.get(name, name)
    if name == "admit":
        return _make_admission(argstr)
    if name not in POLICIES:
        raise ValueError(
            f"unknown policy {name!r}; known: {sorted(POLICIES)} "
            f"(aliases: {sorted(ALIASES)}; combinator: admit(<policy>,...))")
    cls = POLICIES[name]
    return cls(**build_kwargs("policy", name, cls.__init__, argstr))


from .admission import AdmissionPolicy  # noqa: E402  (needs make_policy)

__all__ = [
    "AdaptiveClimb", "AdmissionPolicy", "DynamicAdaptiveClimb",
    "ARC", "BLRU", "Clock", "Climb", "FIFO", "Hyperbolic", "LFU", "LHD",
    "LIRS", "LRU", "Sieve", "TinyLFU", "TwoQ",
    "EMPTY", "LANE", "Plan", "Policy", "RankPolicy", "Request", "StepInfo",
    "step_info", "rank_step", "lane_pad", "padded_row",
    "POLICIES", "ALIASES", "make_policy",
    "Engine", "Metrics", "ReplayResult", "replay_lanes", "miss_ratio", "mrr",
]
