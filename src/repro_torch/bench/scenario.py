"""Declarative experiment descriptions: Scenario and Sweep (the port's copy
of the reference's ``bench/scenario.py``, whole: the tier, fleet and serve
scenarios and sweeps are plain data here, and ``to_config()`` gives the
reference's output; ``k_for`` and the regime fractions live in
:mod:`repro_torch.data.traces` and are re-exported).

A :class:`Scenario` is one workload cell — a trace spec string, an optional
object-size/fetch-cost model, and the cache-capacity regime.  A
:class:`Sweep` is the full grid the paper evaluates: policies x scenarios x
capacities x seeds.  Both are plain frozen dataclasses that round-trip to
JSON-able config dicts, so an experiment is data: the sweep config rides
inside the result payload and fully determines the run.

Size and cost models are spec strings over small registries (mirroring
policies and traces)::

    Scenario("wiki", trace="shifting_zipf(N=4096,alpha=0.9,phases=4)",
             T=60_000, K=(64, 256),
             size_model="lognormal(median_kb=16,sigma=1.5)",
             cost_model="fetch(base_ms=2.0,per_mb_ms=8.0)")

Capacity entries are either explicit ints or the paper's regime letters
``"S"`` / ``"L"`` (Section V-B: 0.1% / 10% of the trace's id footprint),
resolved against ``make_trace(trace).n_keys``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..data.traces import (LARGE_FRAC, SMALL_FRAC, TraceSpec, bimodal_sizes,
                           fetch_costs, k_for, make_trace, object_sizes)
from ..specs import build_kwargs, parse_spec

__all__ = [
    "Scenario", "Sweep", "TierScenario", "TierSweep",
    "FleetScenario", "FleetSweep", "ServeScenario",
    "SIZE_MODELS", "COST_MODELS", "SMALL_FRAC", "LARGE_FRAC", "k_for",
]

SIZE_MODELS = {"lognormal": object_sizes, "bimodal": bimodal_sizes}
COST_MODELS = {"fetch": fetch_costs}


def _model_fn(registry: dict, kind: str, spec: str, skip: tuple):
    name, argstr = parse_spec(spec)
    if name not in registry:
        raise ValueError(
            f"unknown {kind} model {name!r}; known: {sorted(registry)}")
    fn = registry[name]
    return fn, build_kwargs(f"{kind} model", name, fn, argstr, skip=skip)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One workload: trace spec + size/cost model + capacity regime.

    >>> sc = Scenario("wiki", trace="wiki", T=1000, K=("S", 256))
    >>> sc.trace                        # canonicalized at construction
    'shifting_zipf(N=8192,alpha=0.9,phases=4)'
    >>> sc.capacities()                 # "S" resolved vs the id footprint
    (8, 256)
    >>> Scenario.from_config(sc.to_config()) == sc
    True
    """

    name: str
    trace: str                  # trace spec string (data.make_trace)
    T: int
    K: tuple = (256,)           # ints and/or regime letters "S"/"L"
    size_model: str | None = None   # e.g. "lognormal(median_kb=16)"
    cost_model: str | None = None   # e.g. "fetch(base_ms=2.0)"; needs sizes

    def __post_init__(self):
        # normalize: canonical trace string, K always a tuple
        spec = make_trace(self.trace)
        if spec.is_tier:
            raise ValueError(
                f"scenario {self.name!r}: {spec.family!r} is a multi-tenant "
                "trace family — use TierScenario (tier workloads)")
        if spec.is_fleet:
            raise ValueError(
                f"scenario {self.name!r}: {spec.family!r} is a dynamic-"
                "fleet trace family — use FleetScenario (fleet "
                "workloads)")
        if spec.is_file:
            # real traces carry their own sizes/costs; validate the file
            # (and its length vs T) eagerly, like every other spec error
            if self.size_model is not None or self.cost_model is not None:
                raise ValueError(
                    f"scenario {self.name!r}: file-backed traces source "
                    "sizes/costs from the trace file — size_model/"
                    "cost_model do not apply")
            # the cheap length check (O(1) for uncompressed oracle) —
            # full characterization stats stay lazy until capacities()
            # resolves an "S"/"L" regime against the id footprint
            n = spec.n_requests
            if self.T > n:
                raise ValueError(
                    f"scenario {self.name!r}: T={self.T} exceeds the "
                    f"{n} requests in {spec.kwargs['path']!r}")
        object.__setattr__(self, "trace", str(spec))
        K = self.K if isinstance(self.K, (tuple, list)) else (self.K,)
        object.__setattr__(self, "K", tuple(K))
        if self.cost_model is not None and self.size_model is None:
            raise ValueError(
                f"scenario {self.name!r}: cost_model requires a size_model "
                "(fetch costs are a function of object sizes)")
        # validate both model specs eagerly (parse only — no table is built)
        if self.size_model is not None:
            _model_fn(SIZE_MODELS, "size", self.size_model,
                      skip=("n_objects",))
        if self.cost_model is not None:
            _model_fn(COST_MODELS, "cost", self.cost_model,
                      skip=("sizes_bytes",))

    def trace_spec(self) -> TraceSpec:
        return make_trace(self.trace)

    def capacities(self) -> tuple:
        """K entries with regime letters resolved against the trace's id
        footprint."""
        n = self.trace_spec().n_keys
        return tuple(k_for(n, k) if isinstance(k, str) else int(k)
                     for k in self.K)

    def k_label(self, K) -> str:
        """Display label for one K entry ("S"/"L" or the number)."""
        return K if isinstance(K, str) else str(int(K))

    def size_table(self) -> np.ndarray | None:
        """Per-object-id size table ``[n_keys]`` (bytes), or ``None`` for
        the unit-object model."""
        if self.size_model is None:
            return None
        fn, kw = _model_fn(SIZE_MODELS, "size", self.size_model,
                           skip=("n_objects",))
        return fn(n_objects=self.trace_spec().n_keys, **kw)

    def cost_table(self, sizes: np.ndarray) -> np.ndarray | None:
        """Per-object-id miss-cost table aligned with ``sizes``."""
        if self.cost_model is None:
            return None
        fn, kw = _model_fn(COST_MODELS, "cost", self.cost_model,
                           skip=("sizes_bytes",))
        return fn(sizes, **kw)

    def to_config(self) -> dict:
        return {"name": self.name, "trace": self.trace, "T": self.T,
                "K": list(self.K), "size_model": self.size_model,
                "cost_model": self.cost_model}

    @classmethod
    def from_config(cls, cfg: dict) -> "Scenario":
        return cls(name=cfg["name"], trace=cfg["trace"], T=cfg["T"],
                   K=tuple(cfg["K"]), size_model=cfg.get("size_model"),
                   cost_model=cfg.get("cost_model"))


@dataclasses.dataclass(frozen=True)
class TierScenario:
    """One multi-tenant workload: a tier trace spec (``tenants(...)``)
    plus the shared budget(s) and optional size/cost models.

    ``budget`` entries are explicit ints or the regime letters ``"S"`` /
    ``"L"``, resolved against the *total* id footprint (``n_tenants x
    n_keys``) exactly like :func:`k_for`.  ``k0`` overrides each tenant's
    initial active size (default: the policy's own headroom rule, see
    the tier layer's ``CacheTier``, ROADMAP A9).

    >>> sc = TierScenario("flux", trace="tenants(N=256,n_tenants=4)",
    ...                   T=1000, budget=(64, "S"))
    >>> sc.budgets()
    (64, 16)
    >>> sc.n_tenants
    4
    """

    name: str
    trace: str                  # tier trace spec (data.make_trace)
    T: int
    budget: tuple = (256,)      # ints and/or regime letters "S"/"L"
    k0: int | None = None
    size_model: str | None = None
    cost_model: str | None = None

    def __post_init__(self):
        spec = make_trace(self.trace)
        if not spec.is_tier:
            raise ValueError(
                f"tier scenario {self.name!r} needs a multi-tenant trace "
                f"family, got {spec.family!r} — use Scenario for those")
        object.__setattr__(self, "trace", str(spec))
        b = self.budget if isinstance(self.budget, (tuple, list)) \
            else (self.budget,)
        object.__setattr__(self, "budget", tuple(b))
        if self.cost_model is not None and self.size_model is None:
            raise ValueError(
                f"tier scenario {self.name!r}: cost_model requires a "
                "size_model")
        if self.size_model is not None:
            _model_fn(SIZE_MODELS, "size", self.size_model,
                      skip=("n_objects",))
        if self.cost_model is not None:
            _model_fn(COST_MODELS, "cost", self.cost_model,
                      skip=("sizes_bytes",))

    def trace_spec(self) -> TraceSpec:
        return make_trace(self.trace)

    @property
    def n_tenants(self) -> int:
        return self.trace_spec().n_tenants

    def budgets(self) -> tuple:
        """Budget entries with regime letters resolved against the total
        footprint (``n_tenants * n_keys``), floored at four slots per
        tenant (room for every tenant's initial active size — the same
        floor :func:`k_for` applies to a single cache)."""
        spec = self.trace_spec()
        total = spec.n_tenants * spec.n_keys
        return tuple(max(4 * self.n_tenants, k_for(total, b))
                     if isinstance(b, str) else int(b)
                     for b in self.budget)

    def budget_label(self, b) -> str:
        return b if isinstance(b, str) else str(int(b))

    def size_table(self) -> np.ndarray | None:
        """Per-object-id size table ``[n_keys]`` (bytes), shared by every
        tenant (they address the same id space through private hot-set
        permutations)."""
        if self.size_model is None:
            return None
        fn, kw = _model_fn(SIZE_MODELS, "size", self.size_model,
                           skip=("n_objects",))
        return fn(n_objects=self.trace_spec().n_keys, **kw)

    def cost_table(self, sizes: np.ndarray) -> np.ndarray | None:
        if self.cost_model is None:
            return None
        fn, kw = _model_fn(COST_MODELS, "cost", self.cost_model,
                           skip=("sizes_bytes",))
        return fn(sizes, **kw)

    def to_config(self) -> dict:
        return {"name": self.name, "trace": self.trace, "T": self.T,
                "budget": list(self.budget), "k0": self.k0,
                "size_model": self.size_model,
                "cost_model": self.cost_model}

    @classmethod
    def from_config(cls, cfg: dict) -> "TierScenario":
        return cls(name=cfg["name"], trace=cfg["trace"], T=cfg["T"],
                   budget=tuple(cfg["budget"]), k0=cfg.get("k0"),
                   size_model=cfg.get("size_model"),
                   cost_model=cfg.get("cost_model"))


@dataclasses.dataclass(frozen=True)
class TierSweep:
    """The tier evaluation grid: (policy, arbiter) entries x tier
    scenarios x budgets x seeds.

    Each ``entries`` element is a ``(policy_spec, arbiter_spec)`` pair —
    e.g. ``("dac", "greedy")`` for the arbitrated tier,
    ``("lru", "static")`` for a statically-partitioned baseline.

    >>> sw = TierSweep("demo", entries=(("dac", "greedy"),),
    ...                scenarios=(TierScenario(
    ...                    "flux", trace="tenants(N=256,n_tenants=2)",
    ...                    T=500),))
    >>> TierSweep.from_config(sw.to_config()) == sw
    True
    """

    name: str
    entries: tuple              # of (policy_spec, arbiter_spec) pairs
    scenarios: tuple            # of TierScenario
    seeds: tuple = (0,)
    # (no `observe` knob: tier records always carry per-tenant time-mean
    # occupancy `avg_k`; the per-step trace is a replay_tier concern)

    def __post_init__(self):
        object.__setattr__(
            self, "entries",
            tuple((str(p), str(a)) for p, a in self.entries))
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        if not self.entries:
            raise ValueError("tier sweep needs at least one (policy, "
                             "arbiter) entry")
        if not self.scenarios:
            raise ValueError("tier sweep needs at least one scenario")
        if not self.seeds:
            raise ValueError("tier sweep needs at least one seed")
        names = [sc.name for sc in self.scenarios]
        if len(set(names)) != len(names):
            raise ValueError(f"scenario names must be unique, got {names}")

    def cells(self):
        """Iterate the grid: (policy, arbiter, scenario, budget, label)."""
        for sc in self.scenarios:
            for b_spec, B in zip(sc.budget, sc.budgets()):
                for pol, arb in self.entries:
                    yield pol, arb, sc, B, sc.budget_label(b_spec)

    def to_config(self) -> dict:
        return {"name": self.name,
                "entries": [list(e) for e in self.entries],
                "scenarios": [sc.to_config() for sc in self.scenarios],
                "seeds": list(self.seeds)}

    @classmethod
    def from_config(cls, cfg: dict) -> "TierSweep":
        return cls(name=cfg["name"],
                   entries=tuple(tuple(e) for e in cfg["entries"]),
                   scenarios=tuple(TierScenario.from_config(s)
                                   for s in cfg["scenarios"]),
                   seeds=tuple(cfg["seeds"]))


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """One dynamic-fleet workload: a ``fleet(...)`` trace spec (tenant
    arrivals/departures encoded as ``-1`` lane entries) plus the global
    budget(s) and optional size/cost models.

    ``budget`` entries are explicit ints or the regime letters ``"S"`` /
    ``"L"``, resolved against the total id footprint (``n_lanes x
    n_keys``) and floored at four slots per lane, exactly like
    :class:`TierScenario`.  ``k0`` overrides the admission target;
    ``util_decay`` sets the byte-miss-cost EWMA the auction arbiter
    prices by (see the fleet layer's ``FleetTier``, ROADMAP A10).

    >>> sc = FleetScenario("pool", trace="fleet(N=256,n_lanes=4)",
    ...                    T=1000, budget=(64, "S"))
    >>> sc.budgets()
    (64, 16)
    >>> sc.n_lanes
    4
    >>> FleetScenario.from_config(sc.to_config()) == sc
    True
    """

    name: str
    trace: str                  # fleet trace spec (data.make_trace)
    T: int
    budget: tuple = (256,)      # ints and/or regime letters "S"/"L"
    k0: int | None = None
    util_decay: float = 0.98
    size_model: str | None = None
    cost_model: str | None = None

    def __post_init__(self):
        spec = make_trace(self.trace)
        if not spec.is_fleet:
            raise ValueError(
                f"fleet scenario {self.name!r} needs a dynamic-fleet trace "
                f"family, got {spec.family!r} — use TierScenario/Scenario "
                "for fixed-population workloads")
        object.__setattr__(self, "trace", str(spec))
        b = self.budget if isinstance(self.budget, (tuple, list)) \
            else (self.budget,)
        object.__setattr__(self, "budget", tuple(b))
        if self.cost_model is not None and self.size_model is None:
            raise ValueError(
                f"fleet scenario {self.name!r}: cost_model requires a "
                "size_model")
        if self.size_model is not None:
            _model_fn(SIZE_MODELS, "size", self.size_model,
                      skip=("n_objects",))
        if self.cost_model is not None:
            _model_fn(COST_MODELS, "cost", self.cost_model,
                      skip=("sizes_bytes",))

    def trace_spec(self) -> TraceSpec:
        return make_trace(self.trace)

    @property
    def n_lanes(self) -> int:
        return self.trace_spec().n_tenants

    def budgets(self) -> tuple:
        """Budget entries with regime letters resolved against the total
        footprint (``n_lanes * n_keys``), floored at four slots per lane
        (admission needs every lane to fit at the floor)."""
        spec = self.trace_spec()
        total = spec.n_tenants * spec.n_keys
        return tuple(max(4 * self.n_lanes, k_for(total, b))
                     if isinstance(b, str) else int(b)
                     for b in self.budget)

    def budget_label(self, b) -> str:
        return b if isinstance(b, str) else str(int(b))

    def size_table(self) -> np.ndarray | None:
        """Per-object-id size table ``[n_keys]`` (bytes), shared by every
        session (sessions address the same id space through private
        hot-set permutations)."""
        if self.size_model is None:
            return None
        fn, kw = _model_fn(SIZE_MODELS, "size", self.size_model,
                           skip=("n_objects",))
        return fn(n_objects=self.trace_spec().n_keys, **kw)

    def cost_table(self, sizes: np.ndarray) -> np.ndarray | None:
        if self.cost_model is None:
            return None
        fn, kw = _model_fn(COST_MODELS, "cost", self.cost_model,
                           skip=("sizes_bytes",))
        return fn(sizes, **kw)

    def to_config(self) -> dict:
        return {"name": self.name, "trace": self.trace, "T": self.T,
                "budget": list(self.budget), "k0": self.k0,
                "util_decay": self.util_decay,
                "size_model": self.size_model,
                "cost_model": self.cost_model}

    @classmethod
    def from_config(cls, cfg: dict) -> "FleetScenario":
        return cls(name=cfg["name"], trace=cfg["trace"], T=cfg["T"],
                   budget=tuple(cfg["budget"]), k0=cfg.get("k0"),
                   util_decay=cfg.get("util_decay", 0.98),
                   size_model=cfg.get("size_model"),
                   cost_model=cfg.get("cost_model"))


@dataclasses.dataclass(frozen=True)
class FleetSweep:
    """The fleet evaluation grid: (policy, arbiter) entries x fleet
    scenarios x budgets x seeds — the dynamic-lifecycle analogue of
    :class:`TierSweep` (e.g. ``("dac", "auction")`` for the priced pool,
    ``("lru", "static")`` for a fixed-partition baseline).

    >>> sw = FleetSweep("demo", entries=(("dac", "auction"),),
    ...                 scenarios=(FleetScenario(
    ...                     "pool", trace="fleet(N=256,n_lanes=4)",
    ...                     T=500),))
    >>> FleetSweep.from_config(sw.to_config()) == sw
    True
    """

    name: str
    entries: tuple              # of (policy_spec, arbiter_spec) pairs
    scenarios: tuple            # of FleetScenario
    seeds: tuple = (0,)

    def __post_init__(self):
        object.__setattr__(
            self, "entries",
            tuple((str(p), str(a)) for p, a in self.entries))
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        if not self.entries:
            raise ValueError("fleet sweep needs at least one (policy, "
                             "arbiter) entry")
        if not self.scenarios:
            raise ValueError("fleet sweep needs at least one scenario")
        if not self.seeds:
            raise ValueError("fleet sweep needs at least one seed")
        names = [sc.name for sc in self.scenarios]
        if len(set(names)) != len(names):
            raise ValueError(f"scenario names must be unique, got {names}")

    def cells(self):
        """Iterate the grid: (policy, arbiter, scenario, budget, label)."""
        for sc in self.scenarios:
            for b_spec, B in zip(sc.budget, sc.budgets()):
                for pol, arb in self.entries:
                    yield pol, arb, sc, B, sc.budget_label(b_spec)

    def to_config(self) -> dict:
        return {"name": self.name,
                "entries": [list(e) for e in self.entries],
                "scenarios": [sc.to_config() for sc in self.scenarios],
                "seeds": list(self.seeds)}

    @classmethod
    def from_config(cls, cfg: dict) -> "FleetSweep":
        return cls(name=cfg["name"],
                   entries=tuple(tuple(e) for e in cfg["entries"]),
                   scenarios=tuple(FleetScenario.from_config(s)
                                   for s in cfg["scenarios"]),
                   seeds=tuple(cfg["seeds"]))


@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """One serving-path workload: a model architecture greedily decoded
    with the paper's policy as the bounded KV-cache manager
    (``repro_torch.serving``), swept over KV slot budgets.

    There is no trace spec — the "requests" are the attention reads of a
    seeded random prompt plus ``gen`` decoded tokens — but the cell grid
    is declarative like every other scenario: ``budget_frac`` entries
    scale the exact-cache footprint (``prompt + gen`` positions, the
    serving analogue of the id footprint) and ``budgets()`` resolves them
    to slot counts, floored at four slots like :func:`k_for`.

    >>> sc = ServeScenario("kv", arch="deepseek-7b", prompt=96, gen=32)
    >>> sc.budgets()
    (128, 96, 64, 32)
    >>> sc.budget_label(0.75)
    '75%'
    >>> ServeScenario.from_config(sc.to_config()) == sc
    True
    """

    name: str
    arch: str = "deepseek-7b"
    batch: int = 2
    prompt: int = 96
    gen: int = 32
    budget_frac: tuple = (1.0, 0.75, 0.5, 0.25)

    def __post_init__(self):
        # lazy import: the serving path is optional for trace-only users
        from ..configs import SMOKE_ARCHS
        if self.arch not in SMOKE_ARCHS:
            raise ValueError(
                f"serve scenario {self.name!r}: unknown arch "
                f"{self.arch!r}; known: {sorted(SMOKE_ARCHS)}")
        if min(self.batch, self.prompt, self.gen) < 1:
            raise ValueError(
                f"serve scenario {self.name!r}: batch/prompt/gen must be "
                "positive")
        f = self.budget_frac if isinstance(self.budget_frac, (tuple, list)) \
            else (self.budget_frac,)
        fracs = tuple(float(x) for x in f)
        for x in fracs:
            if not 0.0 < x <= 1.0:
                raise ValueError(
                    f"serve scenario {self.name!r}: budget fractions must "
                    f"lie in (0, 1], got {x}")
        object.__setattr__(self, "budget_frac", fracs)

    @property
    def total(self) -> int:
        """Exact-cache footprint: every prompt + decoded position held."""
        return self.prompt + self.gen

    def budgets(self) -> tuple:
        """Budget fractions resolved to slot counts against the exact
        footprint, floored at four slots."""
        return tuple(max(4, int(self.total * f)) for f in self.budget_frac)

    def budget_label(self, f) -> str:
        """Display label for one fraction (percent of the exact cache)."""
        return f"{f:.0%}"

    def to_config(self) -> dict:
        return {"name": self.name, "arch": self.arch, "batch": self.batch,
                "prompt": self.prompt, "gen": self.gen,
                "budget_frac": list(self.budget_frac)}

    @classmethod
    def from_config(cls, cfg: dict) -> "ServeScenario":
        return cls(name=cfg["name"], arch=cfg["arch"],
                   batch=cfg.get("batch", 2), prompt=cfg["prompt"],
                   gen=cfg["gen"],
                   budget_frac=tuple(cfg["budget_frac"]))


@dataclasses.dataclass(frozen=True)
class Sweep:
    """The evaluation grid: policies x scenarios x capacities x seeds.

    ``policies`` are ``make_policy`` spec strings; ``seeds`` is the axis
    the runner vmaps inside one jitted replay per (policy, scenario, K)
    cell; ``observe=True`` additionally collects policy observables (e.g.
    DAC's adapted size) and reports their per-seed time means.

    >>> sw = Sweep("demo", policies=("lru", "dac"),
    ...            scenarios=(Scenario("z", trace="zipf(N=64,alpha=1.0)",
    ...                                T=100, K=(8,)),), seeds=(0, 1))
    >>> [(pol, K) for pol, _, K, _ in sw.cells()]
    [('lru', 8), ('dac', 8)]
    >>> Sweep.from_config(sw.to_config()) == sw
    True
    """

    name: str
    policies: tuple
    scenarios: tuple
    seeds: tuple = (0,)
    observe: bool = False

    def __post_init__(self):
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        if not self.policies:
            raise ValueError("sweep needs at least one policy")
        if not self.scenarios:
            raise ValueError("sweep needs at least one scenario")
        if not self.seeds:
            raise ValueError("sweep needs at least one seed")
        names = [sc.name for sc in self.scenarios]
        if len(set(names)) != len(names):
            raise ValueError(
                f"scenario names must be unique, got {names}")

    def cells(self):
        """Iterate the grid: (policy_spec, scenario, K_int, K_label)."""
        for sc in self.scenarios:
            for k_spec, K in zip(sc.K, sc.capacities()):
                for pol in self.policies:
                    yield pol, sc, K, sc.k_label(k_spec)

    def to_config(self) -> dict:
        return {"name": self.name, "policies": list(self.policies),
                "scenarios": [sc.to_config() for sc in self.scenarios],
                "seeds": list(self.seeds), "observe": self.observe}

    @classmethod
    def from_config(cls, cfg: dict) -> "Sweep":
        return cls(name=cfg["name"], policies=tuple(cfg["policies"]),
                   scenarios=tuple(Scenario.from_config(s)
                                   for s in cfg["scenarios"]),
                   seeds=tuple(cfg["seeds"]),
                   observe=cfg.get("observe", False))
