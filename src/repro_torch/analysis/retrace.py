"""Retrace audit: what an engine call builds, captures and launches
(port of ``repro/analysis/retrace.py``).

The reference counts entries in ``jax.jit``'s compilation cache.  The
port has no jit; its counterparts of a compiled program are the **CUDA
graphs the graph loop captures** (``core/simulator.py::_capture``: one a
slot policy's replay, over ``GRAPH_CHUNK`` steps), the **launches of
kernel B1** (``kernels/policy_step.py::LAUNCHES``: one a rank policy's
replay) and the **builds and loads of B1's library**
(``kernels/_build.py::build`` / ``load``).  On the CPU nothing captures
or builds; there the counterpart of a recompile is a different step
program, and :class:`StepPrograms` counts the distinct op sequences (op,
dtypes, shapes) of the step bodies that the graph loop or B1 would run,
leaving ``Request.of``'s ingest out: a list of Python ints or int64 keys
adds one cast at ingest, which is not a second program.

Each counter is installed for the audit's duration only (a wrapper
restored in a ``finally``); the main path has no counter of its own.  A
variant, the same request stream spelled differently, may grow each count
by what its canonical call grows it (a replay of a slot policy captures
its graph anew each call), and no more.

The nine canonical calls of :func:`audit_engine` (``T`` reaches a graph:
two chunks of ``GRAPH_CHUNK`` steps and a tail):

=======================  ==================================================
``replay`` ``[T]``       default / ``collect_info=False`` / ``observe=True``
                         / the CPU engine (the plain versions, for the
                         reference's ``use_pallas="interpret"``)
``replay`` ``[B, T]``    default / ``collect_info=False`` / the CPU engine
``replay_stream``        ``[T]`` / ``[B, T]``
=======================  ==================================================

>>> import numpy as np, torch
>>> from repro_torch.analysis.retrace import StepPrograms, audit_jit
>>> programs = StepPrograms()
>>> f = programs.track(lambda x, s: x * torch.tensor(s))
>>> x = torch.ones(3, dtype=torch.int32)
>>> audit_jit({"programs": programs}, "toy",
...           prime=[("i32", lambda: f(x, np.int32(2)))],
...           variants=[("same-dtype", lambda: f(x, np.int32(5)))])
[]
>>> bad = audit_jit({"programs": programs}, "toy",
...                 prime=[("i32", lambda: f(x, np.int32(2)))],
...                 variants=[("python-int", lambda: f(x, 2))])
>>> [b.rule for b in bad]
['retrace']
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import make_policy, simulator
from ..core.simulator import GRAPH_CHUNK, Engine
from ..kernels import _build, policy_step
from .contracts import Record
from .findings import Finding

__all__ = ["StepPrograms", "GraphCaptures", "KernelLaunches",
           "KernelLoads", "KernelBuilds", "engine_counters",
           "cache_entries", "audit_jit", "audit_engine", "ENGINE_EXPECTED"]


class Counter:
    """A count the audit reads around each call; ``clear`` starts it
    from zero and ``installed`` puts its wrapper in place."""

    def clear(self):
        raise NotImplementedError

    def __call__(self) -> int:
        raise NotImplementedError

    @contextlib.contextmanager
    def installed(self):
        yield self


def _signature(ops):
    return tuple((func, tuple((t.dtype, t.shape) for _, t in ins),
                  tuple((t.dtype, t.shape) for t in outs))
                 for func, ins, outs in ops)


class StepPrograms(Counter):
    """Distinct step programs run on the CPU: the op sequence of each
    step body ``run_steps`` drives (slot policies, ``admit(...)``) and of
    each call of B1's plain version (``policy_replay`` on CPU tensors)."""

    def __init__(self):
        self.seen = set()
        self._depth = 0

    def clear(self):
        self.seen.clear()

    def __call__(self):
        return len(self.seen)

    def track(self, fn):
        """``fn`` with the op sequence of each outermost call recorded."""
        def tracked(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth += 1
            try:
                with Record() as rec:
                    out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            self.seen.add(_signature(rec.ops))
            return out
        return tracked

    @contextlib.contextmanager
    def installed(self):
        run_steps, replay = simulator.run_steps, policy_step.policy_replay

        def run_steps_cpu(run, reqs, *args, **kwargs):
            if reqs.key.device.type == "cpu":
                run = self.track(run)
            return run_steps(run, reqs, *args, **kwargs)

        tracked = self.track(replay)

        def replay_cpu(cache, *args, **kwargs):
            fn = tracked if cache.device.type == "cpu" else replay
            return fn(cache, *args, **kwargs)

        simulator.run_steps = run_steps_cpu
        policy_step.policy_replay = replay_cpu
        try:
            yield self
        finally:
            simulator.run_steps = run_steps
            policy_step.policy_replay = replay


class GraphCaptures(Counter):
    """CUDA graphs the graph loop captures (``simulator._capture``)."""

    def __init__(self):
        self.n = 0

    def clear(self):
        self.n = 0

    def __call__(self):
        return self.n

    @contextlib.contextmanager
    def installed(self):
        capture = simulator._capture

        def counted(body):
            self.n += 1
            return capture(body)

        simulator._capture = counted
        try:
            yield self
        finally:
            simulator._capture = capture


class KernelLaunches(Counter):
    """Launches of kernel B1 (``policy_step.LAUNCHES``)."""

    def __init__(self):
        self.base = 0

    def _launches(self):
        return policy_step.LAUNCHES

    def clear(self):
        self.base = self._launches()

    def __call__(self):
        return self._launches() - self.base


class KernelLoads(Counter):
    """Loads of a kernel library (misses of ``_build.load``'s cache);
    ``clear`` empties that cache and B1's handle on it, as jit's
    ``_clear_cache`` empties the reference's."""

    def __init__(self):
        self.base = 0

    def _misses(self):
        return _build.load.cache_info().misses

    def clear(self):
        policy_step._lib.cache_clear()
        _build.load.cache_clear()
        self.base = self._misses()

    def __call__(self):
        return self._misses() - self.base


class KernelBuilds(Counter):
    """Sources ``nvcc`` compiled (``_build.build``); a build happens once
    a source per checkout, so priming may build or find it built."""

    def __init__(self):
        self.n = 0

    def clear(self):
        self.n = 0

    def __call__(self):
        return self.n

    @contextlib.contextmanager
    def installed(self):
        build = _build.build

        def counted(names):
            reports = build(names)
            self.n += len(reports)
            return reports

        _build.build = counted
        try:
            yield self
        finally:
            _build.build = build


def engine_counters():
    """A fresh set of the engine's counters, by name."""
    return {"captures": GraphCaptures(), "launches": KernelLaunches(),
            "loads": KernelLoads(), "builds": KernelBuilds(),
            "programs": StepPrograms()}


# counts after priming the nine canonical calls, by policy name and device
# (None: not fixed).  On the card a replay of dac is one B1 launch and
# captures nothing; a replay of lru captures one graph and launches
# nothing; dac loads B1's library once.  The two CPU-engine calls run two
# step programs ([1, T] and [2, T] with per-step info).  On the CPU dac
# runs five programs (per-step info, totals only, info and observables,
# each on [1, T]; info and totals on [2, T]; the streams are the totals'),
# lru four (it has no observables, so observe=True runs the default's).
ENGINE_EXPECTED = {
    "dynamicadaptiveclimb": {
        "cuda": {"captures": 0, "launches": 7, "loads": 1, "builds": None,
                 "programs": 2},
        "cpu": {"captures": 0, "launches": 0, "loads": 0, "builds": 0,
                "programs": 5},
    },
    "lru": {
        "cuda": {"captures": 7, "launches": 0, "loads": 0, "builds": 0,
                 "programs": 2},
        "cpu": {"captures": 0, "launches": 0, "loads": 0, "builds": 0,
                "programs": 4},
    },
}


def cache_entries(counter):
    """A counter's current count (the port's ``jit._cache_size()``).

    >>> programs = StepPrograms()
    >>> double = programs.track(lambda x: x * 2)
    >>> import torch
    >>> _ = double(torch.ones(2, dtype=torch.int32))
    >>> cache_entries(programs)
    1
    """
    return counter()


def audit_jit(counters, label, prime, variants, expected=None,
              report=None):
    """Clear ``counters`` (``{name: Counter}``), run the ``prime`` calls,
    then verify that no ``variants`` call grows a count by more than its
    canonical call does (and, when ``expected`` gives a count, that
    priming reached exactly that many).

    ``prime`` is a list of ``(name, thunk)``; ``variants`` of ``(name,
    thunk)`` (a cache-like count: it may not grow at all) or ``(name,
    thunk, canonical_thunk)``, the canonical call run just before to
    measure what each count may grow by.  Returns findings; empty means
    the equivalent spellings cost what the canonical ones do.  A
    ``report`` dict receives each count after priming.
    """
    expected = expected or {}
    findings = []
    with contextlib.ExitStack() as stack:
        for c in counters.values():
            stack.enter_context(c.installed())
            c.clear()
        for _, thunk in prime:
            thunk()
        if report is not None:
            report.update((name, c()) for name, c in counters.items())
        for name, c in counters.items():
            want = expected.get(name)
            if want is not None and c() != want:
                findings.append(Finding(
                    "retrace-count", f"{label}.{name}",
                    f"priming counted {c()} {name}, expected {want} — a "
                    "canonical call either re-ran its build/capture or "
                    "collapsed into another"))
        for vname, thunk, *canonical in variants:
            allow = dict.fromkeys(counters, 0)
            if canonical:
                before = {n: c() for n, c in counters.items()}
                canonical[0]()
                allow = {n: c() - before[n] for n, c in counters.items()}
            before = {n: c() for n, c in counters.items()}
            thunk()
            for name, c in counters.items():
                grew = c() - before[name]
                if grew != allow[name]:
                    findings.append(Finding(
                        "retrace", f"{label}.{name}",
                        f"equivalence variant {vname!r} grew {name} by "
                        f"{grew}, its canonical call by {allow[name]}"))
    return findings


def audit_engine(policy="dac", K=8, T=2 * GRAPH_CHUNK + 3, device="cuda"):
    """Audit ``Engine(device=device)`` across the nine canonical calls and
    the reference's six equivalence variants.

    Returns ``(findings, report)``, ``report`` mapping each counter to its
    count after priming.  ``T`` defaults to two graph chunks and a tail.
    """
    eng, plain = Engine(device=device), Engine(device="cpu")
    keys1 = (np.arange(T) % 5).astype(np.int32)
    keys2 = np.stack([keys1, (keys1 + 3) % 7]).astype(np.int32)

    def single():
        return eng.replay(policy, keys1, K)

    def stream():
        return eng.replay_stream(policy, keys1, K)

    prime = [
        ("single", single),
        ("single/metrics-only",
         lambda: eng.replay(policy, keys1, K, collect_info=False)),
        ("single/observe",
         lambda: eng.replay(policy, keys1, K, observe=True)),
        ("single/cpu", lambda: plain.replay(policy, keys1, K)),
        ("batched", lambda: eng.replay(policy, keys2, K)),
        ("batched/metrics-only",
         lambda: eng.replay(policy, keys2, K, collect_info=False)),
        ("batched/cpu", lambda: plain.replay(policy, keys2, K)),
        ("stream[T]", stream),
        ("stream[B,T]", lambda: eng.replay_stream(policy, keys2, K)),
    ]
    # the same requests spelled differently: none may cost more
    variants = [
        ("python-list keys",
         lambda: eng.replay(policy, [int(x) for x in keys1], K), single),
        ("tensor keys", lambda: eng.replay(policy, torch.as_tensor(keys1),
                                           K), single),
        ("np.int32 capacity",
         lambda: eng.replay(policy, keys1, np.int32(K)), single),
        ("explicit unit sizes/costs",
         lambda: eng.replay(policy, keys1, K, sizes=1, costs=1.0), single),
        ("fresh equal policy instance",
         lambda: eng.replay(make_policy(policy), keys1, K), single),
        ("explicit stream chunk",
         lambda: eng.replay_stream(policy, keys1, K, chunk=T), stream),
    ]
    counters = engine_counters()
    expected = ENGINE_EXPECTED.get(make_policy(policy).name, {}).get(
        torch.device(device).type)
    report = {}
    findings = audit_jit(counters, f"engine[{policy}@{device}]", prime,
                         variants, expected, report)
    return findings, report
