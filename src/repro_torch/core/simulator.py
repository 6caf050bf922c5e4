"""Trace-replay engine (port of ``core/simulator.py``).

::

    result = Engine(device="cuda").replay(policy, requests, K)

``requests`` is a :class:`~repro_torch.core.policy.Request` or bare keys,
of shape ``[T]`` or ``[B, T]``; the ``B`` lanes are independent caches.
Hit, byte-miss and penalty totals are reduced on the device per lane.

On CUDA the three rank policies replay a whole ``[B, T]`` block in **one
kernel launch** (``kernels.policy_step.policy_replay``: the time loop runs
inside the kernel, in place of the reference's ``lax.scan``).  The twelve
slot policies are plain torch over the lane axis, as the reference has no
kernel for them; on CUDA their time loop is a CUDA graph of ``chunk``
steps (the step plus the metric accumulation, or the writes of each step's
info), captured once per replay over a static ``[B, chunk]`` request
buffer and replayed once per chunk, with the last ``T % chunk`` steps run
eagerly: the counterpart of ``lax.scan`` compiling the step into one
device loop.  The same loop (:func:`run_steps`) drives the admission
wrapper, whose rank bases launch kernel B1 once a step inside the graph,
and the tier's and the fleet's steps (``Engine.replay_tier``,
``Engine.replay_fleet``: DAC's budgeted plan in B1 over all tenants, then
the arbiter).  A capture that fails raises; nothing falls back to the
eager loop.  On the CPU every policy runs the plain loop (the rank
policies the kernel's plain version).

Counts (``requests``/``hits``) are int64 (the reference counts in int32
unless x64 is on; torch has no such switch).  Byte and cost totals are
float32: summed step by step in the reference's order with
``collect_info=False``, and by ``torch.sum`` over the stacked per-step
info with ``collect_info=True`` (the reference uses ``jnp.sum`` there,
whose order XLA chooses).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .policy import Policy, RankPolicy, Request, StepInfo

__all__ = ["Engine", "Metrics", "ReplayResult", "replay_lanes", "run_steps",
           "miss_ratio", "mrr", "GRAPH_CHUNK"]

# steps per CUDA graph of a slot policy's replay: on an H100 32 steps ran
# within 2% of 16 for most slot policies, from 4% slower to 34% faster
# than 128, and 512 ran 1.4-2.8x slower (PERF.md; graph_sweep.py times
# the sizes)
GRAPH_CHUNK = 32


class Metrics(NamedTuple):
    """Per-lane replay totals: int64 counts, float32 byte/cost totals
    (float64 host totals from :meth:`Engine.replay_stream`).

    >>> m = Engine(device="cpu").replay("lru", [0, 0, 1], K=2,
    ...                                 collect_info=False).metrics
    >>> int(m.requests), int(m.hits), float(m.bytes_missed)
    (3, 1, 2.0)
    """

    requests: Any
    hits: Any
    bytes_total: Any
    bytes_missed: Any
    cost_total: Any
    penalty: Any


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _ratio(num, den):
    num = np.asarray(_host(num), dtype=np.float64)
    den = np.asarray(_host(den), dtype=np.float64)
    out = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
    return float(out) if out.ndim == 0 else out


class ReplayResult(NamedTuple):
    """Engine output: per-step ``StepInfo`` (``None`` in metrics-only
    mode), per-lane ``Metrics`` and optional observables.

    >>> res = Engine(device="cpu").replay("lru", [0, 0, 0, 1], K=2)
    >>> res.hit_ratio, res.miss_ratio
    (0.5, 0.5)
    """

    info: StepInfo | None
    metrics: Metrics
    obs: Any

    @property
    def hits(self):
        if self.info is None:
            raise ValueError(
                "per-step info was not collected (collect_info=False / "
                "replay_stream); read totals off result.metrics instead")
        return self.info.hit

    @property
    def hit_ratio(self):
        return _ratio(self.metrics.hits, self.metrics.requests)

    @property
    def miss_ratio(self):
        m = self.metrics
        req = np.asarray(_host(m.requests))
        return _ratio(req - np.asarray(_host(m.hits)), req)

    @property
    def byte_miss_ratio(self):
        return _ratio(self.metrics.bytes_missed, self.metrics.bytes_total)

    @property
    def penalty_ratio(self):
        """Cost-weighted miss ratio: sum(cost * miss) / sum(cost)."""
        return _ratio(self.metrics.penalty, self.metrics.cost_total)

    @property
    def total_penalty(self):
        out = np.asarray(_host(self.metrics.penalty), dtype=np.float64)
        return float(out) if out.ndim == 0 else out


def _zero_acc(B, device):
    zi = torch.zeros(B, dtype=torch.int64, device=device)
    zf = torch.zeros(B, dtype=torch.float32, device=device)
    return Metrics(zi, zi, zf, zf, zf, zf)


def _acc_step(acc: Metrics, req: Request, info: StepInfo) -> Metrics:
    """Fold one request's StepInfo into the running totals (each add
    promotes its int or bool operand to the total's type: one kernel, the
    same value as a conversion first)."""
    return Metrics(
        requests=acc.requests + 1,
        hits=acc.hits + info.hit,
        bytes_total=acc.bytes_total + req.size,
        bytes_missed=acc.bytes_missed + info.bytes_missed,
        cost_total=acc.cost_total + req.cost,
        penalty=acc.penalty + info.penalty,
    )


def _sum_metrics(reqs: Request, info: StepInfo) -> Metrics:
    B, T = reqs.key.shape
    return Metrics(
        requests=torch.full((B,), T, dtype=torch.int64,
                            device=reqs.key.device),
        hits=info.hit.sum(-1, dtype=torch.int64),
        bytes_total=reqs.size.to(torch.float32).sum(-1),
        bytes_missed=info.bytes_missed.to(torch.float32).sum(-1),
        cost_total=reqs.cost.sum(-1),
        penalty=info.penalty.sum(-1),
    )


def _sinks(policy, state, B, n, device, collect_info, want_obs):
    """Preallocated ``[B, n]`` per-step outputs: each step's info (with
    ``collect_info``) and observables (with ``observe``)."""
    info = None
    if collect_info:
        info = StepInfo(*(torch.empty((B, n), dtype=dt, device=device)
                          for dt in (torch.bool, torch.int32, torch.int32,
                                     torch.float32)))
    obs = None
    if want_obs:
        obs = {k: torch.empty((B, n), dtype=v.dtype, device=device)
               for k, v in policy.observables(state).items()}
    return info, obs


def _steps(policy, reqs: Request, state, acc, sinks, at=0):
    """``policy.step`` over the columns of ``reqs`` (``[B, n]``) from
    ``state``: each request folds into ``acc`` (unless it is ``None``) and
    its info and observables go to column ``at + s`` of ``sinks`` (``(info,
    obs)`` buffers, either ``None``; or ``sinks`` itself ``None``).
    Returns ``(state, acc)``.  Every loop of the slot policies, eager or
    captured, is this one."""
    info_out, obs_out = (None, None) if sinks is None else sinks
    for s in range(reqs.key.shape[1]):
        req = Request(reqs.key[:, s], reqs.size[:, s], reqs.cost[:, s])
        state, info = policy.step(state, req)
        if acc is not None:
            acc = _acc_step(acc, req, info)
        if info_out is not None:
            for buf, x in zip(info_out, info):
                buf[:, at + s] = x
        if obs_out is not None:
            for k, v in policy.observables(state).items():
                obs_out[k][:, at + s] = v
    return state, acc


def _slot_body(policy):
    """A slot policy's steps as a body for :func:`run_steps`, over the
    carry ``(state, acc)``."""
    def run(reqs, carry, sinks, at):
        return _steps(policy, reqs, *carry, sinks, at)
    return run


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts and tuples (NamedTuples
    too) of the same structure; ``None`` stays ``None``."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        out = [_tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    return fn(*trees)


def _capture(body):
    """Capture ``body()`` into a CUDA graph (nothing runs yet); returns the
    graph's replay."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph.replay


def _replay_graphed(run, reqs: Request, carry, sinks, chunk):
    """A step loop on CUDA: one graph of ``chunk`` steps of ``run``,
    captured over static request, carry and sink buffers and replayed per
    chunk; the tail runs eagerly.  ``run(block, carry, sinks, at)`` steps
    through the columns of ``block`` (time on dim 1, as in ``reqs``) and
    returns the new carry (nested dicts and tuples of tensors), writing
    each step's outputs at column ``at + s`` of ``sinks`` (the same kind of
    tree, time on dim 1, or ``None``).  The slot policies, the tier and
    the fleet all loop through here.  Returns the final carry."""
    T = reqs.key.shape[1]
    n_full = T // chunk
    if n_full:
        def window(x):
            return torch.empty((x.shape[0], chunk) + tuple(x.shape[2:]),
                               dtype=x.dtype, device=x.device)

        static_req = Request(*(window(x) for x in reqs))
        static_carry = _tree_map(torch.clone, carry)
        static_sinks = _tree_map(window, sinks)
        # one eager step on copies first, so that every kernel the step
        # launches (B1's library included) is loaded before the capture
        run(Request(*(x[:, :1] for x in reqs)),
            _tree_map(torch.clone, carry), None, 0)

        def body():
            out = run(static_req, static_carry, static_sinks, 0)
            _tree_map(lambda dst, src: dst.copy_(src), static_carry, out)

        replay = _capture(body)
        for c in range(n_full):
            lo, hi = c * chunk, (c + 1) * chunk
            for x, y in zip(static_req, reqs):
                x.copy_(y[:, lo:hi])
            replay()
            _tree_map(lambda dst, src: dst[:, lo:hi].copy_(src), sinks,
                      static_sinks)
        carry = static_carry
    tail = Request(*(x[:, n_full * chunk:] for x in reqs))
    return run(tail, carry, sinks, n_full * chunk)


def run_steps(run, reqs: Request, carry, sinks=None,
              chunk: int | None = None):
    """Drive a step body (see :func:`_replay_graphed`) over the time axis
    (dim 1) of ``reqs``: on CUDA through the graph loop at ``chunk`` steps
    a graph (default :data:`GRAPH_CHUNK`; 0 runs the eager loop), on the
    CPU as one plain loop.  Returns the final carry."""
    chunk = GRAPH_CHUNK if chunk is None else int(chunk)
    if reqs.key.device.type == "cuda" and chunk > 0:
        return _replay_graphed(run, reqs, carry, sinks, chunk)
    return run(reqs, carry, sinks, 0)


def _replay_rank(policy: RankPolicy, reqs, state, want_obs, collect_info):
    from ..kernels.policy_step import policy_replay
    names = policy.SCALARS
    out = policy_replay(
        state["cache"], torch.stack([state[n] for n in names], -1),
        reqs.key, reqs.size, reqs.cost, policy.plan(),
        collect_info=collect_info, observe=want_obs)
    new_state = dict(state, cache=out.cache)
    new_state.update((n, out.scalars[:, q]) for q, n in enumerate(names))
    obs = None
    if want_obs:
        obs = policy.observables(
            {n: out.obs[..., q] for q, n in enumerate(names)})
    if collect_info:
        info = StepInfo(
            hit=out.hit, evicted_key=out.evicted,
            bytes_missed=torch.where(out.hit, 0, reqs.size).to(torch.int32),
            penalty=torch.where(out.hit, 0.0, reqs.cost))
        return ReplayResult(info, _sum_metrics(reqs, info), obs), new_state
    metrics = Metrics(out.counts[:, 0], out.counts[:, 1],
                      *out.sums.unbind(-1))
    return ReplayResult(None, metrics, obs), new_state


def replay_lanes(policy: Policy, reqs: Request, state: dict, *,
                 observe: bool = False, collect_info: bool = True,
                 chunk: int | None = None):
    """Replay a ``[B, T]`` request block from ``state`` (``[B, ...]``
    lanes); returns ``(ReplayResult, final_state)``.  The counterpart of the
    reference's ``_scan_replay``: :class:`Engine` builds on it, and a state
    carried in from the reference (``state_io.state_from_reference``)
    continues here.  ``chunk`` sets the steps per CUDA graph of a slot
    policy on CUDA (default :data:`GRAPH_CHUNK`; 0 runs the eager loop);
    the CPU and the rank policies ignore it."""
    want_obs = observe and hasattr(policy, "observables")
    if isinstance(policy, RankPolicy):
        return _replay_rank(policy, reqs, state, want_obs, collect_info)
    B, T = reqs.key.shape
    dev = reqs.key.device
    acc = None if collect_info else _zero_acc(B, dev)
    sinks = _sinks(policy, state, B, T, dev, collect_info, want_obs)
    state, acc = run_steps(_slot_body(policy), reqs, (state, acc), sinks,
                           chunk)
    info, obs = sinks
    if collect_info:
        return ReplayResult(info, _sum_metrics(reqs, info), obs), state
    return ReplayResult(None, acc, obs), state


def _lane0(res: ReplayResult) -> ReplayResult:
    pick = (lambda tup: None if tup is None else type(tup)(*(x[0] for x in tup)))
    obs = None if res.obs is None else {k: v[0] for k, v in res.obs.items()}
    return ReplayResult(pick(res.info), pick(res.metrics), obs)


class Engine:
    """The replay entry point, on ``device`` (``"cuda"`` unless the caller
    asks for ``"cpu"``).  ``Engine()`` on a machine without a GPU raises; it
    does not fall back to the CPU.

    >>> import numpy as np
    >>> res = Engine(device="cpu").replay("dac", np.zeros((2, 5), np.int32),
    ...                                   K=4)
    >>> res.miss_ratio.tolist()       # [B, T] batch -> per-lane ratios
    [0.2, 0.2]
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to run the plain versions")

    @staticmethod
    def _resolve(policy):
        if isinstance(policy, str):
            from . import make_policy
            policy = make_policy(policy)
        return policy

    def replay(self, policy, requests, K: int, *, sizes=None, costs=None,
               observe: bool = False,
               collect_info: bool = True) -> ReplayResult:
        """Replay ``requests`` (``[T]`` or ``[B, T]``) through ``policy``
        (an instance or a spec string) at capacity ``K``.
        ``collect_info=False`` keeps only the per-lane totals
        (``result.info is None``)."""
        policy = self._resolve(policy)
        K = int(K)
        reqs = Request.of(requests, sizes, costs, device=self.device)
        if reqs.key.ndim not in (1, 2):
            raise ValueError(
                f"requests must be [T] or [B, T], got shape "
                f"{tuple(reqs.key.shape)}")
        single = reqs.key.ndim == 1
        if single:
            reqs = Request(*(x.unsqueeze(0) for x in reqs))
        state = policy.init(K, lanes=reqs.key.shape[0], device=self.device)
        res, _ = replay_lanes(policy, reqs, state, observe=observe,
                              collect_info=collect_info)
        return _lane0(res) if single else res

    def replay_tier(self, tier, requests, *, sizes=None, costs=None,
                    observe: bool = False):
        """Replay an interleaved multi-tenant stream (``[T, N]``, or
        ``[S, T, N]`` for S independent streams) through a
        :class:`repro_torch.tier.CacheTier`: per-tenant :class:`Metrics`
        and time-mean occupancy; returns a
        :class:`repro_torch.tier.TierResult`.  The tenants share one
        budget, so their lanes are not independent."""
        from ..tier import CacheTier, replay_tier
        if not isinstance(tier, CacheTier):
            raise TypeError(f"expected a CacheTier, got {type(tier).__name__}")
        return replay_tier(tier, requests, sizes=sizes, costs=costs,
                           observe=observe, device=self.device)

    def replay_fleet(self, tier, requests, *, sizes=None, costs=None,
                     observe: bool = False, mesh=None):
        """Replay a dynamic-fleet stream (``-1`` keys = idle lane; ``[T,
        N]`` or ``[S, T, N]``) through a :class:`repro_torch.fleet.FleetTier`:
        tenant arrivals and departures, arbiter-priced capacity, per-lane
        SLO telemetry.  Returns a :class:`repro_torch.fleet.FleetResult`.
        ``mesh=`` (the lane axis sharded over devices) is not ported."""
        from ..fleet import FleetTier, replay_fleet
        if not isinstance(tier, FleetTier):
            raise TypeError(
                f"expected a FleetTier, got {type(tier).__name__}")
        return replay_fleet(tier, requests, sizes=sizes, costs=costs,
                            observe=observe, mesh=mesh, device=self.device)

    def replay_stream(self, policy, requests, K: int, *, sizes=None,
                      costs=None, chunk: int | None = None,
                      observe: bool = False) -> ReplayResult:
        """Metrics-only replay of a long trace in chunks: the policy state
        stays on the device between chunks, each chunk's float32 totals
        start from zero, and the chunks are summed on the host in float64
        (as the reference does).

        ``requests`` is dense (``[T]`` / ``[B, T]`` keys or a ``Request``,
        sliced into ``chunk``-request pieces, default 2^18) or an iterator
        of chunks (each a ``Request``, a key array or a ``(keys, sizes,
        costs)`` record), in which case ``sizes``/``costs``/``chunk`` must
        be unset.  ``observe=True`` returns each observable's time mean
        per lane in ``result.obs``."""
        policy = self._resolve(policy)
        K = int(K)
        if hasattr(requests, "__next__"):
            if sizes is not None or costs is not None:
                raise ValueError(
                    "iterator input: sizes/costs travel inside each chunk")
            if chunk is not None:
                raise ValueError(
                    "iterator input owns its chunking — chunk= is not "
                    "applied to an iterator; size the chunks at the source")

            def coerce(item):
                if isinstance(item, (tuple, list)) and len(item) == 3 \
                        and not isinstance(item, Request) \
                        and np.ndim(item[0]) > 0 \
                        and all(x is None or np.ndim(x) > 0
                                for x in item[1:]):
                    keys, sz, cs = item
                    return Request.of(np.asarray(keys), sizes=sz, costs=cs,
                                      device=self.device)
                return Request.of(item, device=self.device)

            chunks = (coerce(item) for item in requests)
        else:
            chunk = (1 << 18) if chunk is None else chunk
            if chunk <= 0:
                raise ValueError(f"chunk must be positive, got {chunk}")
            if isinstance(requests, Request):
                if sizes is not None or costs is not None:
                    raise ValueError("pass sizes/costs inside the Request")
                keys, sizes, costs = (_host(x) for x in requests)
            else:
                keys = _host(requests)
            if keys.ndim not in (1, 2):
                raise ValueError(
                    f"requests must be [T] or [B, T], got shape {keys.shape}")

            def sl(x, lo, hi):
                if x is None or np.ndim(x) == 0:
                    return x
                return _host(x)[..., lo:hi]

            chunks = (Request.of(keys[..., lo:lo + chunk],
                                 sl(sizes, lo, lo + chunk),
                                 sl(costs, lo, lo + chunk),
                                 device=self.device)
                      for lo in range(0, keys.shape[-1], chunk))

        state, lead, totals, obs_sums, T_total = None, None, None, None, 0
        for reqs in chunks:
            if reqs.key.ndim not in (1, 2):
                raise ValueError(
                    f"chunks must be [T] or [B, T], got shape "
                    f"{tuple(reqs.key.shape)}")
            if state is None:
                lead = tuple(reqs.key.shape[:-1])
                state = policy.init(K, lanes=lead[0] if lead else 1,
                                    device=self.device)
                totals = np.zeros((6,) + lead, np.float64)
            elif tuple(reqs.key.shape[:-1]) != lead:
                raise ValueError(
                    f"chunk lane shape changed mid-stream: "
                    f"{tuple(reqs.key.shape[:-1])} != {lead}")
            if not lead:
                reqs = Request(*(x.unsqueeze(0) for x in reqs))
            res, state = replay_lanes(policy, reqs, state, observe=observe,
                                      collect_info=False)
            part = np.stack([_host(f).astype(np.float64) for f in res.metrics])
            totals += part if lead else part[:, 0]
            T_total += reqs.key.shape[-1]
            if res.obs is not None:
                sums = {k: _host(v.to(torch.float64).sum(-1))
                        for k, v in res.obs.items()}
                sums = sums if lead else {k: v[0] for k, v in sums.items()}
                obs_sums = sums if obs_sums is None else {
                    k: obs_sums[k] + sums[k] for k in sums}
        if totals is None:
            totals = np.zeros(6, np.float64)
        metrics = Metrics(
            requests=totals[0].astype(np.int64),
            hits=totals[1].astype(np.int64),
            bytes_total=totals[2], bytes_missed=totals[3],
            cost_total=totals[4], penalty=totals[5],
        )
        obs_out = None
        if obs_sums is not None and T_total:
            obs_out = {k: v / T_total for k, v in obs_sums.items()}
        return ReplayResult(info=None, metrics=metrics, obs=obs_out)


def miss_ratio(hits) -> float:
    """Miss ratio of a boolean hit mask (host-side convenience).

    >>> miss_ratio([True, False, False, False])
    0.75
    """
    return float(1.0 - np.asarray(_host(hits), dtype=np.float64).mean())


def mrr(mr_algo: float, mr_fifo: float) -> float:
    """Miss-ratio reduction relative to FIFO (the paper's signed
    definition); both zero is no reduction.

    >>> mrr(0.2, 0.4)
    0.5
    >>> mrr(0.4, 0.2)
    -0.5
    >>> mrr(0.0, 0.0)
    0.0
    """
    if mr_algo == 0.0 and mr_fifo == 0.0:
        return 0.0
    if mr_algo <= mr_fifo:
        return (mr_fifo - mr_algo) / mr_fifo if mr_fifo > 0 else 0.0
    return (mr_fifo - mr_algo) / mr_algo if mr_algo > 0 else 0.0
