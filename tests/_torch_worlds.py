"""Rank programs of the port's multi-rank CPU tests (gloo worlds started by
``repro_torch.launch.mesh.launch_world``).

Spawned ranks import this module by name, so it imports torch and the
port only: no jax, no reference package.  Each program returns numpy
arrays and Python values; the tests compare them with the reference's
results and with the unsharded port.
"""
import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.launch import mesh as M

POLICIES = ("dac", "ac", "climb", "fifo", "arc")
# the dense-attention configurations besides deepseek-7b and gemma2-27b
DENSE = ("codeqwen1.5-7b", "qwen1.5-110b", "llava-next-mistral-7b",
         "musicgen-medium")
# the configurations with MoE, MLA or recurrent layers
ARCH = ("deepseek-v2-236b", "mixtral-8x22b", "jamba-1.5-large-398b",
        "xlstm-125m")


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def _result_arrays(res):
    """Every tensor of a ReplayResult, by field name."""
    out = {f"metrics.{f}": _np(x) for f, x in zip(res.metrics._fields,
                                                   res.metrics)}
    if res.info is not None:
        out.update({f"info.{f}": _np(x) for f, x in zip(res.info._fields,
                                                         res.info)})
    if res.obs is not None:
        out.update({f"obs.{k}": _np(v) for k, v in res.obs.items()})
    return out


def _line_mesh(world):
    return torch.distributed.device_mesh.DeviceMesh(
        "cpu", torch.arange(world), mesh_dim_names=("data",))


def engine_world(world):
    """``Engine(mesh=)`` and ``run_sweep(mesh=)`` against the unsharded
    runs, on a ``("data",)`` mesh of every rank."""
    from repro_torch.bench import Scenario, Sweep, run_sweep
    from repro_torch.core import Engine
    from repro_torch.data.traces import object_sizes, zipf_trace
    mesh = _line_mesh(world)
    keys = np.stack([zipf_trace(N=200, T=300, alpha=0.9, seed=s)
                     for s in range(8)]).astype(np.int32)
    sizes = object_sizes(200, seed=1)[keys]
    out = {"replay": {}}
    for pol in POLICIES:
        for info in (True, False):
            kw = dict(sizes=sizes, costs=sizes / 3.0, observe=True,
                      collect_info=info)
            got = Engine(device="cpu", mesh=mesh).replay(pol, keys, 16, **kw)
            want = Engine(device="cpu").replay(pol, keys, 16, **kw)
            out["replay"][(pol, info)] = (_result_arrays(got),
                                          _result_arrays(want))
    # a [T] request ignores the mesh
    one = Engine(device="cpu", mesh=mesh).replay("dac", keys[0], 16)
    out["single"] = _np(one.info.hit)
    try:
        Engine(device="cpu", mesh=mesh).replay("dac", keys[:world + 1], 16)
    except ValueError as e:
        out["indivisible"] = str(e)
    sw = Sweep("mesh", policies=POLICIES, seeds=tuple(range(2 * world)),
               scenarios=(Scenario("z", trace="zipf(N=64,alpha=1.0)",
                                   T=300, K=(8, "L")),), observe=True)
    strip = (lambda rs: [{k: v for k, v in r.items() if k != "wall_s"}
                         for r in rs])
    out["sweep"] = (
        strip(run_sweep(sw, engine=Engine(device="cpu"), mesh=mesh).records),
        strip(run_sweep(sw, engine=Engine(device="cpu")).records))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        streamed = run_sweep(sw, engine=Engine(device="cpu"), mesh=mesh,
                             stream=True, chunk=128).records
    out["stream_warned"] = [str(w.message) for w in caught]
    out["streamed"] = strip(streamed)
    return out


def _fleet_arrays(res):
    out = {f: _np(x) for f, x in zip(res.metrics._fields, res.metrics)}
    out.update(avg_k=_np(res.avg_k), alive_frac=_np(res.alive_frac),
               hist=_np(res.hist))
    if res.obs is not None:
        out.update({"obs." + k: _np(v) for k, v in res.obs.items()})
    return out


def fleet_world(cases, graph_chunk, graph_max_T):
    """The sharded fleet over every rank for each case ``(policy,
    arbiter, budget, rebalance, T)`` of the reference test's trace: the
    eager loop and, for ``T <= graph_max_T``, the graph loop's bookkeeping
    (the capture replaced by its body, ``graph_chunk`` steps a graph); and
    both guards."""
    from repro_torch.core import simulator as sim
    from repro_torch.data.traces import fleet_trace
    from repro_torch.fleet import FleetTier, replay_fleet
    from repro_torch.fleet import fleet as fleet_mod
    world = torch.distributed.get_world_size()
    mesh = _line_mesh(world)
    out = {}
    for case in cases:
        pol, arb, budget, rebalance, T = case
        keys = fleet_trace(N=128, T=T, n_lanes=8, rate=0.02,
                           mean_session=500, lo=8, seed=0)
        fl = FleetTier(pol, n_lanes=8, budget=budget, arbiter=arb)
        eager = replay_fleet(fl, keys, observe=True, mesh=mesh,
                             rebalance=rebalance, device="cpu")
        if T > graph_max_T:
            out[case] = (_fleet_arrays(eager), None)
            continue
        run_steps, capture = fleet_mod.run_steps, sim._capture
        sim._capture = lambda body: body
        fleet_mod.run_steps = (
            lambda run, reqs, carry, sinks=None, chunk=None, cuts=(),
            at_cut=None: sim._replay_graphed(run, reqs, carry, sinks,
                                             graph_chunk, cuts, at_cut))
        try:
            graphed = replay_fleet(fl, keys, observe=True, mesh=mesh,
                                   rebalance=rebalance, device="cpu")
        finally:
            fleet_mod.run_steps, sim._capture = run_steps, capture
        out[case] = (_fleet_arrays(eager), _fleet_arrays(graphed))
    keys = fleet_trace(N=128, T=50, n_lanes=6, rate=0.02, mean_session=500,
                       lo=8, seed=0)
    errors = {}
    short = FleetTier("dac(k_min=16)", n_lanes=8, budget=128)
    short.budget = 120              # below the constructor's own floor
    for name, tier, k in (
            ("lanes", FleetTier("dac(k_min=4)", n_lanes=6, budget=96), keys),
            ("budget", short, fleet_trace(N=128, T=50, n_lanes=8, rate=0.02,
                                          mean_session=500, lo=8, seed=0))):
        try:
            replay_fleet(tier, k, mesh=mesh, device="cpu")
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


class _Routing:
    """Records every MoE routing (the experts chosen) and dispatch (the
    choices kept) while entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []
        self.route, self.dispatch = moe.route, moe.dispatch

        def route(*a, **k):
            out = self.route(*a, **k)
            self.calls.append(("experts", _np(out[0])))
            return out

        def dispatch(*a, **k):
            out = self.dispatch(*a, **k)
            self.calls.append(("kept", _np(out[1])))
            return out

        moe.route, moe.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch = self.route, self.dispatch

    def equals(self, other) -> bool:
        return len(self.calls) == len(other.calls) and all(
            a[0] == b[0] and np.array_equal(a[1], b[1])
            for a, b in zip(self.calls, other.calls))

    def dropped(self) -> int:
        """Choices dropped at decode (one dispatch group of the batch)."""
        return int(sum((~c[1]).sum() for c in self.calls
                       if c[0] == "kept" and c[1].shape[0] == 1))


# the channel dimension of a split recurrent state leaf, by layer kind
_CHANNEL_DIM = {"mamba": {"conv": 2, "h": 1},
                "mlstm": {"conv": 2, "C": 1, "n": 1, "m": 1}}


def _whole_states(loc, state):
    """Every recurrent layer's state of a rank, gathered over the channel
    blocks and the batch (every collective on every rank)."""
    out = {}
    for layer, st in enumerate(state["layers"]):
        kind = loc.kinds[layer]
        if kind in ("attn", "mla"):
            continue
        c = loc.chan[layer]
        rest = tuple(a for a in loc.b_axes if a not in c)
        for k, x in st.items():
            dim = _CHANNEL_DIM.get(kind, {}).get(k)
            if dim is not None and c:
                x = loc.cat(x, c, dim)
            out[(layer, k)] = _np(loc.cat(x, rest) if rest else x)
    return out


def _serve(params, cfg, first, steps, sctx=None, **kw):
    """Prefill ``first`` and decode ``steps`` (dicts of the inputs):
    the logits of each, the bounded layers' control state after each
    step (under a mesh, gathered over the batch axes), the routing and
    the final state."""
    from repro_torch.models.model import local_view
    from repro_torch.serving import decode_step, prefill
    with _Routing() as routing:
        st, lg = prefill(params, cfg, sctx=sctx, **first, **kw)
        logits, ctrl = [_np(lg)], []
        for step in steps:
            st, lg = decode_step(params, cfg, st, sctx=sctx, **step)
            logits.append(_np(lg))
            pooled = [s["ctrl"] for s in st["layers"] if "ctrl" in s]
            if sctx is not None:
                b = local_view(cfg, sctx, lg.shape[0]).b_axes
                pooled = [{k: M.cat(v, sctx.mesh, b) for k, v in c.items()}
                          for c in pooled]
            ctrl.append([{k: _np(v) for k, v in c.items()} for c in pooled])
    return np.stack(logits), ctrl, routing, st


def _ctrl_equal(got, want) -> bool:
    return all(np.array_equal(g[k], w[k]) for a, b in zip(got, want)
               for g, w in zip(a, b) for k in w)


def _token_inputs(cfg, B, S, steps, seed):
    """(prefill inputs, decode inputs) of ``B`` sequences: tokens, or
    embeddings for a stub frontend."""
    g = torch.Generator().manual_seed(seed)
    if cfg.embeds_input:
        return (dict(embeds=torch.randn(B, S, cfg.d_model, generator=g)),
                [dict(embed=torch.randn(B, cfg.d_model, generator=g))
                 for _ in range(steps)])
    return (dict(tokens=torch.randint(0, cfg.vocab, (B, S), generator=g)),
            [dict(token=torch.randint(0, cfg.vocab, (B,), generator=g))
             for _ in range(steps)])


def serve_world(names, budgets, steps, refs, modes=("serve", "train"),
                others=DENSE, pod="gemma2-27b", drops=None):
    """Sharded serving on a (data 2, model 2) mesh against the unsharded
    port, f32 smoke configs, each rank's parameters built by
    ``init_params(sctx=)`` (and checked against ``shard_tree`` of the
    whole model):

    * ``names``: prefill plus ``steps`` teacher-forced decode steps at
      each budget, in each of ``modes``: logits, DAC's control state
      after every step, MoE routing and drops, recurrent states;
    * ``others``: serve mode, bounded, 3 steps: logits;
    * ``pod``: that config on a (pod 2, data 1, model 2) mesh, a batch
      that splits over (pod, data) and one that does not;
    * ``drops`` (a config name, a capacity factor and a batch): MoE with
      choices dropped at decode, whose drops must be the unsharded ones;
    * ``refs`` (``{name: (file, mode)}``): the sharded decode from a fresh
      bounded state against the reference's own (the file: its
      parameters, tokens and logits)."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import init_params, params_from_reference
    from repro_torch.models import model as model_mod
    from repro_torch.models.model import local_view, param_shapes
    from repro_torch.models.sharding import param_specs, shard_tree
    from repro_torch.serving import decode_step, init_serve_state
    mesh = M.make_test_mesh(data=2, model=2)     # on the rank's CPU
    assert mesh.device_type == "cpu"

    def f32(name):
        return dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32")

    def whole(cfg):
        return init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")

    def local(cfg, sctx, params):
        """(this rank's blocks from init_params(sctx=), whether they are
        shard_tree's cut of ``params``, and whether they still are when
        every leaf past 256 elements is drawn in slices of rows)."""
        specs = param_specs(param_shapes(cfg), cfg, sctx)

        def same(mine, whole_params):
            cut = shard_tree(whole_params, specs, sctx.mesh)
            return all(torch.equal(a, b) for a, b in zip(_leaves(mine),
                                                         _leaves(cut)))

        mine = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", sctx=sctx)
        equal = same(mine, params)
        draw_slice, model_mod._DRAW_SLICE = model_mod._DRAW_SLICE, 256
        try:
            equal = equal and same(
                init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", sctx=sctx), whole(cfg))
        finally:
            model_mod._DRAW_SLICE = draw_slice
        return mine, equal

    out = {}
    for name in names:
        cfg = f32(name)
        params = whole(cfg)
        rng = np.random.default_rng(1)
        B, S = 4, 24
        first = dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab,
                                                          (B, S))))
        forced = [dict(token=torch.from_numpy(t))
                  for t in rng.integers(0, cfg.vocab, (steps, B))]
        wants = {budget: _serve(params, cfg, first, forced, budget=budget,
                                max_len=64) for budget in budgets}
        for mode in modes:
            sctx = M.shard_ctx(mesh, mode=mode)
            blocks, same = local(cfg, sctx, params)
            for budget in budgets:
                want = wants[budget]
                got = _serve(blocks, cfg, first, forced, sctx, budget=budget,
                             max_len=64)
                loc = local_view(cfg, sctx, B)
                states = _whole_states(loc, got[3])
                state_err = max((float(np.abs(v - _np(
                    want[3]["layers"][layer][k])).max())
                    for (layer, k), v in states.items()), default=0.0)
                out[(name, mode, budget)] = dict(
                    logits=(got[0], want[0]), init_equal=same,
                    ctrl_equal=_ctrl_equal(got[1], want[1]),
                    ctrl_steps=sum(len(c) for c in want[1]),
                    evictions=_evictions(got[1]),
                    routing_equal=got[2].equals(want[2]),
                    routings=len(want[2].calls), state_err=state_err,
                    states=len(states))
    sctx = M.shard_ctx(mesh, mode="serve")
    for name in others:
        cfg = f32(name)
        params = whole(cfg)
        first, steps3 = _token_inputs(cfg, 4, 12, 3, seed=3)
        want = _serve(params, cfg, first, steps3, budget=8, max_len=20)
        got = _serve(local(cfg, sctx, params)[0], cfg, first, steps3, sctx,
                     budget=8, max_len=20)
        out[("other", name)] = (got[0], want[0])
    if drops is not None:
        name, factor, B = drops
        cfg = f32(name)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
        params = whole(cfg)
        first, forced = _token_inputs(cfg, B, 16, 4, seed=4)
        want = _serve(params, cfg, first, forced)
        got = _serve(local(cfg, sctx, params)[0], cfg, first, forced, sctx)
        out["drops"] = dict(logits=(got[0], want[0]),
                            routing_equal=got[2].equals(want[2]),
                            dropped=want[2].dropped())
    # a (pod 2, data 1, model 2) mesh, a batch that splits over (pod,
    # data) and one that does not (replicated)
    pmesh = M.make_test_mesh(data=1, model=2, pod=2)
    cfg = f32(pod)
    sctx = M.shard_ctx(pmesh, mode="serve")
    params = whole(cfg)
    blocks = local(cfg, sctx, params)[0]
    rng = np.random.default_rng(2)
    for B in (4, 3):
        first = dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab,
                                                          (B, 16))))
        forced = [dict(token=torch.from_numpy(t))
                  for t in rng.integers(0, cfg.vocab, (3, B))]
        want = _serve(params, cfg, first, forced, budget=16, max_len=32)
        got = _serve(blocks, cfg, first, forced, sctx, budget=16, max_len=32)
        out[("pod", B)] = dict(logits=(got[0], want[0]),
                               rows=int(got[3]["pos"].shape[0]),
                               routing_equal=got[2].equals(want[2]))
    # the reference's sharded decode, from its parameters and a fresh state
    for name, (ref_file, mode) in refs.items():
        ref = np.load(ref_file, allow_pickle=True)
        cfg = f32(name)
        rparams = params_from_reference(ref["params"].item(), cfg,
                                        device="cpu")
        sctx = M.shard_ctx(mesh, mode=mode)
        blocks = shard_tree(rparams, param_specs(param_shapes(cfg), cfg,
                                                 sctx), mesh)
        state = init_serve_state(cfg, 4, max_len=64, budget=32, device="cpu",
                                 sctx=sctx)
        logits = []
        for t in ref["tokens"]:
            state, lg = decode_step(blocks, cfg, state,
                                    token=torch.from_numpy(t), sctx=sctx)
            logits.append(_np(lg))
        out[("reference", name)] = (np.stack(logits), ref["logits"])
    return out


# the configurations whose smoke KV heads (2) do not split 4 ways, and
# deepseek-v2-236b, whose MLA latent cache splits by slots wherever the
# model axis divides them (its 4 heads split 4 ways)
SLOT_ARCHS = ("qwen1.5-110b", "mixtral-8x22b", "deepseek-v2-236b")


def _wait_for(done, failed, timeout):
    """Wait until the file ``done`` exists; raise if ``failed`` does, or
    after ``timeout`` seconds."""
    import os
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(done):
        if os.path.exists(failed) or time.monotonic() > deadline:
            raise RuntimeError(f"no {done} (failed: "
                               f"{os.path.exists(failed)})")
        time.sleep(0.1)


def _evictions(ctrl):
    """The slots that decode steps wrote over a live entry: in each
    bounded layer's control state after each step (``_serve``'s list),
    those whose token position moved from one that was live (>= 0) to
    another, counted over the steps after the first."""
    return sum(int(((w["slot_pos"] >= 0) & (w["slot_pos"] != g["slot_pos"])
                    ).sum())
               for a, b in zip(ctrl, ctrl[1:]) for w, g in zip(a, b))


def slot_world(names, budgets, steps, refs, whole, padded, ref_dir,
               timeout):
    """Sharded serving with slot-split KV caches on a (data 1, model 4)
    mesh, serve mode, f32 smoke configs whose KV heads do not divide 4 or
    whose layers are MLA, against the unsharded port:

    * ``names``: prefill plus ``steps`` teacher-forced decode steps at
      each budget (``max_len`` 64): logits, DAC's control state after
      every step and the live slots the steps overwrote (a budget below
      the prompt fills the pool), MoE routing, the cache bytes (K/V,
      latent/krope) a rank holds against the unsharded state's, and which
      attention and MLA layers split their slots;
    * ``whole`` (``(name, budget, max_len)`` cases whose slot count does
      not divide 4): the same, the caches whole on every rank;
    * ``padded`` (``(name, query heads, budget)``): the same, at ``max_len``
      64, with query heads that do not divide 4 (``wq`` and ``wo`` whole,
      the heads padded for the exchange);
    * each MLA config of ``names``: the error a decode step over a whole
      latent cache of 64 slots raises on the mesh (None if none);
    * ``refs`` (``{name: {budget: file}}``): the sharded decode from a
      fresh state against the reference's own on the same mesh, once the
      reference has written its files (``ref_dir``'s ``done``; it runs
      beside the world), and the live slots the port's steps overwrote."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import init_params, params_from_reference
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import param_specs, shard_tree
    from repro_torch.serving import decode_step, init_serve_state
    from repro_torch.serving.serve_step import kv_bytes
    mesh = M.make_test_mesh(data=1, model=4)
    sctx = M.shard_ctx(mesh, mode="serve")

    def f32(name, **kw):
        return dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32",
                                   **kw)

    def run(name, budget, max_len, **kw):
        cfg = f32(name, **kw)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        blocks = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", sctx=sctx)
        rng = np.random.default_rng(1)
        B, S = 4, 24
        first = dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab,
                                                          (B, S))))
        forced = [dict(token=torch.from_numpy(t))
                  for t in rng.integers(0, cfg.vocab, (steps, B))]
        want = _serve(params, cfg, first, forced, budget=budget,
                      max_len=max_len)
        got = _serve(blocks, cfg, first, forced, sctx, budget=budget,
                     max_len=max_len)
        return dict(logits=(got[0], want[0]),
                    ctrl_equal=_ctrl_equal(got[1], want[1]),
                    ctrl_steps=sum(len(c) for c in want[1]),
                    evictions=_evictions(got[1]),
                    routing_equal=got[2].equals(want[2]),
                    kv_bytes=(kv_bytes(got[3]), kv_bytes(want[3])),
                    split=["slots" in st for st in got[3]["layers"]
                           if "k" in st or "latent" in st])

    out = {}
    for name in names:
        for budget in budgets:
            out[(name, budget)] = run(name, budget, 64)
    for name, budget, max_len in whole:
        out[("whole", name, budget)] = run(name, budget, max_len)
    for name, heads, budget in padded:
        out[("padded", name, budget)] = run(name, budget, 64, n_heads=heads)
    # an MLA cache held whole where the model axis splits its slots raises
    # (no whole-cache fallback); every rank raises before any collective
    for name in names:
        cfg = f32(name)
        if all(s.kind != "mla" for s in cfg.layer_specs()):
            continue
        blocks = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", sctx=sctx)
        whole = init_serve_state(cfg, 4, max_len=64, device="cpu")
        try:
            decode_step(blocks, cfg, whole, token=torch.zeros(
                4, dtype=torch.int64), sctx=sctx)
            out[("whole-raises", name)] = None
        except ValueError as e:
            out[("whole-raises", name)] = str(e)
    _wait_for(f"{ref_dir}/done", f"{ref_dir}/failed", timeout)
    for name, files in refs.items():
        cfg = f32(name)
        for budget, ref_file in files.items():
            ref = np.load(ref_file, allow_pickle=True)
            rparams = params_from_reference(ref["params"].item(), cfg,
                                            device="cpu")
            blocks = shard_tree(rparams, param_specs(param_shapes(cfg), cfg,
                                                     sctx), mesh)
            state = init_serve_state(cfg, 4, max_len=64, budget=budget,
                                     device="cpu", sctx=sctx)
            logits, ctrl = [], []
            for t in ref["tokens"]:
                state, lg = decode_step(blocks, cfg, state,
                                        token=torch.from_numpy(t), sctx=sctx)
                logits.append(_np(lg))
                ctrl.append([{k: _np(v) for k, v in st["ctrl"].items()}
                             for st in state["layers"] if "ctrl" in st])
            out[("reference", name, budget)] = dict(
                logits=(np.stack(logits), ref["logits"]),
                evictions=_evictions(ctrl))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


# -- the dry run's collectives against a real world -------------------------

# (config, budget, mesh (data, model)); qwen's 2 KV heads split its
# cache's slots 4 ways
DRYRUN_CASES = (("deepseek-7b", 0, (2, 2)), ("deepseek-7b", 16, (2, 2)),
                ("mixtral-8x22b", 0, (2, 2)), ("qwen1.5-110b", 16, (1, 4)))
DRYRUN_B, DRYRUN_LEN = 8, 32


def decode_collectives(cfg, sctx, params, state, token):
    """One decode step under ``launch.roofline.StepCounter``: its
    collectives as the mesh's hook saw them (counts, wire bytes by kind
    and link, ``seq_sum``'s wire bytes)."""
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.serving import decode_step
    with torch.no_grad(), StepCounter() as c:
        decode_step(params, cfg, state, token=token, impl="plain", sctx=sctx)
    res = c.result()
    return {k: res[k] for k in ("collective_counts", "collective_bytes",
                                "wire_by_link", "sum_wire_bytes")}


def collectives_world():
    """Each ``DRYRUN_CASES`` smoke decode on its mesh of real tensors,
    serve mode: rank 0's collectives (every rank runs the step)."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import init_params
    from repro_torch.serving import init_serve_state
    out = []
    for name, budget, shape in DRYRUN_CASES:
        mesh = M.make_test_mesh(*shape)
        sctx = dataclasses.replace(M.shard_ctx(mesh), mode="serve")
        cfg = SMOKE_ARCHS[name]
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", sctx=sctx)
        state = init_serve_state(cfg, DRYRUN_B, DRYRUN_LEN, budget,
                                 device="cpu", sctx=sctx)
        token = torch.zeros(DRYRUN_B, dtype=torch.int64)
        out.append(decode_collectives(cfg, sctx, params, state, token))
    return out
