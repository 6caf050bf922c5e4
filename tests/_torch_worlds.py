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


def serve_world(names, budgets, steps, ref_file):
    """Sharded serving on a (data 2, model 2) mesh against the unsharded
    port, f32 smoke configs: prefill plus ``steps`` teacher-forced decode
    steps at each budget; and the sharded decode from a fresh state
    against the reference's own sharded decode (``ref_file``: its
    parameters, tokens and logits)."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import init_params, params_from_reference
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import param_specs, shard_tree
    from repro_torch.serving import decode_step, init_serve_state, prefill
    mesh = M.make_test_mesh(data=2, model=2)     # on the rank's CPU
    assert mesh.device_type == "cpu"
    out = {}
    for name in names:
        cfg = dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        rng = np.random.default_rng(1)
        B, S = 4, 24
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
        forced = torch.from_numpy(rng.integers(0, cfg.vocab, (steps, B)))
        for budget in budgets:
            st, lg = prefill(params, cfg, tokens=toks, budget=budget,
                             max_len=64)
            want, ctrl_want = [_np(lg)], []
            for t in forced:
                st, lg = decode_step(params, cfg, st, token=t)
                want.append(_np(lg))
                if budget:
                    ctrl_want.append([{k: _np(v) for k, v in s["ctrl"].items()}
                                      for s in st["layers"]])
            for mode in ("serve", "train"):
                sctx = M.shard_ctx(mesh, mode=mode)
                local = shard_tree(
                    params, param_specs(param_shapes(cfg), cfg, sctx), mesh)
                st, lg = prefill(local, cfg, tokens=toks, budget=budget,
                                 max_len=64, sctx=sctx)
                got, ctrl = [_np(lg)], []
                for i, t in enumerate(forced):
                    st, lg = decode_step(local, cfg, st, token=t, sctx=sctx)
                    got.append(_np(lg))
                    if budget:
                        # every gather runs on every rank (a list, not a
                        # short-circuiting generator)
                        ctrl.append(all([
                            np.array_equal(w[k], _np(M.cat(
                                s["ctrl"][k], mesh, ("data",))))
                            for w, s in zip(ctrl_want[i], st["layers"])
                            for k in w]))
                out[(name, mode, budget)] = (np.stack(got), np.stack(want),
                                             ctrl)
    # the other dense configurations (qkv biases, GQA groups, stub
    # frontends that take embeddings), serve mode, bounded
    sctx = M.shard_ctx(mesh, mode="serve")
    for name in DENSE:
        cfg = dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        local = shard_tree(params, param_specs(param_shapes(cfg), cfg, sctx),
                           mesh)
        g = torch.Generator().manual_seed(3)
        if cfg.embeds_input:
            first = dict(embeds=torch.randn(4, 12, cfg.d_model, generator=g))
            steps = [dict(embed=torch.randn(4, cfg.d_model, generator=g))
                     for _ in range(3)]
        else:
            first = dict(tokens=torch.randint(0, cfg.vocab, (4, 12),
                                              generator=g))
            steps = [dict(token=torch.randint(0, cfg.vocab, (4,),
                                              generator=g))
                     for _ in range(3)]
        st, lg = prefill(params, cfg, budget=8, max_len=20, **first)
        st2, lg2 = prefill(local, cfg, budget=8, max_len=20, sctx=sctx,
                           **first)
        want, got = [_np(lg)], [_np(lg2)]
        for kw in steps:
            st, lg = decode_step(params, cfg, st, **kw)
            st2, lg2 = decode_step(local, cfg, st2, sctx=sctx, **kw)
            want.append(_np(lg))
            got.append(_np(lg2))
        out[("dense", name)] = (np.stack(got), np.stack(want))
    # a (pod 2, data 1, model 2) mesh, a batch that splits over (pod,
    # data) and one that does not (replicated)
    pod = M.make_test_mesh(data=1, model=2, pod=2)
    cfg = dataclasses.replace(SMOKE_ARCHS["gemma2-27b"],
                              param_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    sctx = M.shard_ctx(pod, mode="serve")
    local = shard_tree(params, param_specs(param_shapes(cfg), cfg, sctx),
                       pod)
    rng = np.random.default_rng(2)
    for B in (4, 3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 16)))
        forced = torch.from_numpy(rng.integers(0, cfg.vocab, (3, B)))
        st, lg = prefill(params, cfg, tokens=toks, budget=16, max_len=32)
        st2, lg2 = prefill(local, cfg, tokens=toks, budget=16, max_len=32,
                           sctx=sctx)
        want, got = [_np(lg)], [_np(lg2)]
        for t in forced:
            st, lg = decode_step(params, cfg, st, token=t)
            st2, lg2 = decode_step(local, cfg, st2, token=t, sctx=sctx)
            want.append(_np(lg))
            got.append(_np(lg2))
        out[("pod", B)] = (np.stack(got), np.stack(want),
                           int(st2["pos"].shape[0]))
    # the reference's sharded decode, from its parameters and a fresh state
    ref = np.load(ref_file, allow_pickle=True)
    cfg = dataclasses.replace(SMOKE_ARCHS["deepseek-7b"],
                              param_dtype="float32")
    rparams = params_from_reference(ref["params"].item(), cfg, device="cpu")
    sctx = M.shard_ctx(mesh, mode="train")
    local = shard_tree(rparams, param_specs(param_shapes(cfg), cfg, sctx),
                       mesh)
    state = init_serve_state(cfg, 4, max_len=64, budget=32, device="cpu",
                             sctx=sctx)
    logits = []
    for t in ref["tokens"]:
        state, lg = decode_step(local, cfg, state,
                                token=torch.from_numpy(t), sctx=sctx)
        logits.append(_np(lg))
    out["vs_reference"] = (np.stack(logits), ref["logits"])
    return out
