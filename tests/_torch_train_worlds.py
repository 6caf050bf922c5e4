"""Rank programs of the port's sharded-training CPU tests (gloo worlds
started by ``repro_torch.launch.mesh.launch_world``).

Spawned ranks import this module by name, so it imports torch and the
port only: no jax, no reference package.  Each program returns numpy
arrays and Python values; the tests compare them with the unsharded port
and with the reference's results.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.launch import mesh as M

ALL = ("deepseek-7b", "codeqwen1.5-7b", "gemma2-27b", "qwen1.5-110b",
       "llava-next-mistral-7b", "musicgen-medium", "deepseek-v2-236b",
       "mixtral-8x22b", "jamba-1.5-large-398b", "xlstm-125m")


def f32(name, **kw):
    from repro_torch.configs import SMOKE_ARCHS
    return dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32",
                               **kw)


def _np(x):
    return x.detach().cpu().numpy()


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def batch_of(cfg, B, S, seed):
    """A seeded batch: tokens (or embeddings for a stub frontend) and
    labels, as CPU tensors."""
    rng = np.random.default_rng(seed)
    out = {"labels": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.embeds_input:
        out["embeds"] = torch.from_numpy((rng.standard_normal(
            (B, S, cfg.d_model)) * 0.05).astype(np.float32))
    else:
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    return out


def rows_of(batch, sctx):
    """This rank's rows of a global batch."""
    from repro_torch.models.sharding import _block
    return {k: _block(v, 0, sctx.mesh, sctx.batch_axes)
            for k, v in batch.items()}


def _rel(got, want):
    """max |got - want| over max |want|."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.double() - want.double()).abs().max()) / scale


def _grads(cfg, params, batch, remat, sctx=None, n_micro=1):
    from repro_torch.models import lm_loss
    from repro_torch.train.train_step import _accumulated_grads, _Parts

    def fn(p, b):
        return lm_loss(p, cfg, b, remat=remat, sctx=sctx)
    parts = None if sctx is None else _Parts(cfg, sctx)
    loss, grads = _accumulated_grads(fn, params, batch, n_micro, sctx, parts)
    return float(loss), grads


def _grad_case(cfg, sctx, remats, B, S, seed, n_micro=1):
    """Each remat's sharded loss and gradients against the unsharded
    port's: the losses, the largest relative gap of any leaf (and which),
    and the loss's bits (every rank's must be the same)."""
    from repro_torch.models import init_params
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import param_specs, shard_tree
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = batch_of(cfg, B, S, seed)
    want_loss, want = _grads(cfg, params, batch, "full", n_micro=n_micro)
    specs = param_specs(param_shapes(cfg), cfg, sctx)
    want = dict(_leaves(shard_tree(want, specs, sctx.mesh)))
    blocks = shard_tree(params, specs, sctx.mesh)
    out = {}
    for remat in remats:
        loss, got = _grads(cfg, blocks, rows_of(batch, sctx), remat, sctx,
                           n_micro)
        gaps = {k: _rel(g, want[k]) for k, g in _leaves(got)}
        worst = max(gaps, key=gaps.get)
        out[remat] = dict(loss=loss, want_loss=want_loss,
                          err=gaps[worst], worst=worst, leaves=len(gaps),
                          bits=np.float32(loss).tobytes())
    return out


def grads_world(names, remats, B, S, micro, pod_names):
    """Sharded ``lm_loss`` and its gradients on a (data 2, model 2) mesh
    against the unsharded port (f32 smoke configs, every rank's rows of
    one batch of ``B`` x ``S``): ``names`` under each of ``remats``;
    ``micro`` (a config name) with two microbatches; ``pod_names`` on a
    (pod 2, data 1, model 2) mesh."""
    mesh = M.make_test_mesh(data=2, model=2)
    sctx = M.shard_ctx(mesh, mode="train")
    out = {}
    for i, name in enumerate(names):
        out[name] = _grad_case(f32(name), sctx, remats, B, S, seed=i)
    out["micro"] = _grad_case(f32(micro), sctx, ("full",), B, S, seed=40,
                              n_micro=2)["full"]
    psctx = M.shard_ctx(M.make_test_mesh(data=1, model=2, pod=2))
    for i, name in enumerate(pod_names):
        out[("pod", name)] = _grad_case(f32(name), psctx, ("full",), B, S,
                                        seed=50 + i)["full"]
    out["reduce_scatter"] = _reduce_scatter_case(mesh)
    return out


def _reduce_scatter_case(mesh):
    """``reduce_scatter`` against the block of ``seq_sum``, each axis and
    dimension, f32 and bf16: equal bit for bit or not."""
    from repro_torch.models.sharding import _block
    rank = torch.distributed.get_rank()
    x = torch.randn(8, 6, 4, generator=torch.Generator().manual_seed(rank))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for axis in ("data", "model"):
            for dim in (0, 1):
                y = x.to(dt)
                want = _block(M.seq_sum(y, mesh, (axis,)), dim, mesh,
                              (axis,))
                got = M.reduce_scatter(y, mesh, axis, dim)
                out[(str(dt), axis, dim)] = torch.equal(got, want)
    return out


def adamw_world(name, steps, norm):
    """``adamw.update`` on each rank's blocks against the unsharded update
    of the same whole parameters and gradients (heavy-tailed, global norm
    ``norm``), f32 and int8 moments, ``steps`` steps on a (data 2, model
    2) mesh: after each step the gathered parameters and moments (f32
    ``m``/``v``; int8 ``q``/``scale``) equal bit for bit or not, and
    which leaves' int8 moments were updated on the rank's block or whole
    (``sharding.Cut.run``)."""
    from repro_torch.models import init_params, stacked_view
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import (cuts, param_specs,
                                             shard_tree)
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train.train_step import placement
    cfg = f32(name)
    mesh = M.make_test_mesh(data=2, model=2)
    sctx = M.shard_ctx(mesh, mode="train")
    specs = param_specs(param_shapes(cfg), cfg, sctx)
    place = placement(cfg, sctx)
    whole_cuts = cuts(param_shapes(cfg), specs, mesh)
    out = {"local": [], "whole": []}
    for path, cut in _leaves(stacked_view(whole_cuts, cfg)):
        cut = cut[0] if isinstance(cut, list) else cut
        local = not cut.axes or cut.run % adamw.BLOCK == 0
        out["local" if local else "whole"].append(path)
    for moments in ("float32", "int8"):
        ocfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           moment_dtype=moments)
        whole = init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
        blocks = shard_tree(whole, specs, mesh)
        wstate = adamw.init(stacked_view(whole, cfg), ocfg)
        bstate = adamw.init(stacked_view(blocks, cfg), ocfg, place)
        rng = np.random.default_rng(11)
        equal = []
        for _ in range(steps):
            leaves = list(_leaves(whole))
            draws = [rng.standard_normal(tuple(x.shape))
                     * np.exp(rng.standard_normal(tuple(x.shape)))
                     for _, x in leaves]
            total = np.sqrt(sum(np.square(d).sum() for d in draws))
            it = iter(torch.from_numpy((d * (norm / total)).astype(
                np.float32)) for d in draws)
            g = _rebuild(whole, it)
            _, wstate, wstats = adamw.update(stacked_view(g, cfg), wstate,
                                             stacked_view(whole, cfg), ocfg)
            _, bstate, bstats = adamw.update(
                stacked_view(shard_tree(g, specs, mesh), cfg), bstate,
                stacked_view(blocks, cfg), ocfg, place)
            got_state = adamw.whole_state(bstate, stacked_view(blocks, cfg),
                                          place, ocfg)
            got_params = _zip(lambda x, c: c.whole(x), blocks, whole_cuts)
            same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                _leaves(got_params), _leaves(whole)))
            same_state = all(
                torch.equal(a, b) for k in ("m", "v") for (_, a), (_, b)
                in zip(_leaves(got_state[k]), _leaves(wstate[k])))
            # the round trip a restore takes: the whole state cut again
            back = adamw.cut_state(wstate, stacked_view(blocks, cfg), place,
                                   ocfg)
            same_cut = all(
                torch.equal(a, b) for k in ("m", "v") for (_, a), (_, b)
                in zip(_leaves(back[k]), _leaves(bstate[k])))
            equal.append(dict(params=same, moments=same_state,
                              cut=same_cut,
                              norm=(float(bstats["grad_norm"]),
                                    float(wstats["grad_norm"]))))
        out[moments] = equal
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _zip(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(fn, a, b) for a, b in zip(tree, other)]
    return fn(tree, other)


def reference_step_world(ref_file, n_micro):
    """The reference's sharded mixtral step's program on the port: its
    parameters and batch from ``ref_file``, each rank's blocks on a (data
    2, model 2) mesh, one ``make_train_step(sctx=, n_microbatches=)``
    step: the loss and every leaf's largest relative gap of the gathered
    parameters to the reference's updated ones."""
    from repro_torch.models import params_from_reference, stacked_view
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import cuts, param_specs, shard_tree
    from repro_torch.models.convert import params_to_reference
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import placement
    ref = np.load(ref_file, allow_pickle=True)
    cfg = f32("mixtral-8x22b")
    mesh = M.make_test_mesh(data=2, model=2)
    sctx = M.shard_ctx(mesh)
    params = params_from_reference(ref["params"].item(), cfg, device="cpu")
    specs = param_specs(param_shapes(cfg), cfg, sctx)
    blocks = shard_tree(params, specs, mesh)
    ocfg = AdamWConfig(**ref["opt"].item())
    state = adamw.init(stacked_view(blocks, cfg), ocfg,
                       placement(cfg, sctx))
    toks = torch.from_numpy(ref["tokens"])
    step = make_train_step(cfg, ocfg, sctx=sctx, n_microbatches=n_micro)
    blocks, state, m = step(blocks, state, rows_of(
        {"tokens": toks, "labels": toks}, sctx))
    got = _zip(lambda x, c: c.whole(x), blocks,
               cuts(param_shapes(cfg), specs, mesh))
    got = dict(_leaves(params_to_reference(got, cfg)))
    want = ref["new_params"].item()
    gaps = {k: _rel(g, torch.from_numpy(np.asarray(_get(want, k))))
            for k, g in got.items()}
    worst = max(gaps, key=gaps.get)
    return dict(loss=float(m["loss"]), want_loss=float(ref["loss"]),
                err=gaps[worst], worst=worst, leaves=len(gaps))


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# -- compression -------------------------------------------------------------

def _pod_line():
    return torch.distributed.device_mesh.DeviceMesh(
        "cpu", torch.arange(2), mesh_dim_names=("pod",))


def ef_mean_world(g, ef):
    """``compression.ef_allgather_mean`` on a pure pod mesh of 2 ranks:
    rank ``p`` passes ``g[p]``, ``ef[p]``; its mean and new error
    feedback."""
    from repro_torch.train.compression import ef_allgather_mean
    p = torch.distributed.get_rank()
    mean, new_ef = ef_allgather_mean(torch.from_numpy(g[p]),
                                     torch.from_numpy(ef[p]), _pod_line(),
                                     "pod")
    return _np(mean), _np(new_ef)


def payload_world(name):
    """The compressed step's cross-pod sync of each leaf on a (pod 2,
    data 2, model 1) mesh, each rank holding its block within its pod,
    against the pure-pod sync of the whole leaves (every pod's whole
    gradient and error feedback from one seed): the mean gathered to the
    whole leaf and the new error feedback, bit for bit; and which leaves
    the rank quantized on its block."""
    from repro_torch.models import stacked_view
    from repro_torch.train.compression import ef_allgather_mean
    from repro_torch.train.train_step import (_compress_locally,
                                              placement, pod_sync)
    cfg = f32(name)
    mesh = M.make_test_mesh(data=2, model=1, pod=2)
    sctx = dataclasses.replace(M.shard_ctx(mesh), pod=None)
    pod = M.axis_index(mesh, "pod")
    out = {}
    for path, cut in _leaves(placement(cfg, sctx)):
        if not path.endswith("/0") and "layers" in path:
            continue                    # one row of each stacked leaf
        c = cut
        shape = c.full
        rng = np.random.default_rng([len(path), pod])
        g = torch.from_numpy((rng.standard_normal(shape) * np.exp(
            rng.standard_normal(shape))).astype(np.float32))
        ef = torch.from_numpy((rng.standard_normal(shape) * 1e-3).astype(
            np.float32))
        want_mean, want_ef = ef_allgather_mean(g, ef, mesh, "pod")
        local = _compress_locally(c)
        mean, new_ef = pod_sync(c.cut(g), c.cut(ef) if local else ef, c,
                                mesh, "pod")
        got_ef = c.whole(new_ef[0]) if local else new_ef[0]
        out[path] = dict(local=local,
                         mean=torch.equal(c.whole(mean), want_mean),
                         ef=torch.equal(got_ef, want_ef))
    return out


def compressed_world(ref_file, steps):
    """The reference test's program (``test_distributed.py::
    test_compressed_grad_sync_tracks_uncompressed``) on a pure pod mesh of
    2 ranks: deepseek-7b smoke (bf16) from the reference's parameters, 8
    steps of the unsharded step on the global batch and of the compressed
    step on each pod's rows; both loss histories, and the error
    feedback's layout."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import params_from_reference, stacked_view
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import (init_ef_state, make_compressed_train_step,
                                   make_train_step)
    ref = np.load(ref_file, allow_pickle=True)
    cfg = SMOKE_ARCHS["deepseek-7b"]
    mesh = _pod_line()
    pod = M.axis_index(mesh, "pod")
    ocfg = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=0,
                       weight_decay=0.0)
    pipe = TokenPipeline(cfg.vocab, 8, 32)
    p1 = params_from_reference(ref["params"].item(), cfg, device="cpu")
    p2 = params_from_reference(ref["params"].item(), cfg, device="cpu")
    o1 = adamw.init(stacked_view(p1, cfg), ocfg)
    o2 = adamw.init(stacked_view(p2, cfg), ocfg)
    ef = init_ef_state(stacked_view(p2, cfg), 2)
    plain = make_train_step(cfg, ocfg)
    comp = make_compressed_train_step(cfg, ocfg, mesh)
    losses = {"plain": [], "comp": []}
    for t in range(steps):
        whole = {k: torch.from_numpy(v) for k, v in pipe.batch(t).items()}
        mine = {k: torch.from_numpy(v) for k, v in
                pipe.batch(t, host_id=pod, n_hosts=2).items()}
        p1, o1, m1 = plain(p1, o1, whole)
        p2, o2, ef, m2 = comp(p2, o2, ef, mine)
        losses["plain"].append(float(m1["loss"]))
        losses["comp"].append(float(m2["loss"]))
    shapes = {k: tuple(v.shape) for k, v in _leaves(ef)}
    return dict(losses=losses, ef_shapes=shapes)


# -- the trainer under a mesh -------------------------------------------------

def trainer_world(shape, name, dtype, ckpt_dir, tcfg, ocfg, steps=None):
    """A ``Trainer(sctx=)`` run on a (data, model) mesh of ``shape``:
    ``run(steps)`` from whatever ``ckpt_dir`` holds; the loss history
    and the checkpoints' steps after it."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    cfg = dataclasses.replace(SMOKE_ARCHS[name], param_dtype=dtype)
    sctx = M.shard_ctx(M.make_test_mesh(*shape))
    tr = Trainer(cfg, AdamWConfig(**ocfg),
                 TrainConfig(ckpt_dir=ckpt_dir, **tcfg), sctx=sctx)
    tr.run(steps=steps)
    return dict(history=[{k: v for k, v in h.items()
                          if k in ("step", "loss", "grad_norm")}
                         for h in tr.history],
                saved=CheckpointManager(ckpt_dir).steps())
