"""Training steps (port of ``train/train_step.py``): gradients averaged
over microbatches, then AdamW; optionally sharded over a mesh, and the
multi-pod step whose cross-pod gradient sync is int8 with error feedback.

``make_train_step(sctx=)`` runs on each rank of a ``torch.distributed``
mesh with the rank's blocks of the parameters and optimizer state and its
rows of the batch.  Its backward pass gives each rank its parts of the
gradients (``launch.mesh``: the collectives' adjoints); a leaf held whole
on several ranks (along ``pod``, or an axis its placement does not split)
then has its parts added over those axes, in rank order, so that every
rank's gradient of every leaf is its block of the whole model's.

``make_compressed_train_step`` is the multi-pod step: within a pod the
loss and gradients are the pod's (its batch rows, the ``data`` and
``model`` collectives), and across pods the gradients meet in
``compression.ef_allgather_mean`` instead of a sum.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import sharding
from ..models.convert import stacked_view
from ..models.model import lm_loss, param_shapes
from ..optim import adamw
from . import compression

__all__ = ["make_train_step", "make_compressed_train_step", "init_ef_state",
           "placement", "pod_sync"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _like(tree, leaves):
    """``leaves`` (in :func:`_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _cuts(cfg, sctx):
    shapes = param_shapes(cfg)
    return sharding.cuts(shapes, sharding.param_specs(shapes, cfg, sctx),
                         sctx.mesh)


def placement(cfg, sctx):
    """The ``Cut`` of every leaf under ``sctx``, in the stacked structure
    ``optim.adamw`` takes (its ``place``)."""
    return stacked_view(_cuts(cfg, sctx), cfg)


class _Parts:
    """How a rank's gradient parts become its blocks' gradients: each
    rank seeds its backward pass with ``1 / ranks`` (the ranks over which
    the loss is one function), and a leaf's parts are added over the
    axes its placement does not split (but ``skip``)."""

    def __init__(self, cfg, sctx, skip=()):
        mesh = sctx.mesh
        self.mesh, self.tree = mesh, _cuts(cfg, sctx)
        names = tuple(a for a in mesh.mesh_dim_names if a not in skip)
        self.names = names
        self.ranks = 1
        for a in names:
            self.ranks *= sctx.axis_size(a)

    def seed(self, loss):
        return torch.full((), 1.0 / self.ranks, dtype=loss.dtype,
                          device=loss.device)

    def add(self, params, grads):
        """Each leaf's parts added over its axes (``grads`` in
        ``_leaves(params)`` order), one sum a group of leaves of one dtype
        and one set of axes."""
        from ..launch.mesh import seq_sum
        groups = {}
        cuts = _leaves(_by_key(self.tree, params))
        for i, (g, cut) in enumerate(zip(grads, cuts)):
            axes = tuple(a for a in self.names if a not in cut.axes)
            if axes:
                groups.setdefault((axes, g.dtype), []).append(i)
        out = list(grads)
        for (axes, _), idx in groups.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            flat = seq_sum(flat, self.mesh, axes)
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(grads[i])
        return out


def _by_key(tree, like):
    """``tree``'s leaves in ``like``'s structure, dict keys in its order
    (a checkpoint's tree may order them otherwise)."""
    if isinstance(like, dict):
        return {k: _by_key(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_by_key(t, v) for t, v in zip(tree, like)]
    return tree


def _value_and_grad(loss_fn, params, batch, parts=None):
    leaves = list(_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    seed = None if parts is None else parts.seed(loss)
    grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _microbatch(batch, i, n_micro, sctx):
    """Microbatch ``i`` of ``n_micro``: the rows ``[i * B / n_micro, ...)``
    of the global batch, or under a mesh (``batch`` the rank's rows) the
    rank's rows of that global microbatch, as the reference's reshape of
    the global batch gives them."""
    if n_micro == 1:
        return batch
    axes = () if sctx is None else sctx.batch_axes
    out = {}
    for k, v in batch.items():
        if axes:
            from ..launch.mesh import cat
            v = cat(v, sctx.mesh, axes)
        v = v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))[i]
        out[k] = sharding._block(v, 0, sctx.mesh, axes) if axes else v
    return out


def _accumulated_grads(loss_fn, params, batch, n_micro, sctx=None,
                       parts=None):
    """Mean loss and gradients over ``n_micro`` microbatches: for one, the
    gradients in the parameters' dtypes; else summed in f32 accumulators
    and scaled by ``1 / n_micro``, as the reference's scan does.  Under a
    mesh (``parts``) each leaf's parts are added over its axes."""
    if n_micro == 1:
        loss, grads = _value_and_grad(loss_fn, params, batch, parts)
    else:
        leaves = list(_leaves(params))
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n_micro):
            mb = _microbatch(batch, i, n_micro, sctx)
            mb_loss, g = _value_and_grad(loss_fn, params, mb, parts)
            for a, gi in zip(grads, g):
                a.add_(gi.float())
            loss = loss + mb_loss
    if parts is not None:
        grads = parts.add(params, grads)
    if n_micro > 1:
        inv = 1.0 / n_micro
        loss, grads = loss * inv, [a * inv for a in grads]
    return loss, _like(params, grads)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, sctx=None,
                    n_microbatches: int = 1, remat: str = "full",
                    impl: str = "plain"):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` the port's (per-layer) parameters, which it
    updates in place and returns; ``opt_state`` :func:`adamw.init` of
    ``stacked_view(params, cfg)``; ``batch`` tensors on the parameters'
    device with the global batch first; metrics ``loss``, ``lr`` and
    ``grad_norm`` as 0-dim tensors.  ``impl`` defaults to the plain
    attention: kernel B2 has no backward and raises under autograd.

    With ``sctx`` (a :class:`~repro_torch.models.sharding.ShardCtx` over a
    ``DeviceMesh``), every rank of the mesh calls the step with its blocks
    (``shard_tree`` under ``param_specs``, or ``init_params(sctx=)``),
    ``opt_state`` :func:`adamw.init` of them with
    ``place=placement(cfg, sctx)``, and its rows of the global batch; the
    loss and metrics are the global ones on every rank."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got "
                         f"{n_microbatches}")
    parts = None if sctx is None else _Parts(cfg, sctx)
    place = None if sctx is None else placement(cfg, sctx)

    def loss_fn(p, mb):
        return lm_loss(p, cfg, mb, impl=impl, remat=remat, sctx=sctx)

    def train_step(params, opt_state, batch):
        loss, grads = _accumulated_grads(loss_fn, params, batch,
                                         n_microbatches, sctx, parts)
        _, opt_state, stats = adamw.update(
            stacked_view(grads, cfg), opt_state, stacked_view(params, cfg),
            opt_cfg, place)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def _compress_locally(cut) -> bool:
    """Whether a leaf's block is whole blocks of compression's
    quantization of the leaf (see ``sharding.Cut.run``)."""
    return cut is None or not cut.axes or cut.run % compression.BLOCK == 0


def pod_sync(g, ef, cut, mesh, pod_axis="pod"):
    """One leaf's compressed mean over ``pod_axis`` (the compressed step's
    cross-pod sync): ``g`` the rank's gradient (a stacked leaf's list of
    slices, or a tensor), ``ef`` its pod's error feedback, ``cut`` the
    leaf's ``sharding.Cut`` within a pod (None: whole on every rank).
    Returns ``(mean, new_ef[None])``: the rank's block of the mean, and
    the error feedback of what it quantized (its block, or the whole
    leaf)."""
    cut = cut[0] if isinstance(cut, list) else cut
    lead = 1 if isinstance(g, list) else 0
    g = torch.stack(g) if isinstance(g, list) else g
    if _compress_locally(cut):
        mean, new_ef = compression.ef_allgather_mean(g, ef, mesh, pod_axis)
    else:
        mean, new_ef = compression.ef_allgather_mean(
            cut.whole(g.float(), lead), ef, mesh, pod_axis)
        mean = cut.cut(mean, lead)
    return mean, new_ef[None]


def make_compressed_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh,
                               sctx=None, n_microbatches: int = 1,
                               remat: str = "full", pod_axis: str = "pod"):
    """The multi-pod train step ``(params, opt_state, ef, batch) ->
    (params, opt_state, ef, metrics)`` with the int8 + error-feedback
    compressed cross-pod gradient sync, on each rank of ``mesh`` (which
    has ``pod_axis``).

    Within a pod the step is the pod's own: its rows of the batch (each
    rank passes its rows over the pod and batch axes), the loss and
    gradients over its ranks (``sctx`` with ``pod=None``, the reference's
    ``inner_sctx``; no ``sctx``: every rank of a pod holds the whole
    model).  Each leaf's gradient then goes through
    :func:`compression.ef_allgather_mean` over ``pod_axis``: the rank's
    block where it is whole blocks of the leaf's quantization, else the
    leaf gathered and quantized whole (its error feedback whole too), so
    that the payload is the leaf's along its global flattening.  The loss
    is averaged over the pods.

    ``ef``: :func:`init_ef_state` (the reference's layout, a leading pod
    dimension); each rank reads its pod's row, and the step returns the
    rank's row (leading dimension 1)."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got "
                         f"{n_microbatches}")
    from ..launch.mesh import axis_index, axis_size, seq_sum
    n_pods = axis_size(mesh, pod_axis)
    pod = axis_index(mesh, pod_axis)
    inner = dataclasses.replace(sctx, pod=None) if sctx is not None else None
    parts = (None if inner is None
             else _Parts(cfg, inner, skip=(pod_axis,)))
    place = None if inner is None else placement(cfg, inner)

    def loss_fn(p, mb):
        return lm_loss(p, cfg, mb, impl="plain", remat=remat, sctx=inner)

    def sync(g, e, pl=None):
        e = e[pod] if e.shape[0] == n_pods and n_pods > 1 else e[0]
        return pod_sync(g, e, pl, mesh, pod_axis)

    def train_step(params, opt_state, ef, batch):
        loss, grads = _accumulated_grads(loss_fn, params, batch,
                                         n_microbatches, inner, parts)
        loss = seq_sum(loss, mesh, (pod_axis,)) / n_pods
        view = stacked_view(grads, cfg)
        trees = (view, ef) if place is None else (view, ef, place)
        synced = adamw._map(sync, *trees)
        grads = adamw._map(lambda t: t[0], synced)
        new_ef = adamw._map(lambda t: t[1], synced)
        _, opt_state, stats = adamw.update(
            grads, opt_state, stacked_view(params, cfg), opt_cfg, place)
        return params, opt_state, new_ef, {"loss": loss, **stats}

    return train_step


def init_ef_state(params, n_pods: int, place=None):
    """Zero error feedback for :func:`make_compressed_train_step` in the
    reference's layout (``compression.init_ef``): ``params`` in the
    stacked structure (``stacked_view``), each leaf ``[n_pods, *leaf]``
    f32.  Under a mesh (``place``, the step's placement with the pod axis
    dropped) each leaf is the rank's block, or the whole leaf where the
    step compresses it whole."""
    if place is None:
        return compression.init_ef(params, n_pods)

    def leaf(p, pl):
        cut = pl[0] if isinstance(pl, list) else pl
        ef = compression.init_ef(p, n_pods)
        if _compress_locally(cut):
            return ef
        lead = 1 if isinstance(p, list) else 0
        return ef.new_zeros(tuple(ef.shape[:1 + lead]) + cut.full)

    return adamw._map(leaf, params, place)
