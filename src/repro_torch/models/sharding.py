"""Sharding rules and the sharded layers' compute (port of
``models/sharding.py``).

Mesh axes (see :mod:`repro_torch.launch.mesh`):
  * ``data``: FSDP + batch data parallelism;
  * ``model``: tensor parallelism (heads, the MLP's width, the vocabulary);
  * ``pod``: pure data parallelism across pods (parameters replicated per
    pod).

The rules are the reference's, name for name: name-based over the
parameter tree, in two modes (``train``: FSDP over ``data``; ``serve``:
weights resident, model-parallel over both axes where a dimension
divides), each degrading to replication where a dimension does not divide
its axis (the ``_div`` guard).  A placement is a tuple with one entry a
tensor dimension: ``None`` (whole on every rank), an axis name, or a
tuple of axis names (the dimension split over their product, the first
axis major), the entries of the reference's ``PartitionSpec``.  The port
keeps one dict a layer (``models/convert.py``), so its leaves have no
period dimension and their placements no leading ``None``.  The rules
read only the mesh's shape: a ``DeviceMesh`` or an :class:`AbstractMesh`.

JAX's compiler turns placements into collectives; here the sharded serve
path (:mod:`.model`'s ``forward``, ``serving.serve_step``) runs the same
layer code on each rank's blocks, and a :class:`Local` view places the
blocks and adds the collectives around it: the batch over ``(pod,)
data``; attention and MLA heads over ``model`` (kernels B2 and B3 run on
each rank's local heads, the output projection summed over ``model``),
or, where an attention layer's KV heads do not divide ``model``, the KV
cache's slots over ``model`` (B3's partial on each rank's block of slots
for every head, the partials merged in rank order: the cross-slot
softmax that the reference's GSPMD program does implicitly); the
MLP's width and the vocabulary over the axes their placement names (the
activations gathered over the batch axes among them, the partial outputs
summed, the logits concatenated); MoE experts over the axes of their
placement and their width over the rest, with the whole batch as the
dispatch groups; a recurrent layer's channels over the axes of its input
projection's placement (:class:`Channels`); any other split dimension,
such as FSDP's, gathered before use.  Sums over ranks add in a fixed
order, so every rank of an axis holds the same values bit for bit.

Training (``model.lm_loss(sctx=)``) runs the same path under autograd on
each rank's rows of the batch (a :class:`Local` with ``train=True``):
the collectives are differentiable (``launch.mesh``: a gather's adjoint
is a reduce-scatter, a sum's a sum), MoE routes each rank's own rows (a
dispatch group is a sequence), and the loss's log-probabilities are
taken from each rank's block of the vocabulary
(:meth:`Local.label_logprobs`), so no rank gathers the logits.

A projection whose output is several components side by side (``PARTS``:
Mamba's ``in_proj`` ``[x | z]``, mLSTM's ``up_proj``, sLSTM's gates ``W``)
splits each component over the axes its placement names, so that a
rank's block is a block of channels; GSPMD's contiguous block of the flat
dimension means the same values, laid out otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

__all__ = ["ShardCtx", "AbstractMesh", "mesh_shape", "param_specs",
           "serve_state_shardings", "shard_tree", "cuts", "Cut", "Local",
           "Channels"]

# projections whose last dimension holds this many components side by side
PARTS = {"in_proj": 2, "up_proj": 2, "W": 4}


class AbstractMesh:
    """A mesh's axis names and sizes with no ranks behind it (the rules'
    tables at production shapes without a world).

    >>> AbstractMesh((16, 16), ("data", "model")).shape
    {'data': 16, 'model': 16}
    """

    def __init__(self, axis_sizes, axis_names):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in axis_sizes)))


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static sharding context threaded through the model code.

    mode="train": FSDP over ``data`` (weights gathered per layer).
    mode="serve": weights resident, model-parallel over both axes where
    divisible: a decode step moves activations, not weights."""
    mesh: Any
    fsdp: str = "data"
    tp: str = "model"
    pod: Optional[str] = None       # set on the multi-pod mesh
    mode: str = "train"             # train | serve

    @property
    def batch_axes(self):
        return (self.pod, self.fsdp) if self.pod else (self.fsdp,)

    def axis_size(self, name) -> int:
        return mesh_shape(self.mesh)[name]

    def _bsz(self):
        n = self.axis_size(self.fsdp)
        if self.pod:
            n *= self.axis_size(self.pod)
        return n


def _div(n, size):
    return n % size == 0


def _serve_rule(name: str, shape: Tuple[int, ...], cfg, sctx: ShardCtx):
    """Inference-mode placement (weights resident, model-parallel over
    both axes where divisible); None falls through to :func:`_rule`."""
    tp, fsdp = sctx.tp, sctx.fsdp
    tp_n = sctx.axis_size(tp)
    flat_n = tp_n * sctx.axis_size(fsdp)
    H, Hkv = cfg.n_heads, cfg.n_kv_heads

    def flat_if(dim):
        if dim % flat_n == 0:
            return (tp, fsdp)
        return tp if dim % tp_n == 0 else None

    if len(shape) == 1 or name in ("bq", "bk", "bv", "router"):
        return (None,) * len(shape)
    if name == "embed":
        return (flat_if(shape[0]), None)
    if name == "lm_head":
        return (None, flat_if(shape[1]))
    if name == "wq":
        return (None, tp if _div(H, tp_n) else None, None)
    if name in ("wk", "wv") and len(shape) == 3:
        return (None, tp if _div(Hkv, tp_n) else None, None)
    if name == "wo" and len(shape) == 3:
        return (tp if _div(shape[0], tp_n) else None, None, None)
    if name in ("w_kva", "w_qa"):
        return (None, None)
    if name in ("w_kvb", "w_qb", "w_q"):
        return (None, tp if _div(H, tp_n) else None, None)
    if name in ("w_gate", "w_up") and len(shape) == 3:    # [E, d, ff]
        if _div(shape[0], tp_n):
            return (tp, None, fsdp if _div(shape[2],
                                           sctx.axis_size(fsdp)) else None)
        return (None, None, flat_if(shape[2]))
    if name == "w_down" and len(shape) == 3:              # [E, ff, d]
        if _div(shape[0], tp_n):
            return (tp, fsdp if _div(shape[1],
                                     sctx.axis_size(fsdp)) else None, None)
        return (None, flat_if(shape[1]), None)
    if name in ("w_gate", "w_up"):                        # dense [d, ff]
        return (None, flat_if(shape[1]))
    if name == "w_down":                                  # [ff, d]
        return (flat_if(shape[0]), None)
    if name in ("in_proj", "up_proj", "W"):
        return (None, flat_if(shape[1]))
    if name in ("out_proj", "down_proj"):
        return (flat_if(shape[0]), None)
    return None


def _rule(name: str, shape: Tuple[int, ...], cfg, tp_size: int,
          fsdp: str, tp: str):
    """Placement of one (per-layer) parameter leaf, by name and rank."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads

    def tp_if(dim_ok):
        return tp if dim_ok else None

    if len(shape) == 1:
        return (None,)                                   # norms, biases
    if name in ("bq", "bk", "bv"):
        return (None, None)

    if name == "embed":
        return (tp_if(_div(shape[0], tp_size)), fsdp)
    if name == "lm_head":
        return (fsdp, tp_if(_div(shape[1], tp_size)))

    # attention
    if name == "wq":
        return (fsdp, tp_if(_div(H, tp_size)), None)
    if name in ("wk", "wv") and len(shape) == 3:
        return (fsdp, tp_if(_div(Hkv, tp_size)), None)
    if name == "wo" and len(shape) == 3:
        return (tp_if(_div(shape[0], tp_size)), None, fsdp)

    # MLA
    if name == "w_kva":
        return (fsdp, None)
    if name == "w_kvb":
        return (None, tp_if(_div(H, tp_size)), None)
    if name == "w_qa":
        return (fsdp, None)
    if name in ("w_qb", "w_q"):
        return (None if name == "w_qb" else fsdp,
                tp_if(_div(H, tp_size)), None)

    # MoE
    if name == "router":
        return (fsdp, None)
    if name in ("w_gate", "w_up") and len(shape) == 3:   # [E, d, ff]
        if _div(shape[0], tp_size):
            return (tp, fsdp, None)
        return (None, fsdp, tp_if(_div(shape[2], tp_size)))
    if name == "w_down" and len(shape) == 3:             # [E, ff, d]
        if _div(shape[0], tp_size):
            return (tp, None, fsdp)
        return (None, tp_if(_div(shape[1], tp_size)), fsdp)

    # dense MLP
    if name in ("w_gate", "w_up"):                        # [d, ff]
        return (fsdp, tp_if(_div(shape[1], tp_size)))
    if name == "w_down":                                  # [ff, d]
        return (tp_if(_div(shape[0], tp_size)), fsdp)

    # mamba / xlstm
    if name in ("in_proj", "up_proj", "W"):               # [d, k*di]
        return (fsdp, tp_if(_div(shape[1], tp_size)))
    if name == "conv_w":                                  # [dc, di]
        return (None, tp_if(_div(shape[1], tp_size)))
    if name in ("x_proj", "out_proj", "down_proj"):       # [di, *]
        return (tp_if(_div(shape[0], tp_size)),
                fsdp if name != "x_proj" else None)
    if name == "dt_w":                                    # [dtr, di]
        return (None, tp_if(_div(shape[1], tp_size)))
    if name == "A_log":                                   # [di, ds]
        return (tp_if(_div(shape[0], tp_size)), None)
    if name in ("wq2", "wk2", "wv2"):                     # mlstm [di, di]
        return (fsdp, tp_if(_div(shape[1], tp_size)))
    if name in ("w_i", "w_f"):                            # [di, H]
        return (fsdp, None)
    if name == "R":                                       # slstm [H, dh, 4dh]
        return (None, None, None)

    # default: replicate
    return (None,) * len(shape)


def _visit(tree, fn, keys=()):
    if isinstance(tree, dict):
        return {k: _visit(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_visit(v, fn, keys) for v in tree]
    return fn(keys, tree)


def param_specs(params, cfg, sctx: ShardCtx):
    """The placement of every leaf of the port's parameters (the tree of
    ``init_params``, or any tree of that structure whose leaves have a
    ``shape``)."""
    tp_size = sctx.axis_size(sctx.tp)

    def leaf(keys, x):
        # leaf name = last key ("scale" folds into its norm)
        name = keys[-1] if keys[-1] != "scale" else keys[-2]
        shape = tuple(x.shape)
        # mlstm q/k/v are square [di, di]; disambiguate from attention wq
        if name in ("wq", "wk", "wv") and len(shape) == 2:
            name = name[0:2] + "2"
        spec = None
        if sctx.mode == "serve":
            spec = _serve_rule(name, shape, cfg, sctx)
        if spec is None:
            spec = _rule(name, shape, cfg, tp_size, sctx.fsdp, sctx.tp)
        return spec

    return _visit(params, leaf)


def serve_state_shardings(cfg, sctx: ShardCtx, state):
    """Placements of a serve state's leaves (the reference's policy):
    batch over (pod,) data when divisible; KV heads over model when
    divisible, else slots over model; recurrent inner dims over model;
    DAC control rows ``[B, Bmax]`` slot-sharded over model.

    These are the reference's tables (``tests/test_torch_mesh.py`` holds
    them equal).  The sharded serve path (:class:`Local`) places an
    attention layer's KV cache as they say (a cache whose heads do not
    divide ``model`` split by slots, :meth:`Local.kv_block`), and MLA's
    ``latent``/``krope`` too (their slots over ``model`` where it divides
    them, :meth:`Local.latent_block`), and some other leaves otherwise:

    * DAC's control rows whole on every model rank (they are tiny, and
      DAC's control must agree across the model ranks that attend over
      one pool), the batch over the batch axes;
    * Mamba's ``conv``/``h`` and mLSTM's ``conv``/``C``/``n``/``m``: the
      channels (heads) over the layer's channel axes, those of its input
      projection's placement (serve mode: ``(model, data)``), and the
      batch over the batch axes outside them (serve mode: whole);
    * sLSTM's cell state whole on every model rank (the cell is not
      split), the batch over the batch axes."""
    tp_n = sctx.axis_size(sctx.tp)

    def b_axes(B):
        if B % sctx._bsz():
            return None
        axes = sctx.batch_axes          # one axis is named, not a 1-tuple
        return axes[0] if len(axes) == 1 else axes

    def tp_if(n):
        return sctx.tp if n % tp_n == 0 else None

    def leaf(keys, x):
        name, sh = keys[-1], tuple(x.shape)
        b = b_axes(sh[0])
        if name == "pos":
            return (b,)
        if name in ("k", "v"):                  # [B, L, Hkv, hd]
            if sh[2] % tp_n == 0:
                return (b, None, sctx.tp, None)
            return (b, tp_if(sh[1]), None, None)
        if name in ("latent", "krope"):         # [B, L, r]
            return (b, tp_if(sh[1]), None)
        if name in ("rank2slot", "free", "slot_pos"):   # [B, Bmax]
            return (b, tp_if(sh[1]))
        if name in ("length", "k_active", "jump", "jump2"):
            return (b,)
        if name == "conv":                      # [B, dc-1, di]
            return (b, None, tp_if(sh[2]))
        if name == "h" and len(sh) == 3:        # mamba h [B, di, ds]
            return (b, tp_if(sh[1]), None)
        if name == "C":                         # mlstm [B, H, dh, dh]
            return (b, tp_if(sh[1]), None, None)
        if name == "n" and len(sh) == 3:        # mlstm n [B, H, dh]
            return (b, tp_if(sh[1]), None)
        if name == "m" and len(sh) == 2:        # mlstm m [B, H]
            return (b, tp_if(sh[1]))
        if len(sh) == 2:                        # slstm h/c/n/m [B, d]
            return (b, tp_if(sh[1]))
        return (None,) * len(sh)

    return _visit(state, leaf)


# ---------------------------------------------------------------------------
# one rank's part
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    """A placement entry as a tuple of axis names (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(mesh, axes) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dimension split over
    ``axes``, the first axis major."""
    from ..launch.mesh import axis_index, axis_size
    idx, n = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        idx, n = idx * size + axis_index(mesh, a), n * size
    return idx, n


def _block(x, dim, mesh, axes, parts=1):
    """This rank's block of ``x`` along ``dim`` split over ``axes``; a
    dimension of ``parts`` components side by side splits each."""
    idx, n = _index(mesh, axes)
    if n == 1:
        return x
    dim %= x.dim()
    size = x.shape[dim]
    if size % (n * parts):
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axes} ({n} ranks, {parts} parts)")
    if parts > 1:
        x = x.unflatten(dim, (parts, size // parts))
        return _block(x, dim + 1, mesh, axes).flatten(dim, dim + 1)
    return x.narrow(dim, idx * (size // n), size // n)


def _cat(x, mesh, axes, dim, parts=1):
    """The blocks of ``x`` over ``axes`` concatenated along ``dim`` (of
    ``parts`` components, each concatenated)."""
    from ..launch.mesh import cat
    dim %= x.dim()
    if parts == 1:
        return cat(x, mesh, axes, dim)
    x = x.unflatten(dim, (parts, x.shape[dim] // parts))
    return cat(x, mesh, axes, dim + 1).flatten(dim, dim + 1)


def _parts(name, dim, ndim):
    """The components of dimension ``dim`` of leaf ``name``."""
    return PARTS.get(name, 1) if dim == ndim - 1 else 1


def shard_tree(tree, specs, mesh):
    """This rank's blocks of the full tensors of ``tree`` under
    ``specs`` (a tree of placements of the same structure), as new
    contiguous tensors."""
    def walk(t, s, keys=()):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], keys + (k,)) for k in t}
        if isinstance(t, list):
            return [walk(a, b, keys) for a, b in zip(t, s)]
        return Cut(s, tuple(t.shape), mesh, keys[-1])(t).contiguous()

    return walk(tree, specs)


def cuts(shapes, specs, mesh):
    """The tree of :class:`Cut` of every leaf of ``shapes`` (a tree whose
    leaves have a ``shape``: the whole leaves') under ``specs``."""
    def walk(t, s, keys=()):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], keys + (k,)) for k in t}
        if isinstance(t, list):
            return [walk(a, b, keys) for a, b in zip(t, s)]
        return Cut(s, tuple(t.shape), mesh, keys[-1])

    return walk(shapes, specs)


class Cut:
    """This rank's block of a leaf of full shape ``shape`` named ``name``
    under placement ``spec``: :meth:`__call__` cuts it from the whole
    leaf, :meth:`inner` from a slice of its rows (``rows``: the block's
    first row and row count), so that a rank can build its block from
    the whole leaf's draws slice by slice (``models.init_params``).  The
    cuts are views where the layout allows."""

    def __init__(self, spec, shape, mesh, name=""):
        self.spec, self.mesh, self.full = spec, mesh, tuple(shape)
        idx, n = _index(mesh, _axes(spec[0]))
        self.rows = (idx * (shape[0] // n), shape[0] // n)
        nd = len(shape)
        self.shape = tuple(
            size // _index(mesh, _axes(e))[1] for size, e in zip(shape, spec))
        self._parts = [_parts(name, d, nd) for d in range(nd)]

    @property
    def axes(self) -> tuple:
        """Every axis the leaf splits over (it is whole across the
        others)."""
        return tuple(a for e in self.spec for a in _axes(e))

    @property
    def run(self) -> int:
        """The length of the runs the block's elements make in the whole
        leaf's flattening (the runs start at multiples of it): the
        innermost split dimension's block extent (a component's, for a
        dimension of several) times the whole extents inside it; the
        whole leaf's size if nothing splits.  A blockwise quantization
        of the whole leaf's flattening (``optim.adamw``,
        ``train.compression``) is the block's own where its block size
        divides the run, also for a stack of such leaves."""
        run = math.prod(self.full)
        inner = 1
        for d in reversed(range(len(self.full))):
            if _axes(self.spec[d]):
                return inner * self.shape[d] // self._parts[d]
            inner *= self.full[d]
        return run

    def whole(self, x, lead=0):
        """The whole leaf from the blocks ``x`` of every rank (``lead``
        leading dimensions, such as a stack's, before the leaf's own);
        every rank runs it."""
        for dim, entry in enumerate(self.spec):
            if _axes(entry):
                x = _cat(x, self.mesh, _axes(entry), dim + lead,
                         self._parts[dim])
        return x

    def cut(self, x, lead=0):
        """:meth:`__call__` of a stack of whole leaves (``lead`` leading
        dimensions)."""
        for dim, entry in enumerate(self.spec):
            x = _block(x, dim + lead, self.mesh, _axes(entry),
                       self._parts[dim])
        return x

    def inner(self, x):
        """The block's columns (every dimension but the first) of rows
        of the leaf."""
        for dim, entry in enumerate(self.spec[1:], 1):
            x = _block(x, dim, self.mesh, _axes(entry), self._parts[dim])
        return x

    def __call__(self, x):
        return self.cut(x)


def _mlp_want(f):
    """A dense gated MLP's layout with its width over ``f``."""
    return {"w_gate": ((), f), "w_up": ((), f), "w_down": (f, ())}


class Local:
    """One rank's view of a :class:`ShardCtx` for a batch of ``B``
    sequences: where its blocks lie and the collectives around the layers'
    compute, which runs unchanged on the rank's weights (``.model``'s
    ``forward`` and ``serving.serve_step``).  ``specs`` are the placements
    of the parameters (``param_specs`` of the full shapes), which this rank
    holds its blocks of.

    The batch splits over the ctx's batch axes when ``B`` divides their
    product, as the reference places it; otherwise every rank holds the
    whole batch.  Attention and MLA heads split over ``model`` when both
    the query and the KV heads divide it; otherwise every model rank runs
    all heads, and an attention layer's KV cache splits by slots over
    ``model`` where they divide it (:meth:`kv_block`; a decode step over
    such a cache splits the query heads as :attr:`slot_heads` says).  An
    MLA layer's latent cache splits by slots wherever ``model`` divides
    them (:meth:`latent_block`), its heads split as :attr:`heads` says:
    a decode step gathers every head's absorbed query (:meth:`slot_q`)
    and projects the rank's block of the merged heads (:meth:`slot_rows`,
    :meth:`slot_out`).  The
    MLP's width, the vocabulary and MoE's experts and their width split
    over the axes their placements name; a recurrent layer's channels as
    :meth:`channels` says.

    ``train``: the inputs are this rank's rows of the batch already (of
    ``B`` in all), and MoE routes each rank's rows, a sequence being a
    dispatch group (serving gathers the batch, so that a decode step's
    one group is the whole batch)."""

    def __init__(self, sctx: ShardCtx, cfg, B: int, specs, train=False):
        from ..launch.mesh import check_mesh
        self.sctx, self.cfg, self.B, self.specs = sctx, cfg, int(B), specs
        self.train = bool(train)
        self.mesh = check_mesh(sctx.mesh)
        self.b_axes = sctx.batch_axes if B % sctx._bsz() == 0 else ()
        tp_n = sctx.axis_size(sctx.tp)
        self.heads = ((sctx.tp,) if _div(cfg.n_heads, tp_n)
                      and _div(cfg.n_kv_heads, tp_n) else ())
        self.tp_n = tp_n if self.heads else 1
        self.v_axes = _axes(specs["embed"][0] if cfg.tie_embeddings
                            else specs["lm_head"][1])
        self.kinds = [cfg.period[i % len(cfg.period)].kind
                      for i in range(len(specs["layers"]))]
        self.ff_axes = [_axes(s["mlp"]["w_gate"][1]) if "mlp" in s else ()
                        for s in specs["layers"]]
        self.chan = [self._channel_axes(s, k)
                     for s, k in zip(specs["layers"], self.kinds)]

    def _size(self, axes) -> int:
        return math.prod(self.sctx.axis_size(a) for a in axes)

    def _fit(self, axes, n) -> tuple:
        """The longest leading run of ``axes`` whose ranks divide ``n``."""
        while axes and n % self._size(axes):
            axes = axes[:-1]
        return axes

    def _channel_axes(self, s, kind) -> tuple:
        """A recurrent layer's channel axes: those of its input
        projection's output placement, as far as they divide the channels
        (Mamba) or the heads (mLSTM: a rank's channels are whole heads).
        The sLSTM cell is not split (its gates interleave the heads, and
        its group norm spans every channel)."""
        if kind == "mamba":
            return self._fit(_axes(s["mamba"]["in_proj"][1]),
                             self.cfg.mamba.expand * self.cfg.d_model)
        if kind == "mlstm":
            return self._fit(_axes(s["mlstm"]["up_proj"][1]),
                             self.cfg.n_heads)
        return ()

    # -- the batch ------------------------------------------------------
    def rows(self, x, axes=None):
        """This rank's batch rows (dim 0) of a full-batch tensor."""
        return _block(x, 0, self.mesh, self.b_axes if axes is None else axes)

    def cat(self, x, axes, dim=0, parts=1):
        """The blocks of ``x`` over ``axes`` concatenated along ``dim``
        (of ``parts`` components, each concatenated)."""
        return _cat(x, self.mesh, axes, dim, parts)

    def sum(self, x, axes):
        from ..launch.mesh import seq_sum
        return seq_sum(x, self.mesh, axes) if axes else x

    def reduce(self, x, axes, g=()):
        """This rank's rows of the sum over ``axes`` of each rank's
        partial ``x``, whose rows are gathered over the batch axes ``g``:
        summed over the axes among ``g`` first, the rows taken, then
        summed over the others (half the bytes of the second sum)."""
        x = self.sum(x, tuple(a for a in axes if a in g))
        if g:
            x = self.rows(x, g)
        return self.sum(x, tuple(a for a in axes if a not in g))

    def _batch_axes_of(self, axes):
        return tuple(a for a in axes if a in self.b_axes)

    # -- weights ----------------------------------------------------------
    def use(self, w, spec, want, parts=1):
        """``w`` (this rank's block under ``spec``) laid out as the
        compute wants it: ``want[d]`` the axes dimension ``d`` is split
        over in the compute (the last dimension of ``parts`` components
        split each).  A block of the held block is cut; any other split
        the compute does not keep is gathered, then cut."""
        last = w.dim() - 1
        for dim, (entry, keep) in enumerate(zip(spec, want)):
            have, keep = _axes(entry), tuple(keep)
            k = parts if dim == last else 1
            if have == keep:
                continue
            if keep[:len(have)] == have:
                w = _block(w, dim, self.mesh, keep[len(have):], k)
                continue
            if have:
                w = self.cat(w, have, dim, k)
            if keep:
                w = _block(w, dim, self.mesh, keep, k)
        return w

    def _place(self, p, spec, want):
        """The dict ``p`` of blocks laid out as ``want`` (leaf name ->
        its ``use`` layout, a nested dict for a nested one) says; a leaf
        it does not name is whole."""
        return {k: self._place(w, spec[k], want.get(k, {}))
                if isinstance(w, dict) else
                self.use(w, spec[k], want.get(k, ((),) * w.dim()),
                         PARTS.get(k, 1))
                for k, w in p.items()}

    def _want(self, i, slots=False):
        """Layer ``i``'s compute layout (``_place``'s ``want``); ``slots``:
        a decode step's over a slot-split KV cache (:meth:`slot_heads`)."""
        spec, kind, H = self.specs["layers"][i], self.kinds[i], self.heads
        want = {}
        if kind == "attn":
            Q = self.slot_heads if slots else H
            want["attn"] = {"wq": ((), Q, ()), "wk": ((), H, ()),
                            "wv": ((), H, ()), "wo": (Q, (), ()),
                            "bq": (Q, ()), "bk": (H, ()), "bv": (H, ())}
        elif kind == "mla":
            want["attn"] = {"w_q": ((), H, ()), "w_qb": ((), H, ()),
                            "w_kvb": ((), H, ()), "wo": (H, (), ())}
        elif kind == "mamba":
            c = self.chan[i]
            want["mamba"] = {"in_proj": ((), c), "conv_w": ((), c),
                             "conv_b": (c,), "x_proj": (c, ()),
                             "dt_w": ((), c), "dt_b": (c,), "A_log": (c, ()),
                             "D": (c,), "out_proj": (c, ())}
        elif kind == "mlstm":
            c = self.chan[i]
            want["mlstm"] = {k: ((), c) for k in ("up_proj", "conv_w", "wq",
                                                  "wk", "wv", "w_i", "w_f")}
            want["mlstm"].update({k: (c,) for k in ("conv_b", "b_i", "b_f",
                                                    "skip")},
                                 down_proj=(c, ()))
        else:                                               # slstm
            want["slstm"] = {
                "W": ((), self._gate_axes(spec)),
                "ffn": _mlp_want(_axes(spec["slstm"]["ffn"]["w_gate"][1]))}
        if "mlp" in spec:
            want["mlp"] = _mlp_want(self.ff_axes[i])
        if "moe" in spec:
            e, f = self._experts(i)
            want["moe"] = {"w_gate": (e, (), f), "w_up": (e, (), f),
                           "w_down": (e, f, ())}
            if "shared" in spec["moe"]:
                want["moe"]["shared"] = _mlp_want(self.shared_axes(i))
        return want

    def layer(self, i, p, slots=False):
        """Layer ``i``'s weights ``p`` (this rank's blocks) as its compute
        takes them: attention and MLA heads as :attr:`heads` says (with
        ``slots``, a decode step over a slot-split KV cache, the query
        heads and the output projection's as :meth:`slot_heads` says), a
        recurrent layer's channels over :meth:`channels`' axes, MLP and
        expert widths and the experts over their placements' axes, every
        other dimension whole (an FSDP split gathered)."""
        return self._place(p, self.specs["layers"][i], self._want(i, slots))

    # -- around the layers --------------------------------------------------
    def embed(self, table, tokens):
        """Embedding rows of this rank's batch: the vocabulary split over
        :attr:`v_axes`' placement in the table, each rank looking up the
        tokens in its block and the blocks summed (one nonzero row each).
        Where the table's model dimension splits over batch axes (FSDP's
        placement), the table is not gathered: each rank looks up the
        rows of every rank along those axes in its columns, and the
        columns are gathered, so that the table's gradient stays on its
        rank (a lookup's scatter) instead of a table-sized reduce-scatter.
        The rows are the same bits either way."""
        spec = self.specs["embed"]
        v_axes = _axes(spec[0])
        keep = self._batch_axes_of(_axes(spec[1]))
        table = self.use(table, spec, (v_axes, keep))
        g = self._batch_axes_of(v_axes)
        if self.train:                  # the rank's rows already
            tok = self.cat(tokens, g + keep) if g + keep else tokens
        else:
            tok = self.rows(tokens, tuple(a for a in self.b_axes
                                          if a not in g + keep))
        idx, n = _index(self.mesh, v_axes)
        rows = table.shape[0]
        local = tok.long() - idx * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        x = self.reduce(x, v_axes, g)
        if keep:
            x = self.rows(self.cat(x, keep, dim=-1), keep)
        return x

    def heads_sum(self, x):
        """A sum over the attention heads of each model rank's partial
        ``x`` (the output projection, B3's per-slot mass), added in
        model-rank order: the same on every model rank."""
        return self.sum(x, self.heads)

    def mlp(self, axes, x, fn):
        """``fn`` (an MLP on this rank's width, split over ``axes``) on
        this rank's rows ``x``, gathered over the batch axes among
        ``axes``; the partial outputs summed over ``axes``, and the rank's
        rows taken back."""
        g = self._batch_axes_of(axes)
        return self.reduce(fn(self.cat(x, g) if g else x), axes, g)

    def _experts(self, i):
        """(expert axes, expert width axes) of layer ``i``'s MoE."""
        w = self.specs["layers"][i]["moe"]["w_gate"]
        return _axes(w[0]), _axes(w[2])

    def experts(self, i):
        """(this rank's first expert, the axes its partial outputs sum
        over) of layer ``i``'s MoE: its experts are a block over the
        expert axes, its expert width one over the width axes."""
        e, f = self._experts(i)
        n = self.cfg.moe.n_experts // self._size(e)
        return _index(self.mesh, e)[0] * n, e + f

    def shared_axes(self, i):
        """The axes layer ``i``'s shared experts' width splits over."""
        return _axes(self.specs["layers"][i]["moe"]["shared"]["w_gate"][1])

    def _gate_axes(self, spec):
        """The axes an sLSTM layer's gate columns (``W``'s, each gate's
        block) split over: its placement's, as far as they divide."""
        return self._fit(_axes(spec["slstm"]["W"][1]), self.cfg.d_model)

    def channels(self, i):
        """Layer ``i``'s :class:`Channels` (None for attention and MLA)."""
        kind = self.kinds[i]
        if kind in ("attn", "mla"):
            return None
        if kind != "slstm":
            return Channels(self, self.chan[i])
        spec = self.specs["layers"][i]
        return Channels(self, (), _axes(spec["slstm"]["ffn"]["w_gate"][1]),
                        self._gate_axes(spec))

    def mixer_in(self, i, h):
        """Layer ``i``'s mixer input from this rank's rows ``h``: a
        recurrent layer whose channels split over batch axes takes their
        rows too."""
        g = self._batch_axes_of(self.chan[i])
        return self.cat(h, g) if g else h

    def mixer_out(self, i, out):
        """Layer ``i``'s mixer output on this rank's rows from its partial
        ``out``: summed over the heads (attention, MLA) or the channel
        axes (Mamba, mLSTM), the rank's rows taken back."""
        if self.kinds[i] in ("attn", "mla"):
            return self.heads_sum(out)
        c = self.chan[i]
        return self.reduce(out, c, self._batch_axes_of(c))

    def state_rows(self, i) -> int:
        """The batch rows of layer ``i``'s recurrent state on this rank."""
        return self.batch * self._size(self._batch_axes_of(self.chan[i]))

    def head(self, x, params):
        """(``x``, this rank's rows, gathered over the batch axes among
        :attr:`v_axes`; the head ``[d, V block]`` of the rank's
        vocabulary)."""
        v = self.v_axes
        if self.cfg.tie_embeddings:
            spec = self.specs["embed"]
            head = self.use(params["embed"], spec, (v, ())).T
        else:
            spec = self.specs["lm_head"]
            head = self.use(params["lm_head"], spec, ((), v))
        g = self._batch_axes_of(v)
        return (self.cat(x, g) if g else x), head

    def label_logprobs(self, logits, labels):
        """The log-probabilities of ``labels`` (this rank's rows) from
        this rank's block of the logits (:meth:`head`'s rows and
        vocabulary), on this rank's rows: the log-sum-exp and the label's
        logit summed over the vocabulary's axes, each rank's block's
        max shifting its terms (the max over the blocks, held
        constant), so that no rank gathers the logits."""
        from ..launch.mesh import cat
        v = self.v_axes
        g = self._batch_axes_of(v)
        if g:
            labels = self.cat(labels, g)
        idx, _ = _index(self.mesh, v)
        vb = logits.shape[-1]
        with torch.no_grad():
            m = cat(logits.amax(-1)[None], self.mesh, v).amax(0)
        se = self.sum(torch.exp(logits - m[..., None]).sum(-1), v)
        local = labels.long() - idx * vb
        inside = (local >= 0) & (local < vb)
        picked = logits.gather(-1, local.clamp(0, vb - 1)[..., None])[..., 0]
        picked = self.sum(torch.where(inside, picked, torch.zeros(
            (), dtype=picked.dtype, device=picked.device)), v)
        ll = picked - (m + torch.log(se))
        return self.rows(ll, g) if g else ll

    def logits(self, out):
        """The whole batch's logits ``[B, S, V]`` from this rank's block
        of them (of :meth:`head`'s rows and vocabulary)."""
        out = self.cat(out, self.v_axes, dim=2)
        rest = tuple(a for a in self.b_axes
                     if a not in self._batch_axes_of(self.v_axes))
        return self.cat(out, rest) if rest else out

    @property
    def batch(self) -> int:
        """The number of batch rows this rank holds."""
        return self.B // self._size(self.b_axes)

    def local_heads(self, n):
        """The number of heads of ``n`` this rank runs."""
        return n // self.tp_n

    # -- a slot-split KV cache ------------------------------------------
    @property
    def model_ranks(self) -> int:
        """The size of the ``model`` axis."""
        return self.sctx.axis_size(self.sctx.tp)

    def latent_block(self, L) -> Tuple[int, int]:
        """(first slot, slots) of this rank's block of a cache of ``L``
        slots split by slots over ``model``, as the reference's ``tp_if``
        places it: slots ``[r L / N, (r + 1) L / N)`` (``r`` the rank's
        ``model`` coordinate, ``N`` the axis's size) where ``N`` > 1
        divides ``L``, else ``(0, L)``.  An MLA layer's ``latent`` and
        ``krope`` (which have no head axis) split so."""
        n = self.model_ranks
        if n == 1 or L % n:
            return 0, L
        return _index(self.mesh, (self.sctx.tp,))[0] * (L // n), L // n

    def kv_block(self, L) -> Tuple[int, int]:
        """(first slot, slots) of this rank's block of an attention layer's
        KV cache of ``L`` slots: where the KV heads do not divide
        ``model``, :meth:`latent_block`'s; otherwise ``(0, L)``, every
        slot (the heads split)."""
        if _div(self.cfg.n_kv_heads, self.model_ranks):
            return 0, L
        return self.latent_block(L)

    def cache_block(self, kind, L) -> Tuple[int, int]:
        """(first slot, slots) of this rank's block of a ``kind`` layer's
        cache of ``L`` slots (``"attn"``: :meth:`kv_block`, ``"mla"``:
        :meth:`latent_block`)."""
        return self.kv_block(L) if kind == "attn" else self.latent_block(L)

    @property
    def slot_heads(self) -> tuple:
        """The axes a decode step over a slot-split KV cache splits its
        query heads and output projection over: ``model`` where the query
        heads divide it (``wq``, ``bq`` and ``wo`` used as the rank holds
        them, no weight gathered), else none (all of them whole)."""
        return (self.sctx.tp,) if _div(self.cfg.n_heads,
                                       self.model_ranks) else ()

    def slot_q(self, q, heads=None):
        """Every head's query ``[B, H, D]`` from this rank's: its block of
        the heads where ``heads`` (default :attr:`slot_heads`; an MLA
        layer's :attr:`heads`) splits them, one all-gather."""
        heads = self.slot_heads if heads is None else heads
        return self.cat(q, heads, dim=1) if heads else q

    def slot_exchange(self, part, ml=None):
        """The exchange of a slot-split attention's per-head partials:
        ``part`` ``[B, Hp, ...]`` (this rank's block's, ``Hp`` a multiple
        of the model ranks) -> this rank's heads' partials from every
        model rank, ``[N, B, Hp / N, ...]`` in rank order (one
        ``all_to_all``); with ``ml`` (``[B, H, 2]``, every head's
        ``(m, l)`` of the rank's block) also every rank's, ``[N, B, H,
        2]`` (one all-gather), else None."""
        from ..launch.mesh import all_to_all, gather
        tp = self.sctx.tp
        parts = all_to_all(part, self.mesh, tp, dim=1)
        if ml is not None:
            ml = torch.stack(gather(ml.contiguous(), self.mesh, tp))
        return parts, ml

    def slot_mass(self, mass):
        """The whole rows' mass ``[B, L]`` from each model rank's block of
        it, in rank order (None stays None)."""
        return None if mass is None else self.cat(mass, (self.sctx.tp,),
                                                  dim=1)

    def slot_rows(self, w, n, heads=None, dim=0):
        """The rows along ``dim`` of ``w`` (a per-head weight) of this
        rank's ``n`` heads of the heads padded to a multiple of the model
        ranks: ``w`` as the rank holds it where ``heads`` (default
        :attr:`slot_heads`) splits the heads, else cut from the whole,
        the padded heads dropped."""
        heads = self.slot_heads if heads is None else heads
        if heads:
            return w
        a = _index(self.mesh, (self.sctx.tp,))[0] * n
        return w[(slice(None),) * dim + (slice(a, a + n),)]

    def slot_out(self, o, wo, heads=None):
        """A slot-split attention's output ``[B, d]``, the same on every
        model rank: this rank's merged heads ``o`` ``[B, Hp / N, Dv]``
        (its block of the heads padded to a multiple of the ranks) times
        their rows of ``wo`` (:meth:`slot_rows`), summed over ``model`` in
        rank order."""
        wo = self.slot_rows(wo, o.shape[1], heads)
        o = o[:, :wo.shape[0]]
        return self.sum(torch.einsum("bhk,hkd->bd", o, wo),
                        (self.sctx.tp,))


class Channels:
    """A recurrent layer's split under a :class:`Local`: its channels
    (mLSTM: whole heads) over ``axes``, on the rows :meth:`Local.mixer_in`
    gives it; sLSTM's FFN width over ``ff`` and its gate columns over
    ``gates``.  The layer code calls these where it mixes channels."""

    def __init__(self, loc: Local, axes, ff=(), gates=()):
        self.loc, self.axes = loc, tuple(axes)
        self.ff, self.gates = tuple(ff), tuple(gates)

    @property
    def ways(self) -> int:
        """The number of blocks the channels split into."""
        return self.loc._size(self.axes)

    def gather(self, x, parts=1):
        """Every channel of ``x`` (the last dimension, of ``parts``
        components) from the blocks."""
        return (self.loc.cat(x, self.axes, -1, parts) if self.axes else x)

    def block(self, x):
        """This rank's block of the channels (the last dimension)."""
        return _block(x, -1, self.loc.mesh, self.axes)

    def sum(self, x):
        """A contraction over every channel from each block's part."""
        return self.loc.sum(x, self.axes)

    def mlp(self, x, fn):
        """The FFN ``fn`` on this rank's width (see :meth:`Local.mlp`)."""
        return self.loc.mlp(self.ff, x, fn)

    def project(self, x, fn):
        """``fn`` (a projection onto this rank's block of each of the
        four gates' columns) of the rows ``x``: the rows gathered over
        the batch axes among :attr:`gates`, every column gathered, the
        rank's rows taken back."""
        loc = self.loc
        g = loc._batch_axes_of(self.gates)
        y = fn(loc.cat(x, g) if g else x)
        y = loc.cat(y, self.gates, -1, 4) if self.gates else y
        return loc.rows(y, g) if g else y
