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
data``; attention heads over ``model`` (kernels B2 and B3 run on each
rank's local heads, the output projection summed over ``model``); the
MLP's width and the vocabulary over the axes their placement names (the
activations gathered over the batch axes among them, the partial outputs
summed, the logits concatenated); any other split dimension, such as
FSDP's, gathered before use.  Sums over ranks add in a fixed order, so
every rank of an axis holds the same values bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

__all__ = ["ShardCtx", "AbstractMesh", "mesh_shape", "param_specs",
           "serve_state_shardings", "shard_tree", "Local"]


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

    The sharded serve path keeps the control rows whole on every model
    rank instead (they are tiny, and DAC's control must agree across the
    model ranks that attend over one pool), and a cache whose KV heads do
    not divide the model axis whole on every model rank."""
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


def _block(x, dim, mesh, axes):
    """This rank's block of ``x`` along ``dim`` split over ``axes``."""
    idx, n = _index(mesh, axes)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axes} ({n} ranks)")
    return x.narrow(dim, idx * (size // n), size // n)


def shard_tree(tree, specs, mesh):
    """This rank's blocks of the full tensors of ``tree`` under
    ``specs`` (a tree of placements of the same structure), as new
    contiguous tensors."""
    def leaf(keys, x, spec):
        for dim, entry in enumerate(spec):
            x = _block(x, dim, mesh, _axes(entry))
        return x.contiguous()

    def walk(t, s, keys=()):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], keys + (k,)) for k in t}
        if isinstance(t, list):
            return [walk(a, b, keys) for a, b in zip(t, s)]
        return leaf(keys, t, s)

    return walk(tree, specs)


class Local:
    """One rank's view of a :class:`ShardCtx` for a batch of ``B``
    sequences: where its blocks lie and the collectives around the layers'
    compute, which runs unchanged on the rank's weights (``.model``'s
    ``forward`` and ``serving.serve_step``).  ``specs`` are the placements
    of the parameters (``param_specs`` of the full shapes), which this rank
    holds its blocks of.

    The batch splits over the ctx's batch axes when ``B`` divides their
    product, as the reference places it; otherwise every rank holds the
    whole batch.  Attention heads split over ``model`` when both the query
    and the KV heads divide it; otherwise every model rank runs all
    heads.  The MLP's width and the vocabulary split over the axes their
    placements name."""

    def __init__(self, sctx: ShardCtx, cfg, B: int, specs):
        from ..launch.mesh import check_mesh
        self.sctx, self.cfg, self.B, self.specs = sctx, cfg, int(B), specs
        self.mesh = check_mesh(sctx.mesh)
        self.b_axes = sctx.batch_axes if B % sctx._bsz() == 0 else ()
        tp_n = sctx.axis_size(sctx.tp)
        self.heads = ((sctx.tp,) if _div(cfg.n_heads, tp_n)
                      and _div(cfg.n_kv_heads, tp_n) else ())
        self.tp_n = tp_n if self.heads else 1
        self.v_axes = _axes(specs["embed"][0] if cfg.tie_embeddings
                            else specs["lm_head"][1])
        self.ff_axes = [_axes(s["mlp"]["w_gate"][1]) if "mlp" in s else ()
                        for s in specs["layers"]]

    # -- the batch ------------------------------------------------------
    def rows(self, x, axes=None):
        """This rank's batch rows (dim 0) of a full-batch tensor."""
        return _block(x, 0, self.mesh, self.b_axes if axes is None else axes)

    def cat(self, x, axes, dim=0):
        from ..launch.mesh import cat
        return cat(x, self.mesh, axes, dim)

    def sum(self, x, axes):
        from ..launch.mesh import seq_sum
        return seq_sum(x, self.mesh, axes) if axes else x

    def _batch_axes_of(self, axes):
        return tuple(a for a in axes if a in self.b_axes)

    # -- weights ----------------------------------------------------------
    def use(self, w, spec, want):
        """``w`` (this rank's block under ``spec``) laid out as the
        compute wants it: ``want[d]`` the axes dimension ``d`` is split
        over in the compute.  A split the compute does not keep is
        gathered; a whole dimension the compute splits is cut."""
        for dim, (entry, keep) in enumerate(zip(spec, want)):
            have = _axes(entry)
            if have == tuple(keep):
                continue
            if have:
                w = self.cat(w, have, dim)
            if keep:
                w = _block(w, dim, self.mesh, tuple(keep))
        return w

    def _heads_of(self, w, spec, dim):
        want = [()] * w.dim()
        want[dim] = self.heads
        return self.use(w, spec, want)

    def layer(self, i, p):
        """Layer ``i``'s weights ``p`` (this rank's blocks) as its compute
        takes them: the attention's heads split as :attr:`heads` says,
        the MLP's width over :attr:`ff_axes`, every other dimension
        whole (an FSDP split gathered)."""
        spec, p = self.specs["layers"][i], dict(p)
        head_dim = {"wq": 1, "wk": 1, "wv": 1, "wo": 0,
                    "bq": 0, "bk": 0, "bv": 0}
        p["attn"] = {k: self._heads_of(w, spec["attn"][k], head_dim[k])
                     for k, w in p["attn"].items()}
        if "mlp" in p:
            f = self.ff_axes[i]
            want = {"w_gate": ((), f), "w_up": ((), f), "w_down": (f, ())}
            p["mlp"] = {k: self.use(w, spec["mlp"][k], want[k])
                        for k, w in p["mlp"].items()}
        return p

    # -- around the layers --------------------------------------------------
    def embed(self, table, tokens):
        """Embedding rows of this rank's batch: the vocabulary split over
        :attr:`v_axes`' placement in the table, each rank looking up the
        tokens in its block and the blocks summed (one nonzero row
        each)."""
        spec = self.specs["embed"]
        v_axes = _axes(spec[0])
        table = self.use(table, spec, (v_axes, ()))
        g = self._batch_axes_of(v_axes)
        tok = self.rows(tokens, tuple(a for a in self.b_axes if a not in g))
        idx, n = _index(self.mesh, v_axes)
        rows = table.shape[0]
        local = tok.long() - idx * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        x = self.sum(x, v_axes)
        return self.rows(x, g) if g else x

    def heads_sum(self, x):
        """A sum over the attention heads of each model rank's partial
        ``x`` (the output projection, B3's per-slot mass), added in
        model-rank order: the same on every model rank."""
        return self.sum(x, self.heads)

    def mlp(self, i, x, fn):
        """``fn`` (layer ``i``'s MLP on this rank's width) on this rank's
        rows ``x``, gathered over the batch axes among :attr:`ff_axes`;
        the partial outputs summed over the width's axes, and the rank's
        rows taken back."""
        f = self.ff_axes[i]
        g = self._batch_axes_of(f)
        out = self.sum(fn(self.cat(x, g) if g else x), f)
        return self.rows(out, g) if g else out

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
        return self.B // math.prod(self.sctx.axis_size(a)
                                   for a in self.b_axes)

    def local_heads(self, n):
        """The number of heads of ``n`` this rank runs."""
        return n // self.tp_n


def check_dense(cfg, what):
    """Sharded serving covers the dense-attention configurations; MoE,
    MLA and the recurrent layers raise."""
    kinds = {s.kind for s in cfg.period}
    if kinds != {"attn"} or (cfg.moe is not None
                             and any(s.moe for s in cfg.period)):
        raise NotImplementedError(
            f"{what} under a ShardCtx: sharded serving of MoE, MLA and "
            f"recurrent layers is not ported yet (ROADMAP A13.2); "
            f"{cfg.name} has {sorted(kinds)}"
            f"{' with MoE' if cfg.moe is not None else ''} layers")
