"""Roofline terms of one step of the port on an H100 (port of
``launch/roofline.py``).

The reference parses XLA's compiled, partitioned HLO; eager torch has no
such program, so :class:`StepCounter` watches one real step of one rank
instead (a ``TorchDispatchMode``; on fake tensors nothing is allocated)
and counts:

  * flops            -- matrix products, by ``torch.utils.flop_counter``'s
                        formulas (``mm``, ``bmm``, ...), split by operand
                        dtype: bf16/f16 at the tensor-core rate, anything
                        else at the f32 rate (TF32 is off in the port);
  * hbm bytes        -- operand + result bytes of every aten op, views
                        0: eager torch fuses nothing, so every op is one
                        kernel that reads its operands and writes its
                        result (the counterpart of the reference's
                        top-level instructions).  A scatter into a buffer
                        (``index_put_``, ``copy_`` into a view) and a
                        gather from one (``index``, ``embedding``) move
                        their window, not the buffer;
  * collective bytes -- every collective of ``launch.mesh`` (``gather``,
                        ``seq_sum``'s gather, ``reduce_scatter``,
                        ``all_to_all``), seen through
                        ``mesh.COLLECTIVE_HOOK``, with the reference's
                        ring wire factors:
                          all-gather      (N-1)/N * result
                          all-reduce    2*(N-1)/N * result
                          reduce-scatter  (N-1)/N * operand
                          all-to-all      (N-1)/N * operand
                        N the group's size.  A group within one node of
                        ``NODE_RANKS`` ranks moves at the NVLink rate,
                        any other at the network's.

Every call counts: a Python loop over layers, chunks or microbatches runs
its ops once each, so there are no trip counts to recover.  Ops issued
inside the plain attention that a kernel replaces on the card
(``kernels.flash_attention.attention_dense`` for B2,
``kernels.decode_attention.decode_attention_plain`` for B3, and B3's
``decode_attention_partial_plain`` and ``decode_attention_merge_plain``
on a slot-split cache) and inside
the attention of MLA's absorbed decode (``models.mla.absorbed_attention``,
the reference's ``decode_attention_jnp`` scope, which it credits as a
kernel too; not the projections around it) are tagged attention-inner, in the backward pass
as well (the autograd node that the forward op made carries its tag:
nodes are numbered as autograd makes them, just before it dispatches the
op to the counter).

Hardware constants: one H100 SXM5 (80 GB HBM3, 700 W), each with its
source beside it.  Everything is per rank.
"""
from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HBM_BW", "PEAK_FLOPS", "F32_FLOPS", "SMS", "INT32_OPS_PER_S",
           "NVLINK_BW", "NET_BW", "NODE_RANKS", "StepCounter",
           "dominant_term", "policy_step_traffic_bytes",
           "policy_step_targets", "bound", "flash_bound", "decode_bound",
           "partial_bound", "merge_bound"]

HBM_BW = 3.35e12         # B/s, HBM3 (H100 SXM data sheet)
PEAK_FLOPS = 989e12      # FLOP/s, dense bf16 tensor cores (data sheet)
F32_FLOPS = 67e12        # FLOP/s, f32 outside the tensor cores (data sheet)
SMS = 132                # streaming multiprocessors (data sheet)
# int32 ALU rate: 64 INT32 lanes per SM (Hopper architecture whitepaper)
# x 132 SMs x 1.98 GHz boost clock (H100 SXM data sheet)
INT32_OPS_PER_S = 64 * SMS * 1.98e9
NVLINK_BW = 450e9        # B/s each way a GPU, NVLink 4, 18 links (data sheet)
NET_BW = 50e9            # B/s a rank between nodes: 400 Gb/s NDR InfiniBand,
#                          one ConnectX-7 a GPU (DGX H100 user guide)
NODE_RANKS = 8           # GPUs a node joined by NVLink (HGX H100 8-GPU)

_TENSOR_CORE = (torch.bfloat16, torch.float16)
_aten = torch.ops.aten
# ops that move no bytes of their own: allocation, metadata, host reads
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default, _aten._local_scalar_dense.default,
         _aten.detach.default, _aten.alias.default}
# writes of a window into a buffer: read and write the window (the values)
_SCATTER = {_aten.index_put_.default, _aten._index_put_impl_.default,
            _aten.index_copy_.default, _aten.scatter_.src,
            _aten.scatter_.value, _aten.scatter_reduce_.two,
            _aten.index_add_.default, _aten.scatter_add_.default}
# reads of a window of a buffer: read the window, write it (the result)
_GATHER = {_aten.index.Tensor, _aten.index_select.default,
           _aten.gather.default, _aten.embedding.default}
# writes that read nothing but their source
_WRITE = {_aten.copy_.default: 1, _aten.fill_.Scalar: 0, _aten.fill_.Tensor: 0,
          _aten.zero_.default: 0}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _attention_codes():
    from ..kernels import decode_attention as da
    from ..kernels.flash_attention import attention_dense
    from ..models.mla import absorbed_attention
    return {f.__code__ for f in (
        attention_dense, da.decode_attention_plain,
        da.decode_attention_partial_plain, da.decode_attention_merge_plain,
        absorbed_attention)}


class StepCounter(TorchDispatchMode):
    """Counts one step's flops, HBM bytes and collective wire bytes (see
    the module's docstring), and the peak of the bytes its ops allocate
    and hold at once (storages of ops' fresh results, until they die).

    ``attribute``: also keep, for :mod:`.profile`, each op's bytes under
    the innermost ``repro_torch`` function that issued it (in the
    backward pass, the function whose forward op made the autograd node
    that runs it).

    >>> x = torch.ones(64, 32)
    >>> with StepCounter() as c:
    ...     y = (x @ x.T).sum()
    >>> c.result()["flops"]                  # 2 * 64 * 64 * 32
    262144.0
    """

    def __init__(self, attribute: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry
        self._attn_codes = _attention_codes()
        self.attribute = attribute
        self.flops = defaultdict(float)          # by "tensor_core" / "f32"
        self.hbm = 0.0
        self.hbm_by_op = defaultdict(float)
        self.hbm_attention_inner = 0.0
        self.coll = defaultdict(float)           # wire bytes by kind
        self.counts = defaultdict(float)
        self.wire_by_link = defaultdict(float)   # "nvlink" / "network"
        self.sum_bytes = 0.0                     # seq_sum's wire bytes
        self.sum_ring_bytes = 0.0                # a ring all-reduce's
        self.rows = defaultdict(lambda: [0.0, 0])   # (kind, op, fn) -> b, n
        self._live = {}                          # storage -> (ref, bytes)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._nodes = {}                         # autograd node -> tag
        self._hook_before = None

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        from . import mesh
        self._hook_before = mesh.COLLECTIVE_HOOK
        mesh.COLLECTIVE_HOOK = self._collective
        return super().__enter__()

    def __exit__(self, *exc):
        from . import mesh
        mesh.COLLECTIVE_HOOK = self._hook_before
        return super().__exit__(*exc)

    def _where(self, skip=("repro_torch.launch.roofline",)):
        """(attention-inner?, the issuing function's name) of the op now
        dispatched, from the Python stack (the innermost ``repro_torch``
        frame outside the modules ``skip``), or in the backward pass from
        the tag of the autograd node that runs it."""
        attn, fn = False, None
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            if code in self._attn_codes:
                attn = True
            if fn is None and self.attribute:
                mod = f.f_globals.get("__name__", "")
                if mod.startswith("repro_torch.") and mod not in skip:
                    fn = f"{mod[len('repro_torch.'):]}.{code.co_qualname}"
            f = f.f_back
        node = torch._C._current_autograd_node()
        if node is not None:                    # the backward pass
            f_attn, f_fn = self._nodes.get(node._sequence_nr(),
                                           (False, None))
            attn = attn or f_attn
            if self.attribute:
                fn = f"grad of {f_fn or node.name()}"
        return attn, fn

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.namespace == "prim":
            return out                  # no bytes, no storage of its own
        if func.namespace != "aten" or func in _FREE:
            self._track(func, out)
            return out
        ins = tree_leaves((args, kwargs))
        outs = tree_leaves(out)
        if func in _SCATTER:
            vals = args[2] if func in (_aten.index_put_.default,
                                       _aten._index_put_impl_.default) \
                else args[-1]
            idx = [t for t in tree_leaves(args[1:-1])
                   if isinstance(t, torch.Tensor)]
            moved = 2 * _nbytes(vals) + sum(map(_nbytes, idx))
        elif func in _GATHER:
            idx = [t for t in ins[1:] if isinstance(t, torch.Tensor)]
            moved = 2 * sum(map(_nbytes, outs)) + sum(map(_nbytes, idx))
        elif func in _WRITE:
            moved = _nbytes(args[0]) + (_nbytes(args[1]) if _WRITE[func]
                                        else 0)
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        packet = func.overloadpacket
        if packet in self._flop_fns:
            first = next(t for t in ins if isinstance(t, torch.Tensor))
            kind = "tensor_core" if first.dtype in _TENSOR_CORE else "f32"
            self.flops[kind] += float(self._flop_fns[packet](
                *args, **kwargs, out_val=out))
        attn, fn = self._where()
        self.hbm += moved
        name = packet.__name__
        self.hbm_by_op[name] += moved
        if attn:
            self.hbm_attention_inner += moved
        if (attn or self.attribute) and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in ins):
            # the op's autograd node was made (and numbered) just before
            # autograd dispatched the op here: its backward reads the tag
            self._nodes[torch._C._autograd._get_sequence_nr() - 1] = (attn,
                                                                      fn)
        if self.attribute:
            row = self.rows[("hbm", name, fn or "<torch>")]
            row[0] += moved
            row[1] += 1
        self._track(func, out)
        return out

    # -- live bytes ---------------------------------------------------------
    def _track(self, func, out):
        """Count the fresh storages of ``out`` (results that alias no
        input); set the peak after dropping the storages that died."""
        rets = func._schema.returns
        for i, t in enumerate(out if isinstance(out, (tuple, list))
                              else (out,)):
            if not isinstance(t, torch.Tensor) or \
                    (i < len(rets) and rets[i].alias_info is not None):
                continue
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref.cdata not in self._live:
                n = st.nbytes()
                self._live[ref.cdata] = (ref, n)
                self.live_bytes += n
        if self.live_bytes > self.peak_live_bytes:
            for key in [k for k, (r, _) in self._live.items() if r.expired()]:
                self.live_bytes -= self._live.pop(key)[1]
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    # -- collectives ---------------------------------------------------------
    def _collective(self, kind, x, ranks):
        n, xb = len(ranks), float(_nbytes(x))
        ring = (n - 1) / max(n, 1)
        if kind == "reduce-scatter":
            wire, moved = ring * xb, xb + xb / n
        elif kind == "all-to-all":
            wire, moved = ring * xb, 2 * xb
        else:                              # an all-gather (a sum's too)
            wire, moved = ring * n * xb, xb + n * xb
        if kind == "sum":
            self.sum_bytes += wire
            self.sum_ring_bytes += 2 * ring * xb
        key = "all-gather" if kind == "sum" else kind
        self.coll[key] += wire
        self.counts[key] += 1
        node = {r // NODE_RANKS for r in ranks}
        self.wire_by_link["nvlink" if len(node) == 1 else "network"] += wire
        self.hbm += moved
        self.hbm_by_op[key] += moved
        if self.attribute:
            _, fn = self._where(("repro_torch.launch.roofline",
                                 "repro_torch.launch.mesh"))
            row = self.rows[("coll", key if kind != "sum" else "sum",
                             fn or "<torch>")]
            row[0] += wire
            row[1] += 1

    # -- the result ------------------------------------------------------------
    def result(self) -> dict:
        """The reference's ``analyze_hlo`` keys (``flops``, ``hbm_bytes``,
        ``collective_bytes``, ``collective_counts``, ``hbm_by_op``,
        ``hbm_attention_inner``, ``wire_bytes``, ``terms``), plus the
        flops by rate, the wire bytes by link, ``seq_sum``'s wire bytes
        beside a ring all-reduce's, and the peak of live bytes."""
        tc, f32 = self.flops.get("tensor_core", 0.0), self.flops.get("f32", 0.0)
        link = self.wire_by_link
        wire = sum(self.coll.values())
        return {
            "flops": tc + f32,
            "hbm_bytes": self.hbm,
            "collective_bytes": dict(self.coll),
            "collective_counts": dict(self.counts),
            "hbm_by_op": dict(self.hbm_by_op),
            "hbm_attention_inner": self.hbm_attention_inner,
            "wire_bytes": wire,
            "terms": {
                "compute_s": tc / PEAK_FLOPS + f32 / F32_FLOPS,
                "memory_s": self.hbm / HBM_BW,
                "collective_s": link.get("nvlink", 0.0) / NVLINK_BW
                + link.get("network", 0.0) / NET_BW,
            },
            "flops_by_rate": dict(self.flops),
            "wire_by_link": dict(self.wire_by_link),
            "sum_wire_bytes": self.sum_bytes,
            "sum_ring_allreduce_bytes": self.sum_ring_bytes,
            "peak_live_bytes": self.peak_live_bytes,
        }


def dominant_term(terms: dict) -> str:
    """The largest of the three roofline terms.

    >>> dominant_term({"compute_s": 1.0, "memory_s": 2.0,
    ...                "collective_s": 0.5})
    'memory_s'
    """
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


# ---------------------------------------------------------------------------
# policy-step roofline
# ---------------------------------------------------------------------------

# int32 rank-row element
_ROW_BYTES = 4


def policy_step_traffic_bytes(W: int) -> int:
    """Modelled HBM bytes a fused policy step at padded row width ``W``
    (the reference's law): two passes over the row (find, promote), each
    reading and writing it, ``4 * W * 4`` bytes; the scalar I/O is O(1)
    and ignored.

    >>> policy_step_traffic_bytes(128)
    2048
    """
    return 4 * W * _ROW_BYTES


def policy_step_targets(widths) -> dict:
    """Memory-bound roofline target of the fused policy step, in Mops
    (million requests/s) a padded width, at this card's HBM rate::

        steps/s <= HBM_BW / policy_step_traffic_bytes(W)

    >>> t = policy_step_targets([1024])
    >>> round(t[1024], 1)                    # 3.35e12 / 16384 / 1e6
    204.5
    """
    return {int(W): HBM_BW / policy_step_traffic_bytes(int(W)) / 1e6
            for W in widths}


# ---------------------------------------------------------------------------
# the kernels' bounds (chip_smoke.py prints them beside each kernel's time)
# ---------------------------------------------------------------------------

def bound(out, B, T, W, n_sc, ops):
    """Least time (ms) on an H100 for a replay: the bytes it must move
    (requests read once, rows and scalars read and written once, totals and
    the per-step outputs of its mode written once) over the memory rate,
    against ``ops`` (``chip_smoke.live_ops``) over the int32 ALU rate of
    the whole card.  Also the operations' time on the ``min(B, 132)`` SMs
    that one block or warp per lane can occupy."""
    bytes_ = 12 * B * T + 8 * B * W + 8 * B * n_sc + B * (16 + 16 + 24)
    if out.hit is not None:
        bytes_ += 5 * B * T
    if out.obs is not None:
        bytes_ += 4 * B * T * n_sc
    t_bytes, t_ops = bytes_ / HBM_BW, ops / INT32_OPS_PER_S
    sms = min(B, SMS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"sms": sms, "ops_on_used_sms_ms": t_ops * SMS / sms * 1e3})


def flash_bound(B, S, H, Hkv, D, Dv, dtype, window=None):
    """Least time (ms) of causal attention on an H100: 2 (D + Dv) flops per
    (q, k) pair the masks keep, at the tensor-core bf16 rate (the f32 rate
    for f32), against q, k, v, o read or written once.

    >>> ms, by, flops = flash_bound(8, 2048, 32, 32, 128, 128,
    ...                             torch.bfloat16)
    >>> round(ms, 3), by
    (0.278, 'operations')
    """
    qpos = torch.arange(S, dtype=torch.float64)
    keep = qpos + 1 if not window else torch.clamp(qpos + 1, max=window)
    pairs = float(keep.sum()) * B * H
    flops = 2 * (D + Dv) * pairs
    size = 2 if dtype == torch.bfloat16 else 4
    bytes_ = size * B * S * (H * D + Hkv * D + Hkv * Dv + H * Dv)
    rate = PEAK_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_ops, t_bytes = flops / rate, bytes_ / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def decode_bound(q, k, v, valid):
    """Least time (ms) of one decode-attention call on an H100: K and V of
    the slots this ``valid`` keeps (all of them in a row with none), q and
    ``valid`` read once, o and mass written once, over the memory rate."""
    B, S = valid.shape
    live = valid.sum(1)
    slots = int(live.where(live > 0, S).sum())
    row = (k.shape[2] * k.shape[3] + v.shape[2] * v.shape[3]) * \
        k.element_size()
    bytes_ = (slots * row + q.numel() * q.element_size() + B * S
              + q.numel() // q.shape[2] * v.shape[3] * q.element_size()
              + 4 * B * S)
    return bytes_ / HBM_BW * 1e3, "bytes"


def partial_bound(q, k_blk, v_blk, valid, s0):
    """Least time (ms) of B3's partial over one block of a slot table
    (``kernels.decode_attention.decode_attention_partial``) on an H100: K
    and V of the block's valid slots (every slot of a row with none in the
    whole row), q and the whole rows' ``valid`` read once, each head's
    ``(acc, m, l)`` and the block's raw scores written once, over the
    memory rate."""
    B, S = valid.shape
    H, Sb, Dv = q.shape[1], k_blk.shape[1], v_blk.shape[3]
    blk = valid[:, s0:s0 + Sb]
    slots = int(torch.where(valid.any(1), blk.sum(1), Sb).sum())
    row = (k_blk.shape[2] * k_blk.shape[3] + v_blk.shape[2] * Dv) * \
        k_blk.element_size()
    bytes_ = (slots * row + q.numel() * q.element_size() + B * S
              + 4 * B * H * (Dv + 2) + 4 * B * H * Sb)
    return bytes_ / HBM_BW * 1e3, "bytes"


def merge_bound(parts, ml, scores, o_dtype):
    """Least time (ms) of B3's merge (``decode_attention_merge``) on an
    H100: the blocks' partials of its heads, every head's ``(m, l)`` and
    one block's scores read once (the last two where the mass is asked
    for), its heads' ``o`` and the block's mass written once, over the
    memory rate."""
    N, B, Hn, P = parts.shape
    bytes_ = 4 * parts.numel() + B * Hn * (P - 2) * o_dtype.itemsize
    if scores is not None:
        bytes_ += 4 * (ml.numel() + scores.numel() + B * scores.shape[2])
    return bytes_ / HBM_BW * 1e3, "bytes"
