"""Flash decode with the fused per-slot attention mass: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``decode_attention_pallas``: ``_stats_kernel``, ``pallas_call`` at :136,
and ``_out_kernel`` at :161; wrapper ``kernels/ops.py:38``).  Its oracle,
``models/layers.py::decode_attention``, is what the reference's serve step
calls on every decode step (``serving/serve_step.py:177``, ``:192``); the
port's serve step calls :func:`decode_attention` there.  The kernel is
hand-written CUDA C++ for ``sm_90a`` in ``csrc/decode_attention.cu`` (its
header gives the design and the bound), built by :mod:`._build` and
called through ``ctypes``.

Besides the output, the call returns the per-slot mass, the mean over the
H query heads of the softmax weights: the hit signal whose argmax the
bounded KV pool promotes.  The kernel splits the slot axis across blocks
(:func:`chunk_len` picks the chunk) and combines the splits in a fixed
order, so ``o`` and the mass are the same bit for bit from run to run.

:func:`decode_attention_plain` is the plain version (the reference's jnp
function in torch).  :func:`decode_attention` runs it on CPU tensors; on
a CUDA tensor it launches the kernel or raises.

A slot table split over ranks (``models.sharding.Local``: the slots of a
KV cache whose heads do not divide ``model``, as the reference places
it) runs B3 in two parts, the GSPMD program's cross-slot softmax made
explicit.  :func:`decode_attention_partial` runs the split kernel over
one rank's block of slots for every head, with the whole row's ``valid``
(a row with no valid slot averages over all its slots; a block with none
in a row that has some gives ``m = -1e30``, ``l = 0``), and folds the
block's splits into one ``(acc, m, l)`` a head; it also leaves the
block's raw scores.  :func:`decode_attention_merge` folds the blocks'
partials of a head in block order into ``o`` and, given every head's
``(m, l)`` from every block, writes the mass of one block's slots: the
combine kernel with a rank axis in place of the split axis.  Each has a
plain version beside it (``*_plain``), which the wrappers run on CPU
tensors.

``LAUNCHES`` counts calls that launched the kernel (one call launches the
split kernel and the combine after it): :func:`decode_attention` adds one
where it launches, and nowhere else; likewise ``PARTIAL_LAUNCHES``
(:func:`decode_attention_partial`: the split kernel and the fold) and
``MERGE_LAUNCHES`` (:func:`decode_attention_merge`).

The kernel has no backward, so :func:`decode_attention` raises, on every
device, when autograd is recording and an input requires grad
(``flash_attention.no_grad_guard``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .flash_attention import NEG_INF, _softcap, no_grad_guard

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_partial", "decode_attention_partial_plain",
           "decode_attention_merge", "decode_attention_merge_plain",
           "pad_heads", "chunk_len", "blocks_per_call", "LAUNCHES",
           "PARTIAL_LAUNCHES", "MERGE_LAUNCHES"]

LAUNCHES = 0
PARTIAL_LAUNCHES = 0
MERGE_LAUNCHES = 0
WARP_TILE = 8          # the kernel takes chunks that are a multiple of it
CHUNK = 256            # slots per split block, where blocks are enough
MIN_CHUNK = 32         # the chunk rule halves no further
MIN_BLOCKS = 2 * 132   # two blocks on each of an H100's 132 SMs

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_fwd.argtypes = [_P] * 8 + [_I] * 8 + [_F, _F, _P]
    lib.decode_attention_fwd.restype = _I
    lib.decode_attention_grid.argtypes = [_I] * 7 + [_P]
    lib.decode_attention_grid.restype = _I
    lib.decode_attention_partial.argtypes = [_P] * 7 + [_I] * 10 + \
        [_F, _F, _P]
    lib.decode_attention_partial.restype = _I
    lib.decode_attention_merge.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    lib.decode_attention_merge.restype = _I
    return lib


def _cdiv(a, b):
    return -(-a // b)


def chunk_len(B, Hkv, S):
    """Slots per split block: ``CHUNK``, halved (down to ``MIN_CHUNK``)
    while the ``B * Hkv`` (batch row, kv head) pairs would give fewer than
    ``MIN_BLOCKS`` blocks, and no longer than S rounded up to
    ``WARP_TILE``.  (On an H100, ``decode_sweep.py``: 256 slots ran best
    or within 1% of the best where they gave 384 blocks or more, and
    25-32% slower than 64 where they gave 128; PERF.md.)"""
    c = CHUNK
    while c > MIN_CHUNK and B * Hkv * _cdiv(S, c) < MIN_BLOCKS:
        c //= 2
    return min(c, _cdiv(S, WARP_TILE) * WARP_TILE)


def blocks_per_call(B, S, H, Hkv, D, Dv, chunk=None):
    """Blocks of a call's two launches, ``[split kernel, combine]``, at
    ``chunk`` slots a split block (default :func:`chunk_len`'s), asked of
    the built library."""
    out = (ctypes.c_int * 2)()
    status = _lib().decode_attention_grid(
        B, S, H, Hkv, D, Dv, chunk or chunk_len(B, Hkv, S), out)
    _build.check(status, "decode_attention_grid")
    return list(out)


def decode_attention_plain(q, k_cache, v_cache, valid, *, softcap=0.0,
                           scale=None):
    """Plain version.  q ``[B, H, D]``, k/v ``[B, S, Hkv, D|Dv]``, valid
    ``[B, S]`` bool -> (o ``[B, H, Dv]`` in q's dtype, mass ``[B, S]``
    f32)."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    s = _softcap(s, softcap)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    mass = p.reshape(B, H, S).mean(dim=1)
    return o.reshape(B, H, Dv).to(q.dtype), mass


def decode_attention(q, k_cache, v_cache, valid, *, softcap=0.0,
                     scale=None):
    """One-token attention over a KV slot table: q ``[B, H, D]``, k/v
    ``[B, S, Hkv, D|Dv]`` (bf16 or f32; D, Dv <= 256), valid ``[B, S]``
    bool.  Returns ``(o [B, H, Dv], mass [B, S] f32)``."""
    no_grad_guard("B3 (decode_attention)", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid,
                                      softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, _, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    _check(q, k_cache, v_cache, valid, S)
    return launch(q, k_cache, v_cache, valid, softcap,
                  scale if scale is not None else 1.0 / math.sqrt(D),
                  chunk_len(B, Hkv, S))


def launch(q, k_cache, v_cache, valid, softcap, scale, chunk):
    """The kernel on CUDA tensors that :func:`decode_attention` has checked,
    at ``chunk`` slots a split block (a multiple of ``WARP_TILE``, at most
    1,024)."""
    global LAUNCHES
    q, k_cache, v_cache, valid = (
        x.contiguous() for x in (q, k_cache, v_cache, valid))
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    dev = q.device
    o = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
    mass = torch.empty((B, S), dtype=torch.float32, device=dev)
    scores = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    part = torch.empty((B, H, _cdiv(S, chunk), Dv + 2), dtype=torch.float32,
                       device=dev)
    status = _lib().decode_attention_fwd(
        *(_P(x.data_ptr()) for x in (q, k_cache, v_cache, valid, o, mass,
                                     scores, part)),
        _DTYPES[q.dtype], B, S, H, Hkv, D, Dv, chunk, scale,
        float(softcap or 0.0), _P(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(status, "decode_attention_fwd")
    LAUNCHES += 1
    return o, mass


def _check(q, k, v, valid, S):
    """Raise unless q ``[B, H, D]``, k/v ``[B, Sk, Hkv, D|Dv]`` and valid
    ``[B, S]`` are what the split kernel takes."""
    B, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if k.shape != (B, Sk, Hkv, D) or v.shape[:3] != (B, Sk, Hkv) \
            or valid.shape != (B, S) or H % Hkv or D > 256 or Dv > 256:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, valid {tuple(valid.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or valid.dtype != torch.bool:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{valid.dtype}")
    for x in (k, v, valid):
        if x.device != q.device:
            raise ValueError(f"tensors on {q.device} and {x.device}")


def decode_attention_partial_plain(q, k_blk, v_blk, valid, s0, *,
                                   softcap=0.0, scale=None):
    """Plain version of :func:`decode_attention_partial`."""
    B, H, D = q.shape
    Sb, Hkv = k_blk.shape[1], k_blk.shape[2]
    Dv = v_blk.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, Hkv, H // Hkv, D)
    s = _softcap(torch.einsum("bhgd,bshd->bhgs", qf, k_blk.float()),
                 softcap)
    blk = valid[:, s0:s0 + Sb]
    s = torch.where(blk[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    # every slot of a row with no valid slot; else the block's valid ones
    take = blk | ~valid.any(dim=-1, keepdim=True)
    p = torch.where(take[:, None, None], torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_blk.float())
    part = torch.cat([acc.reshape(B, H, Dv), m.reshape(B, H, 1),
                      p.sum(dim=-1).reshape(B, H, 1)], dim=-1)
    return part, s.reshape(B, H, Sb)


def decode_attention_partial(q, k_blk, v_blk, valid, s0, *, softcap=0.0,
                             scale=None):
    """B3 over one block of a slot table: q ``[B, H, D]``, k/v ``[B, Sb,
    Hkv, D|Dv]`` the table's slots ``[s0, s0 + Sb)``, valid ``[B, S]`` bool
    its whole rows.  Returns ``(part [B, H, Dv + 2] f32, scores [B, H, Sb]
    f32)``: each head's ``(acc, m, l)`` over the block (``acc`` the
    block's sum of ``e^(s - m) v``, ``m`` its largest valid score or
    -1e30, ``l`` the sum of ``e^(s - m)``: 0 for a block with no valid
    slot in a row that has some; a row with none weighs all its slots
    alike), and the block's raw scores, masked slots -1e30."""
    no_grad_guard("B3 (decode_attention_partial)", q, k_blk, v_blk)
    if q.device.type == "cpu":
        return decode_attention_partial_plain(q, k_blk, v_blk, valid, s0,
                                              softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, H, D = q.shape
    Sb, Hkv, Dv = k_blk.shape[1], k_blk.shape[2], v_blk.shape[-1]
    _check(q, k_blk, v_blk, valid, valid.shape[1])
    if not 0 <= s0 <= valid.shape[1] - Sb:
        raise ValueError(f"block [{s0}, {s0 + Sb}) outside rows of "
                         f"{valid.shape[1]} slots")
    global PARTIAL_LAUNCHES
    q, k_blk, v_blk, valid = (x.contiguous()
                              for x in (q, k_blk, v_blk, valid))
    chunk = chunk_len(B, Hkv, Sb)
    dev = q.device
    out = torch.empty((B, H, Dv + 2), dtype=torch.float32, device=dev)
    scores = torch.empty((B, H, Sb), dtype=torch.float32, device=dev)
    part = torch.empty((B, H, _cdiv(Sb, chunk), Dv + 2),
                       dtype=torch.float32, device=dev)
    status = _lib().decode_attention_partial(
        *(_P(x.data_ptr()) for x in (q, k_blk, v_blk, valid, out, scores,
                                     part)),
        _DTYPES[q.dtype], B, Sb, valid.shape[1], int(s0), H, Hkv, D, Dv,
        chunk, scale if scale is not None else 1.0 / math.sqrt(D),
        float(softcap or 0.0), _P(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(status, "decode_attention_partial")
    PARTIAL_LAUNCHES += 1
    return out, scores


def _fold(m, l):
    """Each head's ``(m, l)`` over the blocks (dim 0), in block order."""
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    return top, w, (w * l).sum(dim=0).clamp(min=1e-30)


def decode_attention_merge_plain(parts, ml=None, scores=None, *,
                                 dtype=torch.float32):
    """Plain version of :func:`decode_attention_merge`."""
    Dv = parts.shape[-1] - 2
    _, w, l = _fold(parts[..., Dv], parts[..., Dv + 1])
    o = ((w[..., None] * parts[..., :Dv]).sum(dim=0) / l[..., None])
    if scores is None:
        return o.to(dtype), None
    top, _, lh = _fold(ml[..., 0], ml[..., 1])
    p = torch.exp(scores - top[..., None]) / lh[..., None]
    return o.to(dtype), p.mean(dim=1)


def decode_attention_merge(parts, ml=None, scores=None, *,
                           dtype=torch.float32):
    """The merge of N blocks' partials (:func:`decode_attention_partial`
    of each block of a slot table): parts ``[N, B, Hn, Dv + 2]`` f32, Hn
    heads' partials from each block in block order -> o ``[B, Hn, Dv]``
    in ``dtype``.  With ``scores`` (``[B, H, Sb]``, one block's raw
    scores) and ``ml`` (``[N, B, H, 2]``, every head's ``(m, l)`` from each
    block) also that block's mass ``[B, Sb]`` f32 (the mean over the H
    heads of the softmax weights), else None."""
    if parts.device.type == "cpu":
        return decode_attention_merge_plain(parts, ml, scores, dtype=dtype)
    if parts.device.type != "cuda":
        raise ValueError(f"no kernel for device {parts.device}")
    N, B, Hn, P = parts.shape
    Dv = P - 2
    H = Sb = 1
    if scores is not None:
        H, Sb = scores.shape[1], scores.shape[2]
        if ml is None or ml.shape != (N, B, H, 2) or \
                scores.shape[0] != B or ml.dtype != torch.float32 or \
                scores.dtype != torch.float32:
            raise ValueError(f"ml {None if ml is None else tuple(ml.shape)}"
                             f", scores {tuple(scores.shape)} for parts "
                             f"{tuple(parts.shape)}")
    if parts.dtype != torch.float32 or dtype not in _DTYPES or Dv > 256 \
            or Dv <= 0:
        raise ValueError(f"parts {parts.dtype}{tuple(parts.shape)}, "
                         f"o {dtype}")
    global MERGE_LAUNCHES
    dev = parts.device
    parts = parts.contiguous()
    o = torch.empty((B, Hn, Dv), dtype=dtype, device=dev)
    mass = None
    ptrs = [parts.data_ptr(), 0, 0, o.data_ptr(), 0]
    if scores is not None:
        ml, scores = ml.contiguous(), scores.contiguous()
        mass = torch.empty((B, Sb), dtype=torch.float32, device=dev)
        ptrs[1], ptrs[2], ptrs[4] = (ml.data_ptr(), scores.data_ptr(),
                                     mass.data_ptr())
    status = _lib().decode_attention_merge(
        *(_P(x) for x in ptrs), _DTYPES[dtype], N, B, Hn, H, Sb, Dv,
        _P(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(status, "decode_attention_merge")
    MERGE_LAUNCHES += 1
    return o, mass


def pad_heads(part, n):
    """``part`` ``[B, H, Dv + 2]`` with heads appended up to a multiple of
    ``n`` (so that the heads split over ``n`` ranks): each an empty
    block's partial (``acc = 0``, ``m = -1e30``, ``l = 0``), whose ``o``
    the merge makes 0."""
    B, H, P = part.shape
    extra = -H % n
    if not extra:
        return part
    pad = torch.zeros((B, extra, P), dtype=part.dtype, device=part.device)
    pad[..., P - 2] = NEG_INF
    return torch.cat([part, pad], dim=1)
