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

``LAUNCHES`` counts calls that launched the kernel (one call launches the
split kernel and the combine after it): :func:`decode_attention` adds one
where it launches, and nowhere else.

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

__all__ = ["decode_attention", "decode_attention_plain", "chunk_len",
           "blocks_per_call", "LAUNCHES"]

LAUNCHES = 0
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
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    if k_cache.shape != (B, S, Hkv, D) or v_cache.shape[:3] != (B, S, Hkv) \
            or valid.shape != (B, S) or H % Hkv or D > 256 or Dv > 256:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, v "
            f"{tuple(v_cache.shape)}, valid {tuple(valid.shape)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype or valid.dtype != torch.bool:
        raise ValueError(f"dtypes {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}, {valid.dtype}")
    for x in (k_cache, v_cache, valid):
        if x.device != q.device:
            raise ValueError(f"tensors on {q.device} and {x.device}")
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
