"""Causal flash attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas``, ``pallas_call`` at :107; wrapper
``kernels/ops.py:28``), which the reference documents as the drop-in for
``models/layers.py::chunked_attention``.  The port's prefill runs it where
the reference runs ``chunked_attention`` (``models/model.py:127``).  The
kernel is hand-written CUDA C++ for ``sm_90a`` in
``csrc/flash_attention.cu`` (its header gives the design and the bound):
bf16 on the tensor cores (``wgmma`` fed by ``cp.async``), f32
on the CUDA cores.  It is built by :mod:`._build` and called through
``ctypes``.

:func:`attention_dense` is the plain version: the reference's
``models/layers.py::attention_dense`` (the Pallas kernel's oracle) in
torch, O(S^2) scores in f32.  :func:`flash_attention` runs it on CPU
tensors; on a CUDA tensor it launches the kernel or raises.

``LAUNCHES`` counts launches of the kernel: :func:`flash_attention` adds
one where it launches, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["flash_attention", "attention_dense", "NEG_INF", "LAUNCHES"]

NEG_INF = -1e30
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _F, _I, _I, _F, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


def _softcap(scores, cap):
    """``tanh(s / cap) * cap``; ``cap == 0`` is off."""
    if cap:
        return torch.tanh(scores / cap) * cap
    return scores


def attention_dense(q, k, v, *, causal=True, window=None, softcap=0.0,
                    scale=None):
    """Plain version: O(S^2) attention in f32.  q ``[B, Sq, H, D]``, k
    ``[B, Sk, Hkv, D]``, v ``[B, Sk, Hkv, Dv]`` -> ``[B, Sq, H, Dv]`` in q's
    dtype.  Masked scores are ``NEG_INF``, not ``-inf``, as in the
    reference."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, g, D) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = _softcap(s, softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, Dv).to(q.dtype)


def _check(q, k, v):
    B, Sq, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[0] != B or \
            v.shape[:3] != k.shape[:3] or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    Hkv = k.shape[2]
    if H % Hkv or D > 256 or v.shape[3] > 256:
        raise ValueError(f"H={H} must be a multiple of Hkv={Hkv}; "
                         f"D={D}, Dv={v.shape[3]} at most 256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: one of "
                         f"{list(_DTYPES)} for all three")
    for x in (k, v):
        if x.device != q.device:
            raise ValueError(f"tensors on {q.device} and {x.device}")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=0.0,
                    scale=None):
    """Causal flash attention: q ``[B, Sq, H, D]``, k ``[B, Sk, Hkv, D]``,
    v ``[B, Sk, Hkv, Dv]`` -> ``[B, Sq, H, Dv]`` in q's dtype (bf16 or
    f32; D, Dv <= 256).  ``window`` keeps keys ``kpos > qpos - window``;
    ``softcap`` > 0 caps scores with ``tanh``."""
    global LAUNCHES
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_dense(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    status = _lib().flash_attention_fwd(
        _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(o.data_ptr()), _DTYPES[q.dtype], B, Sq, Sk, H, Hkv, D, Dv,
        scale, int(bool(causal)), int(window or 0), float(softcap or 0.0),
        _P(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(status, "flash_attention_fwd")
    LAUNCHES += 1
    return o
