"""Launcher of the Hopper flash-attention forward (``csrc/flash_attn.cu``).

Replaces ``repro/kernels/flash_attn/kernel.py:flash_attention_pallas``.
Takes the public (B, S, H, hd) layout and GQA kv heads directly, passes
strides instead of transposing, and masks ragged edges in the kernel
instead of padding.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

SUPPORTED_HD = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = []   # the bound C function, resolved on first launch

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _fn():
    if not _FN:
        fn = build.load("flash_attn").flash_attn_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{sorted(map(str, _DTYPE_CODES))}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, hd), "
                             f"got shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, "
                             f"got strides {t.stride()}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads do not divide {H} heads")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HD}")
    if q.dtype == torch.bfloat16:
        # the tensor-core body reads and writes bf16 pairs (4 bytes)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:3]):
                raise ValueError(f"bf16 {name} needs even strides and a "
                                 f"4-byte aligned start, got strides "
                                 f"{t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd), all on one CUDA device.
    Returns (B, S, H, hd) in q's dtype. Raises on what the kernel does not
    take and on a failed launch."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = scale or hd ** -0.5
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _DTYPE_CODES[q.dtype], B, S, Skv, H, KV, hd,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], float(scale), int(causal),
                    int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error "
                           f"{err} (B={B} S={S} Skv={Skv} H={H} KV={KV} "
                           f"hd={hd} {q.dtype})")
    return out
