"""Launchers of the Hopper flash-attention kernels.

* :func:`flash_attention_cuda` -- the forward (``csrc/flash_attn.cu``),
  which replaces ``repro/kernels/flash_attn/kernel.py:
  flash_attention_pallas``; optionally also each row's log-sum-exp;
* :func:`flash_attention_bwd_cuda` -- the backward
  (``csrc/flash_attn_bwd.cu``): dq, dk, dv from q, k, v, the output, its
  cotangent and the saved log-sum-exp.

Both take the public (B, S, H, hd) layout and GQA kv heads directly, pass
strides instead of transposing, and mask ragged edges in the kernel
instead of padding. The bf16 bodies copy rows into shared memory 16 bytes
at a time, so a bf16 tensor must start on a 16-byte boundary and have
strides that are multiples of 8 elements (what a fresh or head-sliced
(B, S, H, hd) tensor has); anything else raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

SUPPORTED_HD = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}   # the bound C functions, resolved on first launch

_ARGTYPES = {
    "flash_attn_fwd": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p]),
    "flash_attn_bwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p]),
}
_SOURCES = {"flash_attn_fwd": "flash_attn", "flash_attn_bwd": "flash_attn_bwd"}


def _fn(name):
    if name not in _FNS:
        fn = getattr(build.load(_SOURCES[name]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def aligned(t: torch.Tensor) -> bool:
    """Whether a bf16 tensor meets the kernels' 16-byte rule: a 16-byte
    aligned start and the stride of every axis but the last (and but those
    of length 1, which no row address reads) a multiple of 8."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and not aligned(t):
            raise ValueError(f"bf16 {name} needs a 16-byte aligned start and "
                             f"strides that are multiples of 8, got start "
                             f"{t.data_ptr() % 16} bytes past a boundary and "
                             f"strides {t.stride()}")


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
    _check_aligned(q=q, k=k, v=v)


def _check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _scale(scale, hd):
    """The softmax scale, hd ** -0.5 by default; the kernels take the max
    of the raw scores for the max of the scaled ones, so it must be > 0."""
    scale = scale or hd ** -0.5
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    return scale


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd), all on one CUDA device.
    Returns (B, S, H, hd) in q's dtype, and with ``return_lse`` also each
    row's log-sum-exp of the scaled scores, (B, H, S) float32. Raises on
    what the kernel does not take and on a failed launch."""
    _check(q, k, v)
    _check_window(window)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = _scale(scale, hd)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attn_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, S, Skv, H, KV, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(causal), int(window or 0),
            None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error "
                           f"{err} (B={B} S={S} Skv={Skv} H={H} KV={KV} "
                           f"hd={hd} {q.dtype})")
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """dq, dk, dv of :func:`flash_attention_cuda`'s output. q, out, dout:
    (B, S, H, hd); k, v: (B, Skv, KV, hd); lse: (B, H, S) float32 from the
    forward. Returns (dq, dk, dv) in q's dtype, shaped like q, k, v.
    Raises on what the kernel does not take and on a failed launch."""
    _check(q, k, v)
    _check_window(window)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, got "
                             f"strides {t.stride()}")
    _check_aligned(out=out, dout=dout)
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 (B, H, S) = "
                         f"{(B, H, S)} tensor on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    scale = _scale(scale, hd)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    dvec = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, out, dout, dq, dk, dv) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn("flash_attn_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], B, S, Skv,
            H, KV, hd, ctypes.cast(strides, ctypes.c_void_p), float(scale),
            int(causal), int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed with CUDA error "
                           f"{err} (B={B} S={S} Skv={Skv} H={H} KV={KV} "
                           f"hd={hd} {q.dtype})")
    return dq, dk, dv
