"""Launcher of the Hopper chunkwise mLSTM kernel (K6, ``csrc/mlstm.cu``).

:func:`mlstm_chunk_cuda` replaces ``repro/kernels/mlstm/kernel.py:
mlstm_chunk_pallas`` together with its batch x head vmap
(``mlstm/ops.py:mlstm_chunkwise``): it takes the (B, S, H, hd) layout
with the caller's strides, the initial (C, n, m) state, and returns the
final one beside h. A ragged last chunk is masked in the kernel, never
padded here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm.ref import zero_state

LC = 64      # the kernel's chunk tile: the longest chunk it takes
DKT = 64     # dk is streamed in slices of this many rows
TV = 32      # dv is split over blocks in tiles of this many columns
MAX_DK = 1024
_FN = []     # the bound C function, resolved on first launch

_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


def _fn():
    if not _FN:
        fn = build.load("mlstm").mlstm_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _check(q, k, v, i_raw, f_log, chunk):
    for name, t in (("q", q), ("k", k), ("v", v), ("i_raw", i_raw),
                    ("f_log", f_log)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            "torch.float32")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} must be "
                         f"(B, S, H, dk) and v {tuple(v.shape)} (B, S, H, dv)")
    if i_raw.shape != q.shape[:3] or f_log.shape != q.shape[:3]:
        raise ValueError(f"gates {tuple(i_raw.shape)} / {tuple(f_log.shape)} "
                         f"must be (B, S, H) = {tuple(q.shape[:3])}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, got "
                             f"strides {t.stride()}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if S < 1:
        raise ValueError("the sequence is empty")
    if dk % DKT or dk > MAX_DK:
        raise ValueError(f"dk={dk} must be a multiple of {DKT} up to "
                         f"{MAX_DK}")
    if dv % TV:
        raise ValueError(f"dv={dv} must be a multiple of {TV}")
    if not 1 <= chunk <= LC:
        raise ValueError(f"chunk={chunk} must lie in [1, {LC}]")


def _state(state, B, H, dk, dv, device):
    if state is None:
        return zero_state(B, H, dk, dv, device)
    shapes = ((B, H, dk, dv), (B, H, dk), (B, H))
    out = []
    for name, t, s in zip(("C", "n", "m"), state, shapes):
        if tuple(t.shape) != s or t.dtype != torch.float32 \
                or t.device != device:
            raise ValueError(f"state {name} must be float32 {s} on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        out.append(t.contiguous())
    return tuple(out)


def mlstm_chunk_cuda(q, k, v, i_raw, f_log, state=None, *, chunk: int = 64):
    """q, k: (B, S, H, dk); v: (B, S, H, dv); i_raw, f_log: (B, S, H); all
    float32 on one CUDA device. ``state``: (C (B, H, dk, dv), n (B, H, dk),
    m (B, H)) float32, zeros when None. Returns (h (B, S, H, dv) float32,
    (C, n, m) after the last token). Raises on what the kernel does not
    take and on a failed launch."""
    _check(q, k, v, i_raw, f_log, chunk)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    C0, n0, m0 = _state(state, B, H, dk, dv, dev)
    ig, fg = i_raw.contiguous(), f_log.contiguous()
    h = torch.empty((B, S, H, dv), dtype=torch.float32, device=dev)
    C1, n1, m1 = (torch.empty_like(t) for t in (C0, n0, m0))
    nc = -(-S // chunk)
    G = torch.empty((B * H, nc, LC, LC), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
            fg.data_ptr(), C0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
            h.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
            G.data_ptr(), B, S, H, dk, dv, int(chunk), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"mlstm_fwd launch failed with CUDA error {err} "
                           f"(B={B} S={S} H={H} dk={dk} dv={dv} "
                           f"chunk={chunk})")
    return h, (C1, n1, m1)
