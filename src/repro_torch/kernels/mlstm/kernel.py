"""Launchers of the Hopper chunkwise mLSTM kernels: K6 (``csrc/mlstm.cu``)
and its backward (``csrc/mlstm_bwd.cu``).

:func:`mlstm_chunk_cuda` replaces ``repro/kernels/mlstm/kernel.py:
mlstm_chunk_pallas`` together with its batch x head vmap
(``mlstm/ops.py:mlstm_chunkwise``): it takes the (B, S, H, hd) layout
with the caller's strides, q, k and v in float32 or bfloat16 (the Pallas
kernel casts them to float32 inside; so does this one), the initial
(C, n, m) state, and returns h in float32 and the final state beside it.
A ragged last chunk is masked in the kernel, never padded here. Its
scratch (the gates, the split q k^T partials, the decayed scores) is one
float32 buffer allocated here.

:func:`mlstm_chunk_bwd_cuda` replaces none (the reference trains through
autodiff of ``models/layers/xlstm.py:mlstm_chunk``): from the same inputs
and dh it returns dq, dk, dv in q's dtype and d i_raw, d f_log in
float32, rerunning the forward's gate pass itself and taking all pairs of
tokens in blocks of 512 (a state walk only between blocks, or from a
given initial state). Its scratch (the blocks' two pair matrices, the
per-token rows; the state and its f32 rows only where it walks) is one
float32 buffer allocated here too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LC = 64      # the kernel's chunk tile: the longest chunk it takes
DKT = 64     # dk is streamed in slices of this many rows
TV = 32      # dv is split over blocks in tiles of this many columns
MAX_DK = 1024
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C entry's codes
_FNS = {}    # the bound C functions, resolved on first launch

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
             + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])


def _fns():
    if "fwd" not in _FNS:
        lib = build.load("mlstm")
        lib.mlstm_fwd.argtypes = _ARGTYPES
        lib.mlstm_fwd.restype = ctypes.c_int
        lib.mlstm_workspace.argtypes = [ctypes.c_int] * 5
        lib.mlstm_workspace.restype = ctypes.c_longlong
        _FNS.update(fwd=lib.mlstm_fwd, workspace=lib.mlstm_workspace)
    return _FNS


def _bwd_fns():
    """The backward's C functions, from its own library (serving never
    builds it)."""
    if "bwd" not in _FNS:
        lib = build.load("mlstm_bwd")
        lib.mlstm_bwd.argtypes = _BWD_ARGTYPES
        lib.mlstm_bwd.restype = ctypes.c_int
        lib.mlstm_bwd_workspace.argtypes = [ctypes.c_int] * 7
        lib.mlstm_bwd_workspace.restype = ctypes.c_longlong
        _FNS.update(bwd=lib.mlstm_bwd, bwd_workspace=lib.mlstm_bwd_workspace)
    return _FNS


def _check(q, k, v, i_raw, f_log, chunk):
    for name, t in (("q", q), ("k", k), ("v", v), ("i_raw", i_raw),
                    ("f_log", f_log)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, torch.float32 or "
                        f"torch.bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("i_raw", i_raw), ("f_log", f_log)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the gates are "
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
    """The caller's (C, n, m), checked and contiguous; None (the zero
    state, which the kernel starts from without reading) stays None."""
    if state is None:
        return None, None, None
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
    """q, k: (B, S, H, dk); v: (B, S, H, dv), all float32 or all bfloat16;
    i_raw, f_log: (B, S, H) float32; all on one CUDA device. ``state``: (C
    (B, H, dk, dv), n (B, H, dk), m (B, H)) float32, zeros when None.
    Returns (h (B, S, H, dv) float32, (C, n, m) after the last token).
    Raises on what the kernel does not take and on a failed launch."""
    _check(q, k, v, i_raw, f_log, chunk)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    C0, n0, m0 = _state(state, B, H, dk, dv, dev)
    ig, fg = i_raw.contiguous(), f_log.contiguous()
    h = torch.empty((B, S, H, dv), dtype=torch.float32, device=dev)
    C1, n1, m1 = (torch.empty(shape, dtype=torch.float32, device=dev)
                  for shape in ((B, H, dk, dv), (B, H, dk), (B, H)))
    fns = _fns()
    work = torch.empty((fns["workspace"](B, S, H, dk, int(chunk)),),
                       dtype=torch.float32, device=dev)
    state_in = [None if t is None else t.data_ptr() for t in (C0, n0, m0)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fns["fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPES[q.dtype],
            ig.data_ptr(), fg.data_ptr(), *state_in, h.data_ptr(),
            C1.data_ptr(), n1.data_ptr(), m1.data_ptr(), work.data_ptr(),
            B, S, H, dk, dv, int(chunk),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"mlstm_fwd launch failed with CUDA error {err} "
                           f"(B={B} S={S} H={H} dk={dk} dv={dv} "
                           f"chunk={chunk} {q.dtype})")
    return h, (C1, n1, m1)


def mlstm_chunk_bwd_cuda(q, k, v, i_raw, f_log, dh, state=None, *,
                         chunk: int = 64):
    """The backward of :func:`mlstm_chunk_cuda` from the same inputs and
    dh (B, S, H, dv), the cotangent of h; the final state's cotangent is
    zero and ``state`` (the initial one, zeros when None) a constant.
    Returns (dq, dk, dv) in q's dtype and (d i_raw, d f_log) float32.
    Raises on what the kernel does not take and on a failed launch."""
    _check(q, k, v, i_raw, f_log, chunk)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    if dh.shape != v.shape or dh.dtype != torch.float32 or dh.device != dev:
        raise ValueError(f"dh must be float32 {tuple(v.shape)} on {dev}, "
                         f"got {tuple(dh.shape)} {dh.dtype} on {dh.device}")
    C0, n0, m0 = _state(state, B, H, dk, dv, dev)
    ig, fg, g = i_raw.contiguous(), f_log.contiguous(), dh.contiguous()
    dq, dk_, dv_ = (torch.empty(t.shape, dtype=q.dtype, device=dev)
                    for t in (q, k, v))
    di, df = (torch.empty((B, S, H), dtype=torch.float32, device=dev)
              for _ in range(2))
    fns = _bwd_fns()
    work = torch.empty((fns["bwd_workspace"](B, S, H, dk, dv, int(chunk),
                                             int(C0 is not None)),),
                       dtype=torch.float32, device=dev)
    state_in = [None if t is None else t.data_ptr() for t in (C0, n0, m0)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fns["bwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPES[q.dtype],
            ig.data_ptr(), fg.data_ptr(), *state_in, g.data_ptr(),
            dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), di.data_ptr(),
            df.data_ptr(), work.data_ptr(), B, S, H, dk, dv, int(chunk),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"mlstm_bwd launch failed with CUDA error {err} "
                           f"(B={B} S={S} H={H} dk={dk} dv={dv} "
                           f"chunk={chunk} {q.dtype})")
    return dq, dk_, dv_, di, df
