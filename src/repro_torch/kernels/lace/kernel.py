"""Launchers of the Hopper LACE kernels (``csrc/lace.cu``).

* :func:`lace2_fwd_cuda` -- K1, replaces ``repro/kernels/lace/kernel.py:
  lace2_fwd_pallas``: both sides' per-token NLL and log-sum-exp;
* :func:`lace2_bwd_cuda` -- K2, replaces ``lace2_bwd_pallas``: both
  sides' feature cotangents and the server side's head gradient.

Tokens come flattened, (N, d) with any row stride; each side's prior is a
``(rows, V)`` table of ``tau * log(P + eps)`` plus an optional per-token
row id, so the per-client priors of eq. 15 go in one call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

BLOCK = 128                      # token and vocab tile of the kernels
WORKSPACE_BYTES = 1 << 30        # K2's cotangent tiles per vocab chunk
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "lace2_fwd": [_P, _L, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                  _P, _P, _P, _P, _P, _P],
    "lace2_bwd": [_P, _L, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
}
_FNS = {}


def _fn(name):
    if name not in _FNS:
        fn = getattr(build.load("lace"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_splits(n_tokens: int, vocab: int, device) -> int:
    """How many ways K1 splits the vocab: enough blocks for ~8 waves over
    the card's SMs (one block per SM), at most one vocab tile each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(_cdiv(vocab, BLOCK),
                      _cdiv(8 * sms, _cdiv(n_tokens, BLOCK))))


def bwd_chunk(n_tokens: int, vocab: int) -> int:
    """K2's vocab columns per chunk: both sides' (N, vc) f32 cotangent
    tiles within WORKSPACE_BYTES, a multiple of the tile width."""
    vc = WORKSPACE_BYTES // (8 * n_tokens) // BLOCK * BLOCK
    return max(BLOCK, min(vc, _cdiv(vocab, BLOCK) * BLOCK))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(feats, w_head, labels, sides):
    dev = feats.device
    if feats.device.type != "cuda":
        raise ValueError(f"feats must be a CUDA tensor, got {feats.device}")
    if feats.dim() != 2 or feats.stride(-1) != 1:
        raise ValueError(f"feats must be (N, d) with a contiguous last axis, "
                         f"got shape {tuple(feats.shape)} strides "
                         f"{feats.stride()}")
    N, d = feats.shape
    if w_head.dim() != 2 or w_head.shape[0] != d or not w_head.is_contiguous():
        raise ValueError(f"w_head must be a contiguous (d={d}, V) tensor, "
                         f"got {tuple(w_head.shape)}")
    V = w_head.shape[1]
    for name, t in (("feats", feats), ("w_head", w_head)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{sorted(map(str, _DTYPE_CODES))}")
    if labels.shape != (N,) or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous int32 ({N},), got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    tensors = [("w_head", w_head), ("labels", labels)]
    for side, (adj, ids) in sides.items():
        if adj is None:
            if ids is not None:
                raise ValueError(f"ids_{side} given without adj_{side}")
            continue
        if adj.dim() != 2 or adj.shape[1] != V or adj.dtype != torch.float32 \
                or not adj.is_contiguous():
            raise ValueError(f"adj_{side} must be contiguous float32 "
                             f"(rows, V={V}), got {tuple(adj.shape)} "
                             f"{adj.dtype}")
        tensors.append((f"adj_{side}", adj))
        if ids is not None:
            if ids.shape != (N,) or ids.dtype != torch.int32 \
                    or not ids.is_contiguous():
                raise ValueError(f"ids_{side} must be contiguous int32 "
                                 f"({N},), got {tuple(ids.shape)} {ids.dtype}")
            tensors.append((f"ids_{side}", ids))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, feats on {dev}")
    return N, d, V


def _raise(name, err, N, d, V, feats, w_head):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} "
                           f"(N={N} d={d} V={V} feats {feats.dtype} w_head "
                           f"{w_head.dtype})")


def lace2_fwd_cuda(feats, w_head, labels, adj_s=None, ids_s=None, adj_k=None,
                   ids_k=None):
    """K1. feats (N, d); w_head (d, V); labels (N,) int32; adj_x (rows, V)
    float32 or None (side absent), ids_x (N,) int32 or None (row 0).
    Returns (nll_s, nll_k, lse_s, lse_k), each (N,) float32."""
    N, d, V = _check(feats, w_head, labels,
                     {"s": (adj_s, ids_s), "k": (adj_k, ids_k)})
    dev = feats.device
    splits = fwd_splits(N, V, dev)
    part = torch.empty(5 * splits * N, dtype=torch.float32, device=dev)
    nll_s, nll_k, lse_s, lse_k = torch.empty((4, N), dtype=torch.float32,
                                             device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("lace2_fwd")(
            feats.data_ptr(), feats.stride(0), _DTYPE_CODES[feats.dtype],
            w_head.data_ptr(), _DTYPE_CODES[w_head.dtype], labels.data_ptr(),
            _ptr(adj_s), _ptr(ids_s), _ptr(adj_k), _ptr(ids_k), N, d, V,
            splits, part.data_ptr(), nll_s.data_ptr(), nll_k.data_ptr(),
            lse_s.data_ptr(), lse_k.data_ptr(), stream)
    _raise("lace2_fwd", err, N, d, V, feats, w_head)
    return nll_s, nll_k, lse_s, lse_k


def lace2_bwd_cuda(feats, w_head, labels, adj_s, ids_s, adj_k, ids_k,
                   lse_s, lse_k, ts_s, ts_k):
    """K2. As :func:`lace2_fwd_cuda`, plus each side's log-sum-exp from it
    and per-token scale ``ts_x = weight * scale`` (N,) float32. Returns
    (df_s, df_k) (N, d) and dW_s (d, V), float32."""
    N, d, V = _check(feats, w_head, labels,
                     {"s": (adj_s, ids_s), "k": (adj_k, ids_k)})
    dev = feats.device
    for name, t in (("lse_s", lse_s), ("lse_k", lse_k), ("ts_s", ts_s),
                    ("ts_k", ts_k)):
        if t.shape != (N,) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous float32 ({N},) on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype}")
    vc = bwd_chunk(N, V)
    g = torch.empty((2, N, vc), dtype=torch.float32, device=dev)
    df = torch.empty((2, N, d), dtype=torch.float32, device=dev)
    dw = torch.empty((d, V), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("lace2_bwd")(
            feats.data_ptr(), feats.stride(0), _DTYPE_CODES[feats.dtype],
            w_head.data_ptr(), _DTYPE_CODES[w_head.dtype], labels.data_ptr(),
            _ptr(adj_s), _ptr(ids_s), _ptr(adj_k), _ptr(ids_k),
            lse_s.data_ptr(), lse_k.data_ptr(), ts_s.data_ptr(),
            ts_k.data_ptr(), N, d, V, vc, g[0].data_ptr(), g[1].data_ptr(),
            df[0].data_ptr(), df[1].data_ptr(), dw.data_ptr(), stream)
    _raise("lace2_bwd", err, N, d, V, feats, w_head)
    return df[0], df[1], dw
