"""The chunkwise mLSTM entry point the model calls (K6).

A CPU tensor gets the plain version (:func:`ref.mlstm_chunk_plain`). A
CUDA tensor gets the Hopper kernel or an exception -- never a fallback.
The kernel computes a forward only: a CUDA call whose inputs require a
gradient raises, since the backward comes with the xLSTM training slice.
``LAUNCHES`` counts the kernel's launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm import kernel, ref

LAUNCHES = 0


def mlstm_chunkwise(q, k, v, i_raw, f_log, state=None, *, chunk: int = 64):
    """q, k: (B, S, H, dk); v: (B, S, H, dv), float32 or bfloat16 (the
    kernel takes the three in one of the two; the served bf16 model passes
    them as it computes them); i_raw, f_log: (B, S, H) float32; state: (C,
    n, m) or None for zeros. Computes in float32 and returns (h (B, S, H,
    dv) float32 -- float64 only for float64 inputs on the CPU --, the final
    (C, n, m) float32)."""
    global LAUNCHES
    tensors = (q, k, v, i_raw, f_log) + tuple(state or ())
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return ref.mlstm_chunk_plain(q, k, v, i_raw, f_log, state,
                                     chunk=chunk)
    if kinds == {"cuda"}:
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                "the chunkwise mLSTM kernel computes a forward only; its "
                "backward comes with the xLSTM training slice")
        out = kernel.mlstm_chunk_cuda(q, k, v, i_raw, f_log, state,
                                      chunk=chunk)
        LAUNCHES += 1
        return out
    raise ValueError(f"mlstm_chunkwise takes CPU or CUDA tensors on one "
                     f"device, got {sorted(kinds)}")
