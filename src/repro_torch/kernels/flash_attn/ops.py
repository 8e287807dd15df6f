"""The flash-attention entry point the model calls.

A CPU tensor gets the plain version (:func:`ref.mha_ref`); a CUDA tensor
gets the Hopper kernel or an exception -- never a fallback. ``LAUNCHES``
counts kernel launches, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import kernel, ref

LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd) with KV dividing H (GQA).
    Returns (B, S, H, hd) in q's dtype."""
    global LAUNCHES
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return ref.mha_ref(q, k, v, causal=causal, window=window, scale=scale)
    if kinds == {"cuda"}:
        out = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, scale=scale)
        LAUNCHES += 1
        return out
    raise ValueError(f"flash_attention takes CPU or CUDA tensors on one "
                     f"device, got {sorted(kinds)}")
