"""The flash-attention entry point the model calls.

A CPU tensor gets the plain version (:func:`ref.mha_ref`), differentiated
by autograd. A CUDA tensor gets the Hopper kernels or an exception --
never a fallback: without a gradient the forward kernel alone; when an
input requires a gradient, :class:`FlashAttention`, whose forward kernel
also saves each row's log-sum-exp and whose backward is the backward
kernel. ``LAUNCHES`` and ``LAUNCHES_BWD`` count the forward and backward
launches, so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import kernel, ref

LAUNCHES = 0
LAUNCHES_BWD = 0


class FlashAttention(torch.autograd.Function):
    """The kernels' forward and backward as one differentiable op."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        global LAUNCHES
        out, lse = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window, scale=scale,
                                               return_lse=True)
        LAUNCHES += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        global LAUNCHES_BWD
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1 or (dout.dtype == torch.bfloat16
                                    and not kernel.aligned(dout)):
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = kernel.flash_attention_bwd_cuda(q, k, v, out, lse,
                                                     dout, **ctx.opts)
        LAUNCHES_BWD += 1
        return dq, dk, dv, None, None, None


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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        out = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, scale=scale)
        LAUNCHES += 1
        return out
    raise ValueError(f"flash_attention takes CPU or CUDA tensors on one "
                     f"device, got {sorted(kinds)}")
