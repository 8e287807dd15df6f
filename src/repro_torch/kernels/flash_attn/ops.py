"""The flash-attention entry point the model calls (K3).

The call site follows :mod:`repro_torch.kernels.route`. A CPU tensor gets
the plain version (:func:`ref.mha_ref`); a CUDA tensor gets the Hopper
kernels or an exception -- never a fallback; a ``meta`` tensor gets the
kernel's shape function. Without a gradient the forward alone; when an
input requires a gradient, :class:`FlashAttention`: on a card its forward
kernel also saves each row's log-sum-exp and its backward is the backward
kernel; on the CPU its backward differentiates the plain forward's own
graph, kept from the forward (the same ops autograd would run). Each call
charges its :func:`work` to an active
:class:`repro_torch.perf.count.StepCount`. ``LAUNCHES`` and
``LAUNCHES_BWD`` count the forward and backward launches, so a run can
show that it went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import kernel, ref
from repro_torch.kernels.route import device_kind
from repro_torch.perf.count import kernel_site
from repro_torch.perf.roofline import Work, rate_kind

LAUNCHES = 0
LAUNCHES_BWD = 0


def scored_pairs(S: int, window: Optional[int], Skv: Optional[int] = None,
                 causal: bool = True) -> int:
    """The (query, key) pairs attention over S queries scores: causal
    (and windowed) over S tokens, or with ``causal=False`` every one of
    ``Skv`` keys (default S)."""
    if not causal:
        return S * (S if Skv is None else Skv)
    if window is None or window >= S:
        return S * (S + 1) // 2
    # rows 0 .. window-1 see themselves and all before; later rows window
    return window * (window + 1) // 2 + (S - window) * window


def work(B: int, S: int, H: int, KV: int, hd: int, dtype, *,
         window: Optional[int] = None, Skv: Optional[int] = None,
         causal: bool = True, backward: bool = False) -> Work:
    """K3's work for q (B, S, H, hd) against k, v (B, Skv, KV, hd): the
    forward's QK^T and PV over the scored pairs (4 hd a pair), reading q,
    k, v and writing the output; the backward's five products (S, dP,
    dV, dK, dQ: 10 hd a pair), reading q, the output, dout, k, v and the
    log-sum-exp and writing dq, dk, dv. The products run at ``dtype``'s
    rate class."""
    Skv = S if Skv is None else Skv
    pairs = scored_pairs(S, window, Skv, causal) * H * B
    el = torch.empty((), dtype=dtype).element_size()
    if backward:
        return Work({rate_kind(dtype): 10 * hd * pairs},
                    el * (4 * B * S * H * hd + 4 * B * Skv * KV * hd)
                    + 4 * B * H * S)
    return Work({rate_kind(dtype): 4 * hd * pairs},
                B * (2 * S * H * hd + 2 * Skv * KV * hd) * el)


def _work(q, k, opts, backward=False):
    B, S, H, hd = q.shape
    return lambda: work(B, S, H, k.shape[2], hd, q.dtype,
                        window=opts["window"], Skv=k.shape[1],
                        causal=opts["causal"], backward=backward)


class FlashAttention(torch.autograd.Function):
    """The forward and backward as one differentiable op (module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        global LAUNCHES
        opts = dict(causal=causal, window=window, scale=scale)
        ctx.opts = opts
        with kernel_site("K3", _work(q, k, opts)):
            if q.device.type == "cpu":
                with torch.enable_grad():
                    ins = [t.detach().requires_grad_() for t in (q, k, v)]
                    out = ref.mha_ref(*ins, **opts)
                ctx.graph = (out, ins)
                # contiguous, as the kernel's output (and the shape
                # function's), so that what follows runs the same ops
                return out.detach().contiguous()
            if q.device.type == "meta":
                ctx.save_for_backward(q, k, v)
                return q.new_empty(q.shape)
            out, lse = kernel.flash_attention_cuda(q, k, v, return_lse=True,
                                                   **opts)
            LAUNCHES += 1
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        global LAUNCHES_BWD
        kind = dout.device.type
        if kind == "cpu":
            out, ins = ctx.graph
            with kernel_site("K3 bwd", _work(ins[0], ins[1], ctx.opts,
                                             backward=True)):
                # contiguous, as the backward kernel's
                grads = [g.contiguous() for g in torch.autograd.grad(
                    out, ins, dout, retain_graph=True)]
            return (*grads, None, None, None)
        saved = ctx.saved_tensors
        q, k, v = saved[:3]
        with kernel_site("K3 bwd", _work(q, k, ctx.opts, backward=True)):
            if kind == "meta":
                return (q.new_empty(q.shape), k.new_empty(k.shape),
                        v.new_empty(v.shape), None, None, None)
            out, lse = saved[3:]
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
    kind = device_kind("flash_attention", (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    opts = dict(causal=causal, window=window, scale=scale)
    with kernel_site("K3", _work(q, k, opts)):
        if kind == "cpu":
            return ref.mha_ref(q, k, v, **opts).contiguous()
        if kind == "meta":
            return q.new_empty(q.shape)
        out = kernel.flash_attention_cuda(q, k, v, **opts)
        LAUNCHES += 1
    return out
