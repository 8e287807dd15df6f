"""The chunkwise mLSTM entry point the model calls (K6 and its backward).

A CPU tensor gets the plain versions (:func:`ref.mlstm_chunk_plain`,
:func:`ref.mlstm_chunk_bwd_plain`). A CUDA tensor gets the Hopper kernels
or an exception -- never a fallback. A call whose inputs require a
gradient goes through :class:`MLSTMChunk`: the forward, then on the
backward pass the backward kernel (on a CPU tensor the plain backward,
the same function). The final state's m is returned as a constant (the
stabilizer), and a cotangent of the final C or n raises: training reads h
only. On a CUDA tensor an initial state that requires a gradient raises
too; training starts from the zero state. ``LAUNCHES`` and
``LAUNCHES_BWD`` count the kernels' launches, so a run can show that it
went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm import kernel, ref

LAUNCHES = 0
LAUNCHES_BWD = 0


def _forward(q, k, v, i_raw, f_log, state, chunk):
    global LAUNCHES
    if q.device.type == "cpu":
        return ref.mlstm_chunk_plain(q, k, v, i_raw, f_log, state,
                                     chunk=chunk)
    out = kernel.mlstm_chunk_cuda(q, k, v, i_raw, f_log, state, chunk=chunk)
    LAUNCHES += 1
    return out


class MLSTMChunk(torch.autograd.Function):
    """h, C, n, m = MLSTMChunk.apply(q, k, v, i_raw, f_log, C0, n0, m0,
    chunk), the initial state all None for zeros."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, f_log, C0, n0, m0, chunk):
        state = None if C0 is None else (C0, n0, m0)
        h, (C, n, m) = _forward(q, k, v, i_raw, f_log, state, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(q, k, v, i_raw, f_log, *(state or ()))
        ctx.mark_non_differentiable(m)
        ctx.set_materialize_grads(False)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        global LAUNCHES_BWD
        if dC is not None or dn is not None or dh is None:
            raise NotImplementedError(
                "the chunkwise mLSTM's backward takes the cotangent of h "
                "only; the final state's is not carried")
        q, k, v, i_raw, f_log, *state = ctx.saved_tensors
        state = tuple(state) or None
        if q.device.type == "cpu":
            *grads, dstate = ref.mlstm_chunk_bwd_plain(
                q, k, v, i_raw, f_log, dh, state, chunk=ctx.chunk)
            return (*grads, *(dstate or (None,) * 3), None)
        grads = kernel.mlstm_chunk_bwd_cuda(q, k, v, i_raw, f_log, dh, state,
                                            chunk=ctx.chunk)
        LAUNCHES_BWD += 1
        return (*grads, None, None, None, None)


def mlstm_chunkwise(q, k, v, i_raw, f_log, state=None, *, chunk: int = 64):
    """q, k: (B, S, H, dk); v: (B, S, H, dv), float32 or bfloat16 (the
    kernel takes the three in one of the two; the served bf16 model passes
    them as it computes them); i_raw, f_log: (B, S, H) float32; state: (C,
    n, m) or None for zeros. Computes in float32 and returns (h (B, S, H,
    dv) float32 -- float64 only for float64 inputs on the CPU --, the final
    (C, n, m) float32)."""
    tensors = (q, k, v, i_raw, f_log) + tuple(state or ())
    kinds = {t.device.type for t in tensors}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"mlstm_chunkwise takes CPU or CUDA tensors on one "
                         f"device, got {sorted(kinds)}")
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in tensors)):
        return _forward(q, k, v, i_raw, f_log, state, chunk)
    if kinds == {"cuda"} and any(t.requires_grad for t in state or ()):
        raise NotImplementedError(
            "the chunkwise mLSTM kernel's backward takes the initial state "
            "as a constant; training starts from the zero state")
    C0, n0, m0 = state or (None, None, None)
    h, C, n, m = MLSTMChunk.apply(q, k, v, i_raw, f_log, C0, n0, m0, chunk)
    return h, (C, n, m)
