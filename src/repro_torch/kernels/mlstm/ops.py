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
went through them. A ``meta`` tensor gets the kernels' shape functions
(:mod:`repro_torch.kernels.route`), and every call charges its
:func:`work` to an active :class:`repro_torch.perf.count.StepCount`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm import kernel, ref
from repro_torch.kernels.route import device_kind
from repro_torch.perf.count import kernel_site
from repro_torch.perf.roofline import PEAK_BY_KIND, Work

LAUNCHES = 0
LAUNCHES_BWD = 0


def _fwd_flops(S, dk, dv, chunk, state):
    """The forward's operations for one row and head: per chunk of L
    tokens the state update of C and n (2 L dk dv + 2 L dk), q C0 and
    q.n0 (as many again, but not in a first chunk from the zero state)
    and the causal pairs' q.k and score-times-v (L (L + 1) (dk + dv))."""
    flops = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        flops += ((2 if t0 == 0 and not state else 4) * L * (dk * dv + dk)
                  + L * (L + 1) * (dk + dv))
    return flops


def _bwd_routes(S, dk, dv, chunk, state):
    """((all flops, q.k flops) chunkwise, the same over all pairs) of the
    backward for one row and head: chunkwise with the states recomputed,
    or all causal pairs over the whole sequence (m cancels in h, so the
    backward may block the sequence as it likes)."""
    nc = -(-S // chunk)
    chunked = chunked_qk = 0
    for c in range(nc):
        L = min(chunk, S - c * chunk)
        st = 2 * L * dk * dv
        chunked_qk += L * (L + 1) // 2 * 2 * dk
        chunked += ((c + 1 < nc) * (3 * st + 2 * L * dk)
                    + (c > 0) * (2 * st + 2 * L * dk)
                    + (c == 0 and state) * (st + 2 * L * dk)
                    + L * (L + 1) // 2 * 2 * (3 * dk + 2 * dv) + 6 * L * dk)
    pairs_qk = S * (S + 1) // 2 * 2 * dk
    pairs = (S * (S + 1) // 2 * 2 * (3 * dk + 2 * dv)
             + state * (2 * S * dk * dv + 6 * S * dk))
    return (chunked, chunked_qk), (pairs, pairs_qk)


def work(B: int, S: int, H: int, dk: int, dv: int, dtype, *,
         chunk: int = 64, state: bool = False,
         backward: bool = False) -> Work:
    """K6's work for q, k (B, S, H, dk), v (B, S, H, dv) in ``dtype``
    (``state``: an initial (C, n, m) is given).

    Forward: the operations of :func:`_fwd_flops` at TF32's rate (the
    state is f32); bytes: q, k, v and the two gates read, h and the final
    state written (and the initial state read). Backward: the cheaper in
    time of its two algorithms (:func:`_bwd_routes`), its q.k products at
    the rate class of q's and k's type (bf16 x bf16 on the bf16 tensor
    cores) and every other product, which has an f32 operand, at TF32's;
    bytes: q, k, v, the gates and dh (and the state) read, dq, dk, dv and
    the gates' gradients written."""
    el = torch.empty((), dtype=dtype).element_size()
    state_bytes = 4 * B * H * (dk * dv + dk + 1)
    if not backward:
        return Work({"tf32": B * H * _fwd_flops(S, dk, dv, chunk, state)},
                    el * B * S * H * (2 * dk + dv)
                    + 4 * B * S * H * (dv + 2) + state_bytes * (1 + state))
    qk_kind = "bf16" if dtype == torch.bfloat16 else "tf32"
    total, qk = min(_bwd_routes(S, dk, dv, chunk, state),
                    key=lambda r: (r[1] / PEAK_BY_KIND[qk_kind]
                                   + (r[0] - r[1]) / PEAK_BY_KIND["tf32"]))
    return (Work({qk_kind: B * H * qk}, 0)
            + Work({"tf32": B * H * (total - qk)},
                   2 * el * B * S * H * (2 * dk + dv)
                   + 4 * B * S * H * (dv + 4) + state * state_bytes))


def _work(q, v, state, chunk, backward=False):
    B, S, H, dk = q.shape
    return lambda: work(B, S, H, dk, v.shape[-1], q.dtype, chunk=chunk,
                        state=state is not None, backward=backward)


def _forward(q, k, v, i_raw, f_log, state, chunk):
    global LAUNCHES
    with kernel_site("K6", _work(q, v, state, chunk)):
        if q.device.type == "cpu":
            return ref.mlstm_chunk_plain(q, k, v, i_raw, f_log, state,
                                         chunk=chunk)
        if q.device.type == "meta":
            B, S, H, dk = q.shape
            f32 = dict(dtype=torch.float32, device=q.device)
            return (torch.empty((B, S, H, v.shape[-1]), **f32),
                    (torch.empty((B, H, dk, v.shape[-1]), **f32),
                     torch.empty((B, H, dk), **f32),
                     torch.empty((B, H), **f32)))
        out = kernel.mlstm_chunk_cuda(q, k, v, i_raw, f_log, state,
                                      chunk=chunk)
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
        with kernel_site("K6 bwd", _work(q, v, state, ctx.chunk, True)):
            if q.device.type == "cpu":
                *grads, dstate = ref.mlstm_chunk_bwd_plain(
                    q, k, v, i_raw, f_log, dh, state, chunk=ctx.chunk)
                return (*grads, *(dstate or (None,) * 3), None)
            if q.device.type == "meta":
                grads = tuple(t.new_empty(t.shape)
                              for t in (q, k, v, i_raw, f_log))
            else:
                grads = kernel.mlstm_chunk_bwd_cuda(
                    q, k, v, i_raw, f_log, dh, state, chunk=ctx.chunk)
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
    kind = device_kind("mlstm_chunkwise", tensors)
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in tensors)):
        return _forward(q, k, v, i_raw, f_log, state, chunk)
    if kind != "cpu" and any(t.requires_grad for t in state or ()):
        raise NotImplementedError(
            "the chunkwise mLSTM kernel's backward takes the initial state "
            "as a constant; training starts from the zero state")
    C0, n0, m0 = state or (None, None, None)
    h, C, n, m = MLSTMChunk.apply(q, k, v, i_raw, f_log, C0, n0, m0, chunk)
    return h, (C, n, m)
