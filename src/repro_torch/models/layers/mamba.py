"""Mamba-1 selective SSM mixer (Jamba-style), as
:mod:`repro.models.layers.mamba`.

Per channel d and state entry n, with ``dt = softplus(x_proj -> dt_proj
+ dt_bias)`` and ``A = -exp(A_log)``::

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t
    y_t = h_t . C_t + D x_t

A full sequence runs the recurrence in fixed chunks of :data:`CHUNK`
tokens (a ragged last chunk is sliced), carrying h from chunk to chunk
and contracting with C inside each chunk (:func:`_scan_chunked`): no
tensor longer than a chunk is kept at (B, S, d_inner, d_state), where
the reference builds the whole sequence's. Inside a chunk the scan is a
log-depth doubling scan of ``exp(dt A)`` products, never a cumulative
sum of logs (``exp(-cumsum(dt A))`` overflows float32 once a chunk's
sum passes ~88). Everything is out of place, so autograd runs through
it. Decode is the exact one-step recurrence on a (B, d_inner, d_state)
float32 state with a (B, d_conv - 1, d_inner) conv window.

``conv_w``, ``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log`` and ``D``
are float32 parameters whatever ``param_dtype`` is; the SSM (dt, B, C,
the state and y before the gate) runs in float32, as the reference's.
No kernel: the reference's scan is ``jnp`` outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, dtype_of

F32 = torch.float32
CHUNK = 64


def _dims(cfg):
    di = cfg.mamba.d_inner(cfg.d_model)
    dt_rank = math.ceil(cfg.d_model / 16)
    return di, dt_rank, cfg.mamba.d_state, cfg.mamba.d_conv


def mamba_init(gen: torch.Generator, cfg):
    pd = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    di, dt_rank, N, dc = _dims(cfg)
    dev = gen.device
    # S4D-real initialization for A; dt log-uniform in [1e-3, 1e-1], its
    # bias the inverse softplus of it
    A = torch.arange(1, N + 1, dtype=F32, device=dev).expand(di, N)
    u = torch.rand((di,), generator=gen, dtype=F32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": dense_init(gen, (d, 2 * di), d, pd),
        "conv_w": dense_init(gen, (dc, di), dc, F32),
        "conv_b": torch.zeros((di,), dtype=F32, device=dev),
        "x_proj": dense_init(gen, (di, dt_rank + 2 * N), di, pd),
        "dt_proj": dense_init(gen, (dt_rank, di), dt_rank, F32),
        "dt_bias": dt + torch.log1p(-torch.exp(-dt)),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=F32, device=dev),
        "out_proj": dense_init(gen, (di, d), di, pd),
    }


def mamba_axes(cfg):
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": ("conv_k", "inner"),
        "conv_b": ("inner",),
        "x_proj": ("inner", "lowrank"),
        "dt_proj": ("lowrank", "inner"),
        "dt_bias": ("inner",),
        "A_log": ("inner", "state"),
        "D": ("inner",),
        "out_proj": ("inner", "embed"),
    }


def _causal_conv(x, w, b, prev=None):
    """Depthwise causal conv. x: (B, S, di); w: (dc, di); b: (di,);
    prev: (B, dc-1, di), the inputs before x (zeros when None). Returns
    (y (B, S, di), the last dc-1 inputs: the next call's ``prev``)."""
    dc = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, k:k + S] * w[k].to(x.dtype) for k in range(dc))
    return y + b.to(x.dtype), xp[:, -(dc - 1):]


def _ssm_inputs(params, xc, cfg):
    """From the conv output xc (B, S, di): dt (B, S, di), Bm and Cm
    (B, S, N), all float32. ``x_proj`` runs in xc's dtype, ``dt_proj``
    and the softplus in float32."""
    _, dt_rank, N, _ = _dims(cfg)
    proj = (xc @ params["x_proj"].to(xc.dtype)).float()
    dt_low, Bm, Cm = proj.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_low @ params["dt_proj"].float()
                    + params["dt_bias"].float())
    return dt, Bm, Cm


def _scan_in_chunk(a, b):
    """The inclusive scan h_t = a_t h_{t-1} + b_t along axis 1 from
    h = 0: a doubling scan (log2 L combines), each pair of steps
    composed as (a2 a1, a2 b1 + b2). a, b: (B, L, di, N)."""
    L = a.shape[1]
    off = 1
    while off < L:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], 1)
        if 2 * off < L:          # the last combine needs no new a
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def _scan_chunked(dt, A, u, Bm, Cm, h0):
    """y_t = h_t . C_t with h_t = exp(dt_t A) h_{t-1} + u_t B_t, in
    chunks of :data:`CHUNK` tokens. dt, u: (B, S, di); A: (di, N); Bm,
    Cm: (B, S, N); h0: (B, di, N). Returns (y (B, S, di), h_S)."""
    S = dt.shape[1]
    h, ys = h0, []
    for s in range(0, S, CHUNK):
        e = min(S, s + CHUNK)
        a = torch.exp(dt[:, s:e, :, None] * A)                  # (B,L,di,N)
        b = u[:, s:e, :, None] * Bm[:, s:e, None, :]
        # the carried state enters as the first step's input
        b = torch.cat([torch.addcmul(b[:, :1], a[:, :1], h[:, None]),
                       b[:, 1:]], 1)
        h_all = _scan_in_chunk(a, b)
        ys.append(torch.einsum("bldn,bln->bld", h_all, Cm[:, s:e]))
        h = h_all[:, -1]
    return torch.cat(ys, 1), h


def _mamba_seq(params, x, cfg):
    """The full-sequence pass from the zero state: (y, the conv tail, the
    final SSM state)."""
    di, _, N, _ = _dims(cfg)
    xin, z = (x @ params["in_proj"].to(x.dtype)).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_inputs(params, xc, cfg)
    xf = xc.float()
    A = -torch.exp(params["A_log"].float())
    h0 = torch.zeros((x.shape[0], di, N), dtype=F32, device=x.device)
    y, h = _scan_chunked(dt, A, dt * xf, Bm, Cm, h0)
    y = y + params["D"].float() * xf
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"].to(x.dtype), conv_state, h


def mamba_apply(params, x, cfg):
    """Full-sequence forward. x: (B, S, d) -> (B, S, d)."""
    return _mamba_seq(params, x, cfg)[0]


def mamba_prefill(params, x, cfg, cache_dtype):
    """Full-sequence forward that also returns the decode cache: the conv
    tail and the final SSM state that :func:`mamba_apply` discards."""
    y, conv_state, h = _mamba_seq(params, x, cfg)
    return y, {"conv": conv_state.to(cache_dtype), "h": h}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, dtype, device=None):
    di, _, N, dc = _dims(cfg)
    return {
        "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, N), dtype=F32, device=device),
    }


def cache_axes():
    return {
        "conv": ("cache_batch", "conv_k", "inner"),
        "h": ("cache_batch", "inner", "state"),
    }


def mamba_decode(params, x, cache, cfg):
    """One token per row. x: (B, 1, d). Returns (y, the new cache)."""
    xin, z = (x @ params["in_proj"].to(x.dtype)).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  prev=cache["conv"])
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_inputs(params, xc, cfg)
    xf, dt = xc[:, 0].float(), dt[:, 0]
    a = torch.exp(dt[..., None] * -torch.exp(params["A_log"].float()))
    h = a * cache["h"] + (dt * xf)[..., None] * Bm[:, 0, None, :]
    y = (h @ Cm[:, 0, :, None])[..., 0] + params["D"].float() * xf
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
    return (y @ params["out_proj"].to(x.dtype),
            {"conv": conv_state.to(cache["conv"].dtype), "h": h})
