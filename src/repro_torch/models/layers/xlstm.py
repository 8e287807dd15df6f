"""xLSTM mixers: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a true recurrence), as :mod:`repro.models.layers.xlstm`.

The mLSTM recurrence, per head, with log-sigmoid forget gates ``f`` and
raw input gates ``i`` (arXiv:2405.04517, stabilized form)::

    m_t = max(f_t + m_{t-1}, i_t)
    C_t = e^{f_t + m_{t-1} - m_t} C_{t-1} + e^{i_t - m_t} k_t v_t^T
    n_t = e^{f_t + m_{t-1} - m_t} n_{t-1} + e^{i_t - m_t} k_t
    h_t = (q_t C_t) / max(|q_t n_t|, e^{-m_t})

A full sequence runs it chunkwise through
:func:`repro_torch.kernels.mlstm.ops.mlstm_chunkwise`: the Hopper kernel
K6 on a CUDA tensor, its plain version on a CPU one. Decode runs the
exact per-step recurrence (:func:`mlstm_step`). The reference's
square-root rematerialization of the chunk scan only serves autodiff; it
comes with training.

sLSTM mixes its hidden state back through a block-diagonal matrix per
head, so its scan is sequential: a loop over time, a few PyTorch calls a
step. The input side of every gate is one product over the sequence.

Gate weights and biases (``w_gates``, ``b_gates``, ``r_gates``) are used
in float32 whatever the compute dtype, as the reference uses them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.layers.mamba import _causal_conv

F32 = torch.float32


def _group_norm(h, H, scale):
    """Per-head normalization of h (B, S, H * hd) in float32, times
    ``scale``."""
    B, S, D = h.shape
    hh = h.reshape(B, S, H, D // H)
    mu = hh.mean(dim=-1, keepdim=True)
    var = hh.var(dim=-1, unbiased=False, keepdim=True)
    return ((hh - mu) * (var + 1e-6) ** -0.5).reshape(B, S, D) * scale


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    H = cfg.num_heads
    return di, H, di // H


def mlstm_init(gen: torch.Generator, cfg):
    pd = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    di, H, hd = _mlstm_dims(cfg)
    dc = cfg.xlstm.conv_kernel
    dev = gen.device
    return {
        "up": dense_init(gen, (d, 2 * di), d, pd),
        "conv_w": dense_init(gen, (dc, di), dc, F32),
        "conv_b": torch.zeros((di,), dtype=F32, device=dev),
        # per-head block-diagonal projections, as the reference
        "wq": dense_init(gen, (H, hd, hd), hd, pd),
        "wk": dense_init(gen, (H, hd, hd), hd, pd),
        "wv": dense_init(gen, (H, hd, hd), hd, pd),
        "w_gates": dense_init(gen, (di, 2 * H), di, F32),
        "b_gates": torch.cat([torch.zeros(H), torch.linspace(3.0, 6.0, H)])
        .to(dev, F32),
        "out_norm": {"scale": torch.ones((di,), dtype=F32, device=dev)},
        "down": dense_init(gen, (di, d), di, pd),
    }


def _mlstm_qkvg(params, x, cfg, conv_prev=None):
    """x: (B, S, d) -> q, k, v (B, S, H, hd), i, f (B, S, H) float32,
    z (B, S, di), conv_state."""
    di, H, hd = _mlstm_dims(cfg)
    up = x @ params["up"].to(x.dtype)
    xin, z = up.split(di, dim=-1)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  prev=conv_prev)
    xc = F.silu(xc)
    B, S = x.shape[:2]
    xch = xc.reshape(B, S, H, hd)
    xinh = xin.reshape(B, S, H, hd)
    q = torch.einsum("bshd,hde->bshe", xch, params["wq"].to(x.dtype))
    k = torch.einsum("bshd,hde->bshe", xch, params["wk"].to(x.dtype))
    v = torch.einsum("bshd,hde->bshe", xinh, params["wv"].to(x.dtype))
    gates = xc.float() @ params["w_gates"].float() + params["b_gates"]
    i_raw, f_raw = gates.split(H, dim=-1)                     # (B, S, H)
    f_log = F.logsigmoid(f_raw)
    q = q * (hd ** -0.5)
    return q, k, v, i_raw, f_log, z, conv_state


def mlstm_step(q, k, v, i_raw, f_log, state):
    """The exact per-step recurrence (decode). q, k, v: (B, H, hd).

    The matrix memory C of ``state`` (contiguous) is updated in place and
    returned, where the reference returns a new one: it is the decode
    cache's O(hd^2) leaf, so a step neither allocates nor copies it."""
    C, n0, m0 = state
    B, H, dk = k.shape
    dv = v.shape[-1]
    m_t = torch.maximum(f_log + m0, i_raw)
    wf = torch.exp(f_log + m0 - m_t)
    wi = torch.exp(i_raw - m_t)
    # C wf + (wi k) v^T: two passes over the state
    C.mul_(wf[..., None, None])
    C.view(B * H, dk, dv).baddbmm_((wi[..., None] * k).reshape(B * H, dk, 1),
                                   v.reshape(B * H, 1, dv))
    n = n0 * wf[..., None] + wi[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.maximum(torch.abs((q * n).sum(dim=-1)), torch.exp(-m_t))
    return num / den[..., None], (C, n, m_t)


def _mlstm_out(params, h, z, cfg, dtype):
    di, H, hd = _mlstm_dims(cfg)
    B, S = h.shape[:2]
    h = _group_norm(h.reshape(B, S, di), H, params["out_norm"]["scale"])
    y = h.to(dtype) * F.silu(z)
    return y @ params["down"].to(dtype)


def _mlstm_seq(params, x, cfg):
    """The full-sequence pass from the zero state: (y, conv_state, the
    final (C, n, m))."""
    q, k, v, i_raw, f_log, z, conv_state = _mlstm_qkvg(params, x, cfg)
    # q, k, v in the compute dtype: K6 (and the plain version) take bf16 as
    # it is and compute in float32, as the reference's float32 casts do
    h, state = mlstm_ops.mlstm_chunkwise(q, k, v, i_raw, f_log,
                                         chunk=cfg.xlstm.chunk_size)
    return _mlstm_out(params, h, z, cfg, x.dtype), conv_state, state


def mlstm_apply(params, x, cfg):
    return _mlstm_seq(params, x, cfg)[0]


def mlstm_prefill(params, x, cfg, cache_dtype):
    """Full-sequence forward that also returns the decode cache: the conv
    tail and the chunkwise-carried (C, n, m) that :func:`mlstm_apply`
    discards."""
    y, conv_state, (C, n, m) = _mlstm_seq(params, x, cfg)
    return y, {"conv": conv_state.to(cache_dtype), "C": C, "n": n, "m": m}


def mlstm_init_cache(cfg, batch: int, dtype, device=None):
    di, H, hd = _mlstm_dims(cfg)
    dc = cfg.xlstm.conv_kernel
    return {
        "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
        "C": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=F32, device=device),
        "m": torch.zeros((batch, H), dtype=F32, device=device),
    }


def mlstm_decode(params, x, cache, cfg):
    """One token per row. Returns (y, the new cache)."""
    q, k, v, i_raw, f_log, z, conv_state = _mlstm_qkvg(
        params, x, cfg, conv_prev=cache["conv"])
    h, (C, n, m) = mlstm_step(
        q[:, 0].float(), k[:, 0].float(), v[:, 0].float(), i_raw[:, 0],
        f_log[:, 0], (cache["C"], cache["n"], cache["m"]))
    y = _mlstm_out(params, h[:, None], z, cfg, x.dtype)
    return y, {"conv": conv_state.to(cache["conv"].dtype),
               "C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def _slstm_dims(cfg):
    H = cfg.num_heads
    return cfg.d_model, H, cfg.d_model // H


def slstm_init(gen: torch.Generator, cfg):
    pd = dtype_of(cfg.param_dtype)
    d, H, hd = _slstm_dims(cfg)
    df = int(cfg.xlstm.proj_factor_slstm * d)
    dev = gen.device
    return {
        "w_gates": dense_init(gen, (d, 4 * d), d, F32),
        "r_gates": dense_init(gen, (4, H, hd, hd), hd, F32),
        "b_gates": torch.cat([torch.zeros(d), torch.linspace(3.0, 6.0, d),
                              torch.zeros(2 * d)]).to(dev, F32),
        "out_norm": {"scale": torch.ones((d,), dtype=F32, device=dev)},
        "ffn_up": dense_init(gen, (d, df), d, pd),
        "ffn_gate": dense_init(gen, (d, df), d, pd),
        "ffn_down": dense_init(gen, (df, d), df, pd),
    }


def _recurrent(r_gates):
    """(4, H, hd, hd) -> (H, hd, 4 hd): the four gates' recurrent blocks
    of a head side by side, for one product a step."""
    G, H, hd, _ = r_gates.shape
    return r_gates.float().permute(1, 2, 0, 3).reshape(H, hd, G * hd)


def _slstm_step(gx, state, R):
    """One sLSTM step. gx: (B, 4d) float32 input pre-activations; state:
    (c, n, m, h) each (B, d); R: :func:`_recurrent`'s (H, hd, 4 hd)."""
    c0, n0, m0, h0 = state
    B, d = c0.shape
    H, hd = R.shape[:2]
    rec = torch.bmm(h0.reshape(B, H, hd).transpose(0, 1), R)  # (H, B, 4hd)
    rec = rec.reshape(H, B, 4, hd).permute(1, 2, 0, 3).reshape(B, 4, d)
    gi, gf, gz, go = (gx.reshape(B, 4, d) + rec).unbind(dim=1)
    f_log = F.logsigmoid(gf)
    m_t = torch.maximum(f_log + m0, gi)
    wf = torch.exp(f_log + m0 - m_t)
    wi = torch.exp(gi - m_t)
    c = wf * c0 + wi * torch.tanh(gz)
    n = wf * n0 + wi
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return (c, n, m_t, h)


def slstm_cell(gx, state, r_gates):
    """One sLSTM step. gx: (B, 4d) pre-activations from the input path;
    state: (c, n, m, h) each (B, d); block-diagonal recurrent mixing per
    head through r_gates (4, H, hd, hd)."""
    return _slstm_step(gx, state, _recurrent(r_gates))


def _slstm_gx(params, x32):
    return x32 @ params["w_gates"].float() + params["b_gates"]


def slstm_scan(params, x32):
    """x32: (B, S, d) float32 -> h (B, S, d), the final (c, n, m, h)."""
    B, S, d = x32.shape
    gx = _slstm_gx(params, x32)
    R = _recurrent(params["r_gates"])
    state = tuple(x32.new_zeros((B, d)) for _ in range(4))
    hs = []
    for t in range(S):
        state = _slstm_step(gx[:, t], state, R)
        hs.append(state[3])
    return torch.stack(hs, dim=1), state


def _slstm_out(params, h, x, cfg):
    d, H, hd = _slstm_dims(cfg)
    h = _group_norm(h, H, params["out_norm"]["scale"]).to(x.dtype)
    up = h @ params["ffn_up"].to(x.dtype)
    gate = h @ params["ffn_gate"].to(x.dtype)
    return (F.silu(gate) * up) @ params["ffn_down"].to(x.dtype)


def slstm_apply(params, x, cfg):
    h, _ = slstm_scan(params, x.float())
    return _slstm_out(params, h, x, cfg)


def slstm_prefill(params, x, cfg):
    """Full-sequence forward that also returns the decode cache (the
    final (c, n, m, h) of the exact recurrence)."""
    h, (c, n, m, hf) = slstm_scan(params, x.float())
    return _slstm_out(params, h, x, cfg), {"c": c, "n": n, "m": m, "h": hf}


def slstm_init_cache(cfg, batch: int, dtype, device=None):
    d = cfg.d_model
    return {key: torch.zeros((batch, d), dtype=F32, device=device)
            for key in ("c", "n", "m", "h")}


def slstm_decode(params, x, cache, cfg):
    """One token per row. Returns (y, the new cache)."""
    gx = _slstm_gx(params, x.float())
    c, n, m, h = slstm_cell(gx[:, 0], (cache["c"], cache["n"], cache["m"],
                                       cache["h"]), params["r_gates"])
    y = _slstm_out(params, h[:, None], x, cfg)
    return y, {"c": c, "n": n, "m": m, "h": h}
