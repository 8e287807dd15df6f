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
K6 on a CUDA tensor, its plain version on a CPU one, and under autograd
K6's backward (or its plain version), which recomputes the chunk states
where the reference's autodiff keeps them at square-root remat. Decode
runs the exact per-step recurrence (:func:`mlstm_step`).

sLSTM mixes its hidden state back through a block-diagonal matrix per
head, so its scan is sequential: a loop over time, one batched product
and a dozen elementwise PyTorch calls a step (:func:`_slstm_loop`),
under autograd with its backward written out (:class:`SLSTMScan`). The
input side of every gate is one product over the sequence.

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


def mlstm_axes(cfg):
    return {
        "up": ("embed", "inner"),
        "conv_w": ("conv_k", "inner"),
        "conv_b": ("inner",),
        "wq": ("heads", "head_dim", "head_dim_alt"),
        "wk": ("heads", "head_dim", "head_dim_alt"),
        "wv": ("heads", "head_dim", "head_dim_alt"),
        "w_gates": ("inner", "gates"),
        "b_gates": ("gates",),
        "out_norm": {"scale": ("inner",)},
        "down": ("inner", "embed"),
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


def mlstm_cache_axes():
    return {
        "conv": ("cache_batch", "conv_k", "inner"),
        "C": ("cache_batch", "heads", "head_dim", "head_dim_alt"),
        "n": ("cache_batch", "heads", "head_dim"),
        "m": ("cache_batch", "heads"),
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


def slstm_axes(cfg):
    return {
        "w_gates": ("embed", "gates"),
        "r_gates": ("gate_kind", "heads", "head_dim", "head_dim_alt"),
        "b_gates": ("gates",),
        "out_norm": {"scale": ("embed",)},
        "ffn_up": ("embed", "ffn"),
        "ffn_gate": ("embed", "ffn"),
        "ffn_down": ("ffn", "embed"),
    }


def _recurrent(r_gates):
    """(4, H, hd, hd) -> (H, hd, 4 hd): the four gates' recurrent blocks
    of a head side by side, for one product a step."""
    G, H, hd, _ = r_gates.shape
    return r_gates.float().permute(1, 2, 0, 3).reshape(H, hd, G * hd)


def _cell(gi, gf, gz, go, state, keep=False):
    """The elementwise part of one sLSTM step, in any layout the gates and
    the state (c, n, m, h) share. ``keep``: also return what
    :class:`SLSTMScan`'s backward reads."""
    c0, n0, m0, _ = state
    f_log = F.logsigmoid(gf)
    fm = f_log + m0
    m_t = torch.maximum(fm, gi)
    wf = torch.exp(fm - m_t)
    wi = torch.exp(gi - m_t)
    z = torch.tanh(gz)
    c = torch.addcmul(wf * c0, wi, z)
    n = torch.addcmul(wi, wf, n0)
    o = torch.sigmoid(go)
    h = o * c / torch.clamp(n, min=1e-6)
    if not keep:
        return (c, n, m_t, h)
    return (c, n, m_t, h), dict(c=c, n=n, wf=wf, wi=wi, z=z, o=o,
                                sg=torch.exp(f_log - gf),  # sigmoid(-gf)
                                sel=fm >= gi)


def _slstm_step(gx, state, R):
    """One sLSTM step. gx: (B, 4d) float32 input pre-activations; state:
    (c, n, m, h) each (B, d); R: :func:`_recurrent`'s (H, hd, 4 hd)."""
    B, d = state[0].shape
    H, hd = R.shape[:2]
    rec = torch.bmm(state[3].reshape(B, H, hd).transpose(0, 1), R)
    rec = rec.reshape(H, B, 4, hd).permute(1, 2, 0, 3).reshape(B, 4, d)
    return _cell(*(gx.reshape(B, 4, d) + rec).unbind(dim=1), state)


def slstm_cell(gx, state, r_gates):
    """One sLSTM step. gx: (B, 4d) pre-activations from the input path;
    state: (c, n, m, h) each (B, d); block-diagonal recurrent mixing per
    head through r_gates (4, H, hd, hd)."""
    return _slstm_step(gx, state, _recurrent(r_gates))


def _slstm_gx(params, x32):
    return x32 @ params["w_gates"].float() + params["b_gates"]


def _slstm_loop(gx, R, keep=None):
    """The recurrence over gx (B, S, 4d) from the zero state: (h (B, S,
    d), the final (c, n, m, h) each (B, d)). The steps run head-major, (H,
    B, ...): one batched product a step gives every head's four gates
    with gx already added. ``keep``: a dict that gets, stacked over the
    steps, what :class:`SLSTMScan`'s backward reads."""
    B, S, _ = gx.shape
    H, hd = R.shape[:2]
    gxh = gx.reshape(B, S, 4, H, hd).permute(1, 3, 0, 2, 4) \
        .reshape(S, H, B, 4 * hd)
    state = tuple(gx.new_zeros((H, B, hd)) for _ in range(4))
    hs, saved = [], {}
    for t in range(S):
        gates = torch.baddbmm(gxh[t], state[3], R).chunk(4, dim=-1)
        if keep is None:
            state = _cell(*gates, state)
        else:
            state, inner = _cell(*gates, state, keep=True)
            for key, value in inner.items():
                saved.setdefault(key, []).append(value)
        hs.append(state[3])
    if keep is not None:
        keep.update((key, torch.stack(v)) for key, v in saved.items())
    return (_unheads(torch.stack(hs), 1),
            tuple(x.transpose(0, 1).reshape(B, H * hd) for x in state))


def _unheads(x, G):
    """(S, H, B, G * hd) -> (B, S, G * H * hd): the loop's layout back to
    the sequence's, G gates side by side."""
    S, H, B, Ghd = x.shape
    return x.reshape(S, H, B, G, Ghd // G).permute(2, 0, 3, 1, 4) \
        .reshape(B, S, Ghd * H)


class SLSTMScan(torch.autograd.Function):
    """h, c, n, m = SLSTMScan.apply(gx (B, S, 4d), R (H, hd, 4hd)),
    float32: the sLSTM recurrence from the zero state, with the final (c,
    n, m), and a backward written out for h. The
    forward loop runs without autograd's recording and keeps, per step,
    the gates' values (wf, wi, tanh z, sigmoid o, sigmoid(-gf)), which
    branch of m's max was taken, and c, n; the backward walks the steps in
    reverse with every op's exact derivative (m's max included) and forms
    dR = sum_t h_{t-1}^T drec_t as one product at the end. Autograd of the
    loop gives the same function at several times the host's time: a node
    a PyTorch call, and a full-size gradient buffer for every step's slice
    of gx."""

    @staticmethod
    def forward(ctx, gx, R):
        keep = {}
        h, (c, n, m, _) = _slstm_loop(gx, R, keep)
        ctx.save_for_backward(R, h, *(keep[k] for k in _KEPT))
        ctx.set_materialize_grads(False)
        return h, c, n, m

    @staticmethod
    def backward(ctx, dh_out, *d_final):
        if dh_out is None or any(g is not None for g in d_final):
            raise NotImplementedError(
                "the sLSTM scan's backward takes the cotangent of h only; "
                "the final state's is not carried")
        R, h, *kept = ctx.saved_tensors
        k = dict(zip(_KEPT, kept))
        S, H, B, hd = k["c"].shape
        Rt = R.transpose(1, 2)
        dho = dh_out.reshape(B, S, H, hd).permute(1, 2, 0, 3)
        zero = dh_out.new_zeros((H, B, hd))
        dh, dc, dn, dm = zero, zero, zero, zero
        dpre = [None] * S
        for t in reversed(range(S)):
            c, n, wf, wi = k["c"][t], k["n"][t], k["wf"][t], k["wi"][t]
            z, o, sg, sel = k["z"][t], k["o"][t], k["sg"][t], k["sel"][t]
            c0 = k["c"][t - 1] if t else zero
            n0 = k["n"][t - 1] if t else zero
            dh = dh + dho[t]
            nc = torch.clamp(n, min=1e-6)
            # h = o c / max(n, 1e-6)
            dgo = dh * c / nc * o * (1 - o)
            dc = dc + dh * o / nc
            dn = dn + torch.where(n >= 1e-6, -dh * o * c / (nc * nc), 0.0)
            # c = wf c0 + wi z, n = wf n0 + wi
            a = (dc * c0 + dn * n0) * wf       # of log wf = f_log + m0 - m
            b = (dc * z + dn) * wi             # of log wi = gi - m
            dgz = dc * wi * (1 - z * z)
            dc, dn = dc * wf, dn * wf
            # m = max(f_log + m0, gi)
            dmt = dm - a - b
            d_first = torch.where(sel, dmt, 0.0)
            dm = a + d_first                   # of m0, the step before's m
            dgi = b + (dmt - d_first)
            dgf = dm * sg                      # f_log = logsigmoid(gf)
            dpre[t] = torch.cat([dgi, dgf, dgz, dgo], dim=-1)
            dh = torch.bmm(dpre[t], Rt)
        dpre = torch.stack(dpre)                          # (S, H, B, 4hd)
        # dR: h_{t-1} (zero before the first step) against dpre_t
        h_prev = torch.cat([zero[None], h.reshape(B, S, H, hd)
                            .permute(1, 2, 0, 3)[:-1]])
        dR = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(H, hd, S * B),
                       dpre.transpose(0, 1).reshape(H, S * B, 4 * hd))
        return _unheads(dpre, 4), dR


_KEPT = ("c", "n", "wf", "wi", "z", "o", "sg", "sel")


def slstm_scan(params, x32):
    """x32: (B, S, d) float32 -> h (B, S, d), the final (c, n, m, h).
    Under autograd through :class:`SLSTMScan` (a gradient of the final c,
    n, m raises: training reads h only)."""
    gx = _slstm_gx(params, x32)
    R = _recurrent(params["r_gates"])
    if torch.is_grad_enabled() and (gx.requires_grad or R.requires_grad):
        h, c, n, m = SLSTMScan.apply(gx, R)
        return h, (c, n, m, h[:, -1])
    return _slstm_loop(gx, R)


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


def slstm_cache_axes():
    return {k: ("cache_batch", "embed") for k in ("c", "n", "m", "h")}


def slstm_decode(params, x, cache, cfg):
    """One token per row. Returns (y, the new cache)."""
    gx = _slstm_gx(params, x.float())
    c, n, m, h = slstm_cell(gx[:, 0], (cache["c"], cache["n"], cache["m"],
                                       cache["h"]), params["r_gates"])
    y = _slstm_out(params, h[:, None], x, cfg)
    return y, {"c": c, "n": n, "m": m, "h": h}
