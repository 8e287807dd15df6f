"""LACE, the fused dual-prior split boundary: both SCALA losses (eq. 14
with the concatenated prior P_s, eq. 15 with the per-client priors P_k)
and their gradients from one ``feats @ w_head`` product.

:func:`lace2_grads` is the engine's entry point. A CPU tensor gets the
plain chunked version below -- the reference's
``repro/kernels/lace/ops.py:lace2_grads`` on torch ops: the token axis
scanned in chunks of ``chunk``, padded with zero-weight tokens to a
chunk multiple, so no more than (G, chunk, V) logits are live. A CUDA
tensor gets K1 then K2 (:mod:`repro_torch.kernels.lace.kernel`) or an
exception, never the plain version. ``LAUNCHES_FWD`` / ``LAUNCHES_BWD``
count the kernels' launches.

Shapes: feats (G, N, d) -- G groups (SCALA clients), N tokens each;
w_head (d, V); labels / weights (G, N); prior_rows (K, V) with prior_ids
(G,) picking each group's row (None: row 0 for every group).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.lace import kernel

LAUNCHES_FWD = 0
LAUNCHES_BWD = 0


def _pick_chunk(n: int, target: int) -> int:
    """The chunk along the token axis: ``min(n, target)``; a ragged tail
    is padded (:func:`_pad_tokens`), never a smaller chunk."""
    return min(n, target)


def _pad_tokens(c, feats, labels, weights):
    """Pad the token axis to a multiple of ``c`` with weight-0, label-0
    tokens, which add exactly zero to every sum and gradient. Returns
    (feats, labels, weights, n_orig) with ``weights`` materialized."""
    G, N, _ = feats.shape
    if weights is None:
        weights = torch.ones((G, N), dtype=torch.float32, device=feats.device)
    pad = (-N) % c
    if pad:
        feats = F.pad(feats, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        weights = F.pad(weights, (0, pad))
    return feats, labels, weights, N


def _check_args(feats, w_head, labels, prior_rows, prior_ids, weights):
    """Shape validation: a group-axis mismatch (e.g. K-sized prior_ids
    against a cohort of feats) would otherwise broadcast silently."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be (G, N, d), got {tuple(feats.shape)}")
    G, N, d = feats.shape
    if w_head.dim() != 2 or w_head.shape[0] != d:
        raise ValueError(f"w_head must be (d={d}, V), got "
                         f"{tuple(w_head.shape)}")
    if tuple(labels.shape) != (G, N):
        raise ValueError(f"labels must be (G, N)=({G}, {N}), got "
                         f"{tuple(labels.shape)}")
    if weights is not None and tuple(weights.shape) != (G, N):
        raise ValueError(f"weights must be (G, N)=({G}, {N}), got "
                         f"{tuple(weights.shape)}")
    if prior_ids is not None:
        if prior_rows is None:
            raise ValueError("prior_ids given without prior_rows")
        if tuple(prior_ids.shape) != (G,):
            raise ValueError(
                f"prior_ids must be (G,)=({G},), got "
                f"{tuple(prior_ids.shape)} -- gathered-group callers must "
                "gather the prior ids (or rows) alongside the feats")
    if prior_rows is not None and prior_rows.shape[-1] != w_head.shape[1]:
        raise ValueError(f"prior_rows vocab dim {prior_rows.shape[-1]} != "
                         f"head vocab dim {w_head.shape[1]}")


def _check_args2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                 prior_rows_k, prior_ids_k, weights):
    _check_args(feats, w_head, labels, prior_rows_s, prior_ids_s, weights)
    _check_args(feats, w_head, labels, prior_rows_k, prior_ids_k, weights)


def _log_prior(prior_rows, eps):
    return torch.log(prior_rows.float() + eps)


def _prep(feats, prior_rows, prior_ids, weights, eps):
    """(weights, per-group log prior (G, 1, V) or None)."""
    G = feats.shape[0]
    if weights is None:
        weights = torch.ones(feats.shape[:2], dtype=torch.float32,
                             device=feats.device)
    if prior_rows is None:
        return weights, None
    lp_rows = _log_prior(prior_rows, eps)
    lp = (lp_rows[:1].expand(G, -1) if prior_ids is None
          else lp_rows[prior_ids.long()])
    return weights, lp[:, None, :]


def _side_stats(z, l_c):
    """(nll, softmax - onehot) of one side's adjusted logits z (G, c, V),
    in the reference's op order: max shift, exp, sum, log."""
    m = z.amax(dim=-1, keepdim=True)
    ez = torch.exp(z - m)
    se = ez.sum(dim=-1)
    lse = torch.log(se) + m[..., 0]
    idx = l_c.long()[..., None]
    nll = lse - z.gather(-1, idx)[..., 0]
    g = ez / se[..., None]
    g.scatter_add_(-1, idx, torch.full_like(idx, -1, dtype=g.dtype))
    return nll, g


@torch.no_grad()
def lace2_grads_plain(feats, w_head, labels, prior_rows_s, prior_ids_s,
                      prior_rows_k, prior_ids_k, weights, tau, eps, chunk,
                      mean, scale):
    """The plain version of :func:`lace2_grads` on torch ops, on any
    device: what a CPU tensor gets, and the kernels' yardstick."""
    G, N0, d = feats.shape
    V = w_head.shape[1]
    c = _pick_chunk(N0, chunk)
    feats_p, labels_p, weights_p, _ = _pad_tokens(c, feats, labels, weights)
    N = feats_p.shape[1]
    w, lp_s = _prep(feats_p, prior_rows_s, prior_ids_s, weights_p, eps)
    _, lp_k = _prep(feats_p, prior_rows_k, prior_ids_k, weights_p, eps)
    chunks = range(0, N, c)
    w_sum = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in chunks:                            # chunk-ordered, as scanned
        w_sum = w_sum + w[:, i:i + c].sum()
    if scale is None:
        one = torch.ones((), dtype=torch.float32, device=feats.device)
        scale = one / torch.clamp(w_sum, min=1e-8) if mean else one
    w32 = w_head.float()
    nll_s_sum = torch.zeros((), dtype=torch.float32, device=feats.device)
    nll_k_sum = nll_s_sum.clone()
    dw = torch.zeros((d, V), dtype=torch.float32, device=feats.device)
    df_s, df_k = [], []
    for i in chunks:
        f_c = feats_p[:, i:i + c].float()
        l_c = labels_p[:, i:i + c]
        w_c = w[:, i:i + c]
        z = f_c @ w32                            # ONE product per chunk
        nll_s, g_s = _side_stats(z if lp_s is None else z + tau * lp_s, l_c)
        nll_k, g_k = _side_stats(z if lp_k is None else z + tau * lp_k, l_c)
        g_s = g_s * (w_c * scale)[..., None]
        g_k = g_k * (w_c * scale)[..., None]
        df_s.append(g_s @ w32.T)
        df_k.append(g_k @ w32.T)
        dw = dw + torch.einsum("gcd,gcv->dv", f_c, g_s)
        nll_s_sum = nll_s_sum + (nll_s * w_c).sum()
        nll_k_sum = nll_k_sum + (nll_k * w_c).sum()
    unchunk = lambda parts: torch.cat(parts, 1)[:, :N0].to(feats.dtype)
    if mean:
        den = torch.clamp(w_sum, min=1e-8)
        out_s, out_k = nll_s_sum / den, nll_k_sum / den
    else:
        out_s, out_k = nll_s_sum, nll_k_sum
    return (out_s, out_k, unchunk(df_s), unchunk(df_k),
            dw.to(w_head.dtype), w_sum)


def _side_table(prior_rows, prior_ids, tau, eps, G, N):
    """A side's (rows, V) table of tau * log(P + eps) and its per-token
    row ids (None: row 0), for the kernels."""
    if prior_rows is None:
        return None, None
    adj = (tau * _log_prior(prior_rows, eps)).contiguous()
    if prior_ids is None:
        return adj, None
    return adj, prior_ids.to(torch.int32).repeat_interleave(N).contiguous()


def _lace2_grads_cuda(feats, w_head, labels, prior_rows_s, prior_ids_s,
                      prior_rows_k, prior_ids_k, weights, tau, eps, mean,
                      scale):
    global LAUNCHES_FWD, LAUNCHES_BWD
    G, N, d = feats.shape
    f2 = feats.reshape(G * N, d)
    lab = labels.reshape(-1).to(torch.int32).contiguous()
    w = (torch.ones(G * N, dtype=torch.float32, device=feats.device)
         if weights is None else weights.reshape(-1).float())
    adj_s, ids_s = _side_table(prior_rows_s, prior_ids_s, tau, eps, G, N)
    adj_k, ids_k = _side_table(prior_rows_k, prior_ids_k, tau, eps, G, N)
    w_sum = w.sum()
    if scale is None:
        one = torch.ones((), dtype=torch.float32, device=feats.device)
        scale = one / torch.clamp(w_sum, min=1e-8) if mean else one
    nll_s, nll_k, lse_s, lse_k = kernel.lace2_fwd_cuda(
        f2, w_head, lab, adj_s, ids_s, adj_k, ids_k)
    LAUNCHES_FWD += 1
    ts = (w * scale).contiguous()
    df_s, df_k, dw = kernel.lace2_bwd_cuda(f2, w_head, lab, adj_s, ids_s,
                                           adj_k, ids_k, lse_s, lse_k, ts,
                                           ts)
    LAUNCHES_BWD += 1
    out_s, out_k = (nll_s * w).sum(), (nll_k * w).sum()
    if mean:
        den = torch.clamp(w_sum, min=1e-8)
        out_s, out_k = out_s / den, out_k / den
    return (out_s, out_k, df_s.view(G, N, d).to(feats.dtype),
            df_k.view(G, N, d).to(feats.dtype), dw.to(w_head.dtype), w_sum)


@torch.no_grad()
def lace2_grads(feats, w_head, labels, prior_rows_s, prior_ids_s,
                prior_rows_k, prior_ids_k, weights,
                tau: float = 1.0, eps: float = 1e-8, chunk: int = 4096,
                mean: bool = True, scale: Optional[torch.Tensor] = None):
    """Values and gradients of the split boundary in one pass.

    Returns ``(out_s, out_k, df_s, df_k, dw_s, w_sum)``: the eq. 14 /
    eq. 15 losses (weighted means, or raw weighted sums with
    ``mean=False``), d out_side / d feats (in feats' dtype), d out_s /
    d w_head (server side only; in w_head's dtype) and the weight sum.
    With ``mean=True`` the per-token scale is ``1 / max(w_sum, 1e-8)``;
    ``scale`` overrides it for both sides. Either prior may be None
    (plain CE on that side). ``chunk`` bounds the plain version's live
    logits; the kernels tile on their own.
    """
    _check_args2(feats, w_head, labels, prior_rows_s, prior_ids_s,
                 prior_rows_k, prior_ids_k, weights)
    kinds = {t.device.type for t in (feats, w_head, labels)}
    if kinds == {"cpu"}:
        return lace2_grads_plain(feats, w_head, labels, prior_rows_s,
                                  prior_ids_s, prior_rows_k, prior_ids_k,
                                  weights, tau, eps, chunk, mean, scale)
    if kinds == {"cuda"}:
        return _lace2_grads_cuda(feats, w_head, labels, prior_rows_s,
                                 prior_ids_s, prior_rows_k, prior_ids_k,
                                 weights, tau, eps, mean, scale)
    raise ValueError(f"lace2_grads takes CPU or CUDA tensors on one device, "
                     f"got {sorted(kinds)}")
