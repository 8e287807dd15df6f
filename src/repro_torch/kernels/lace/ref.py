"""Materialized-logits oracle for the logit-adjusted cross-entropy (LACE).

Per token i with features f_i, head W (d, V), label y_i, prior row
P[pid_i] and temperature tau (paper eqs. 14/15)::

    z_i   = f_i @ W + tau * log(P[pid_i] + eps)
    nll_i = logsumexp(z_i) - z_i[y_i]
    loss  = sum_i w_i nll_i / sum_i w_i

It builds the whole (N, V) logits, so it exists to check the chunked op
and the kernels, as ``repro/kernels/lace/ref.py`` does for the reference.
"""
from __future__ import annotations

import torch


def lace_ref(feats, w_head, labels, *, prior_rows=None, prior_ids=None,
             tau: float = 1.0, weights=None, eps: float = 1e-8):
    """feats (N, d); w_head (d, V); labels (N,) int; prior_rows (K, V) or
    None; prior_ids (N,) int into prior_rows (None: row 0). Returns the
    float32 scalar loss."""
    z = feats.float() @ w_head.float()
    if prior_rows is not None:
        lp = torch.log(prior_rows.float() + eps)
        z = z + tau * (lp[0] if prior_ids is None else lp[prior_ids])
    nll = (torch.logsumexp(z, dim=-1)
           - z.gather(-1, labels.long()[:, None])[:, 0])
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


def _adjusted(z, adj, ids, rows):
    """z + the side's per-token adjustment (adj (rows, V), ids (N,) or
    None for row 0; no table: z)."""
    if adj is None:
        return z
    return z + (adj[0] if ids is None else adj[ids[rows].long()])


@torch.no_grad()
def lace2_fwd_plain(feats, w_head, labels, adj_s=None, ids_s=None,
                    adj_k=None, ids_k=None, chunk: int = 1024):
    """The plain version of K1 (:func:`repro_torch.kernels.lace.kernel.
    lace2_fwd_cuda`), same arguments: per-token (nll_s, nll_k, lse_s,
    lse_k), (N,) float32, ``chunk`` tokens of logits at a time."""
    w32 = w_head.float()
    outs = [[], [], [], []]
    for i in range(0, feats.shape[0], chunk):
        rows = slice(i, i + chunk)
        z = feats[rows].float() @ w32
        lab = labels[rows].long()[:, None]
        for j, (adj, ids) in enumerate(((adj_s, ids_s), (adj_k, ids_k))):
            zs = _adjusted(z, adj, ids, rows)
            lse = torch.logsumexp(zs, dim=-1)
            outs[j].append(lse - zs.gather(-1, lab)[:, 0])
            outs[2 + j].append(lse)
    return tuple(torch.cat(o) for o in outs)


@torch.no_grad()
def lace2_bwd_plain(feats, w_head, labels, adj_s, ids_s, adj_k, ids_k,
                    lse_s, lse_k, ts_s, ts_k, chunk: int = 1024):
    """The plain version of K2 (:func:`repro_torch.kernels.lace.kernel.
    lace2_bwd_cuda`), same arguments: (df_s, df_k) (N, d) and dW_s (d,
    V), float32. Every f32 sum runs over at most ``chunk`` products --
    dW over token chunks, df over vocab slices -- as the kernel's do, so
    the two round alike and neither sums 151936 terms in one chain."""
    w32 = w_head.float()
    V = w32.shape[1]
    dw = torch.zeros(w32.shape, dtype=torch.float32, device=w32.device)
    df = [[], []]
    for i in range(0, feats.shape[0], chunk):
        rows = slice(i, i + chunk)
        f = feats[rows].float()
        z = f @ w32
        lab = labels[rows].long()[:, None]
        for j, (adj, ids, lse, ts) in enumerate(
                ((adj_s, ids_s, lse_s, ts_s), (adj_k, ids_k, lse_k, ts_k))):
            g = torch.exp(_adjusted(z, adj, ids, rows) - lse[rows, None])
            g.scatter_add_(-1, lab, torch.full_like(lab, -1, dtype=g.dtype))
            g *= ts[rows, None]
            acc = g[:, :chunk] @ w32[:, :chunk].T
            for v in range(chunk, V, chunk):
                acc += g[:, v:v + chunk] @ w32[:, v:v + chunk].T
            df[j].append(acc)
            if j == 0:
                dw += f.T @ g
    return torch.cat(df[0]), torch.cat(df[1]), dw
