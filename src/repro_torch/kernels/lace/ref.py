"""Materialized-logits oracle for the logit-adjusted cross-entropy (LACE).

Per token i with features f_i, head W (d, V), label y_i, prior row
P[pid_i] and temperature tau (paper eqs. 14/15)::

    z_i   = f_i @ W + tau * log(P[pid_i] + eps)
    nll_i = logsumexp(z_i) - z_i[y_i]
    loss  = sum_i w_i nll_i / sum_i w_i

It builds the whole (N, V) logits, so it exists to check the chunked op
and the kernels, as ``repro/kernels/lace/ref.py`` does for the reference.
Below it, the plain versions of the kernels K1/K2 (``lace2_*_plain``) and
K4/K5 (``lace_*_plain``) in the kernels' own signatures -- a (rows, V)
table of tau * log(P + eps) and per-token row ids -- which the kernels
are held against on the card.
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


def _fwd_sides(feats, w_head, labels, sides, chunk):
    """Per side (adj, ids): (nll, lse), (N,) float32, ``chunk`` tokens of
    logits at a time, one product shared by the sides."""
    w32 = w_head.float()
    outs = [([], []) for _ in sides]
    for i in range(0, feats.shape[0], chunk):
        rows = slice(i, i + chunk)
        z = feats[rows].float() @ w32
        lab = labels[rows].long()[:, None]
        for (adj, ids), (nll, lses) in zip(sides, outs):
            zs = _adjusted(z, adj, ids, rows)
            lse = torch.logsumexp(zs, dim=-1)
            nll.append(lse - zs.gather(-1, lab)[:, 0])
            lses.append(lse)
    return [(torch.cat(nll), torch.cat(lses)) for nll, lses in outs]


def _bwd_sides(feats, w_head, labels, sides, want_dw, chunk):
    """Per side (adj, ids, lse, ts): df (N, d) float32; and dW (d, V)
    float32 of the first side, or None without ``want_dw``. Every f32 sum
    runs over at most ``chunk`` products -- dW over token chunks, df over
    vocab slices -- as the kernels' do, so the two round alike and
    neither sums 151936 terms in one chain."""
    w32 = w_head.float()
    V = w32.shape[1]
    dw = (torch.zeros(w32.shape, dtype=torch.float32, device=w32.device)
          if want_dw else None)
    df = [[] for _ in sides]
    for i in range(0, feats.shape[0], chunk):
        rows = slice(i, i + chunk)
        f = feats[rows].float()
        z = f @ w32
        lab = labels[rows].long()[:, None]
        for j, (adj, ids, lse, ts) in enumerate(sides):
            g = torch.exp(_adjusted(z, adj, ids, rows) - lse[rows, None])
            g.scatter_add_(-1, lab, torch.full_like(lab, -1, dtype=g.dtype))
            g *= ts[rows, None]
            acc = g[:, :chunk] @ w32[:, :chunk].T
            for v in range(chunk, V, chunk):
                acc += g[:, v:v + chunk] @ w32[:, v:v + chunk].T
            df[j].append(acc)
            if j == 0 and want_dw:
                dw += f.T @ g
    return [torch.cat(parts) for parts in df], dw


@torch.no_grad()
def lace2_fwd_plain(feats, w_head, labels, adj_s=None, ids_s=None,
                    adj_k=None, ids_k=None, chunk: int = 1024):
    """The plain version of K1 (:func:`repro_torch.kernels.lace.kernel.
    lace2_fwd_cuda`), same arguments: per-token (nll_s, nll_k, lse_s,
    lse_k), (N,) float32."""
    (nll_s, lse_s), (nll_k, lse_k) = _fwd_sides(
        feats, w_head, labels, [(adj_s, ids_s), (adj_k, ids_k)], chunk)
    return nll_s, nll_k, lse_s, lse_k


@torch.no_grad()
def lace2_bwd_plain(feats, w_head, labels, adj_s, ids_s, adj_k, ids_k,
                    lse_s, lse_k, ts_s, ts_k, chunk: int = 1024):
    """The plain version of K2 (:func:`repro_torch.kernels.lace.kernel.
    lace2_bwd_cuda`), same arguments: (df_s, df_k) (N, d) and dW_s (d,
    V), float32, summed in the kernel's slices (:func:`_bwd_sides`)."""
    (df_s, df_k), dw = _bwd_sides(
        feats, w_head, labels,
        [(adj_s, ids_s, lse_s, ts_s), (adj_k, ids_k, lse_k, ts_k)], True,
        chunk)
    return df_s, df_k, dw


@torch.no_grad()
def lace_fwd_plain(feats, w_head, labels, adj=None, ids=None,
                   chunk: int = 1024):
    """The plain version of K4 (:func:`repro_torch.kernels.lace.kernel.
    lace_fwd_cuda`), same arguments: per-token (nll, lse), (N,)
    float32."""
    ((nll, lse),) = _fwd_sides(feats, w_head, labels, [(adj, ids)], chunk)
    return nll, lse


@torch.no_grad()
def lace_bwd_plain(feats, w_head, labels, adj, ids, lse, ts,
                   want_dw: bool = True, chunk: int = 1024):
    """The plain version of K5 (:func:`repro_torch.kernels.lace.kernel.
    lace_bwd_cuda`), same arguments: df (N, d) float32 and dW (d, V)
    float32 or None, summed in the kernel's slices (:func:`_bwd_sides`)."""
    (df,), dw = _bwd_sides(feats, w_head, labels, [(adj, ids, lse, ts)],
                           want_dw, chunk)
    return df, dw
