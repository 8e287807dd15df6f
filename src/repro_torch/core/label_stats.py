"""Label-distribution statistics: P_k(y) per client, P_s(y) concatenated.

The server receives each client's labels with its activations and forms
the concatenated distribution P_s (eq. 14) and the per-client
distributions P_k (eq. 15). Histograms are scatter-adds, so no one-hot
(tokens, classes) tensor is ever built.
"""
from __future__ import annotations

import torch


def histogram(labels, num_classes: int, weights=None):
    """float32 counts (num_classes,) of ``labels`` (any shape), each label
    counted with its weight; labels outside [0, num_classes) count 0."""
    flat = labels.reshape(-1)
    if weights is None:
        w = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    else:
        w = torch.broadcast_to(weights, labels.shape).reshape(-1).float()
    valid = (flat >= 0) & (flat < num_classes)
    idx = flat.clamp(0, num_classes - 1).long()
    return torch.zeros(num_classes, dtype=torch.float32,
                       device=flat.device).index_add_(
        0, idx, torch.where(valid, w, torch.zeros_like(w)))


def prior(counts, eps: float = 1e-8):
    """Normalized counts P(y); all-zero counts give the uniform prior."""
    total = counts.sum(-1, keepdim=True)
    n = counts.shape[-1]
    p = counts / torch.clamp(total, min=eps)
    return torch.where(total > 0, p, torch.full_like(counts, 1.0 / n))


def client_and_concat_priors(labels, num_classes: int, weights=None,
                             eps: float = 1e-8):
    """labels (C, ...) per client -> (P_k (C, N), P_s (N,)).

    P_s is the *concatenated* distribution (eqs. 5-6): the histogram of
    the union batch -- the sum of the client histograms, not the mean of
    the client priors. Zero-weight labels (padding rows, absent clients)
    add nothing to either.
    """
    C = labels.shape[0]
    counts = torch.stack([
        histogram(labels[c], num_classes,
                  None if weights is None else weights[c])
        for c in range(C)])
    return prior(counts, eps), prior(counts.sum(0), eps)
