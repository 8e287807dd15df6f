"""Client-model stacking and FedAvg aggregation (eqs. 3, 10).

The client halves of the participating clients are one tree whose
leaves carry a leading client axis (C, ...), as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map


def stack_client_params(client_params, num_clients: int):
    """One client tree repeated over a leading (C, ...) axis: every
    client starts a round from the aggregated model. The slots share
    memory (an expanded view); updates write new tensors."""
    return tree_map(lambda a: a[None].expand((num_clients,) + a.shape),
                    client_params)


def normalize_client_weights(weights, mask=None, eps: float = 1e-8):
    """(C,) raw non-negative weights (and an optional 0/1 mask) -> (C,)
    weights summing to 1, without NaNs: a zero masked total falls back to
    uniform over the participants, or over everyone."""
    w = weights.float()
    C = w.shape[0]
    if mask is not None:
        w = w * mask.float()
    total = w.sum()
    if mask is None:
        fallback = torch.full_like(w, 1.0 / C)
    else:
        m = mask.float()
        msum = m.sum()
        fallback = torch.where(msum > 0, m / torch.clamp(msum, min=1.0),
                               torch.full_like(w, 1.0 / C))
    return torch.where(total > 0, w / torch.clamp(total, min=eps), fallback)


def weighted_mean(stacked_params, weights):
    """Weighted sum over the leading client axis; ``weights`` (C,) must
    already be normalized."""

    def avg(a):
        wb = weights.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        return (a * wb).sum(0)

    return tree_map(avg, stacked_params)


def fedavg(stacked_params, data_sizes=None):
    """eq. (10): the (data-size weighted) mean over the client axis."""
    if data_sizes is None:
        return tree_map(lambda a: a.mean(0), stacked_params)
    return weighted_mean(stacked_params, normalize_client_weights(data_sizes))


def redistribute(stacked_params, data_sizes=None):
    """FedAvg, then broadcast back to every client slot."""
    C = leaves(stacked_params)[0].shape[0]
    return stack_client_params(fedavg(stacked_params, data_sizes), C)


def client_minibatch_sizes(data_sizes, server_batch: int):
    """eq. (3): B_k = |D_k| * B / sum |D_k| (integer, >= 1)."""
    d = np.asarray(data_sizes, dtype=np.float64)
    return np.maximum(1, np.floor(d * server_batch / d.sum())).astype(int)
