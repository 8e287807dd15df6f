"""Federated round-batch assembly.

Implements the paper's round protocol on the host side:
* client sampling (partial participation, rate r),
* eq. (3) minibatch sizing B_k ∝ |D_k| (padded to max B_k with
  zero-weight rows so client batches stack into a (C, B_k, ...) tensor),
* T local-iteration minibatches per round: leaves (T, C, Bk, ...).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.split import client_minibatch_sizes


@dataclass
class FederatedData:
    """Per-client datasets: x[i], y[i] are client i's arrays."""

    xs: List[np.ndarray]
    ys: List[np.ndarray]

    @property
    def num_clients(self) -> int:
        return len(self.xs)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(y) for y in self.ys], np.int64)

    @classmethod
    def from_partition(cls, x, y, parts: Sequence[np.ndarray]):
        return cls(xs=[x[p] for p in parts], ys=[y[p] for p in parts])


def sample_clients(num_clients: int, num_selected: int,
                   rng: np.random.Generator) -> np.ndarray:
    return rng.choice(num_clients, size=num_selected, replace=False)


def round_batches(data: FederatedData, selected: np.ndarray,
                  server_batch: int, local_iters: int,
                  rng: np.random.Generator,
                  x_key: str = "x") -> Dict[str, np.ndarray]:
    """Build one round's batches: {'x': (T,C,Bk,...), 'labels', 'weights'},
    plus 'sizes' (C,) for eq. (10) aggregation."""
    sizes = data.sizes[selected]
    bks = client_minibatch_sizes(sizes, server_batch)
    bk_max = int(bks.max())
    T = local_iters
    C = len(selected)

    x_shape = data.xs[0].shape[1:]
    xs = np.zeros((T, C, bk_max) + x_shape, data.xs[0].dtype)
    ys = np.zeros((T, C, bk_max), np.int32)
    ws = np.zeros((T, C, bk_max), np.float32)

    for ci, k in enumerate(selected):
        xk, yk = data.xs[k], data.ys[k]
        bk = int(bks[ci])
        for t in range(T):
            idx = rng.choice(len(yk), size=bk, replace=len(yk) < bk)
            xs[t, ci, :bk] = xk[idx]
            ys[t, ci, :bk] = yk[idx]
            ws[t, ci, :bk] = 1.0
    return {x_key: xs, "labels": ys, "weights": ws,
            "sizes": sizes.astype(np.float32)}


def lm_round_batches(docs_by_client: List[np.ndarray], selected: np.ndarray,
                     server_batch: int, local_iters: int,
                     rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """LM variant: docs (n_k, L) int32 per client. tokens = doc[:-1],
    labels = doc[1:], next-token prediction."""
    sizes = np.array([len(d) for d in docs_by_client])[selected]
    bks = client_minibatch_sizes(sizes, server_batch)
    bk_max = int(bks.max())
    T, C = local_iters, len(selected)
    L = docs_by_client[0].shape[1]

    toks = np.zeros((T, C, bk_max, L - 1), np.int32)
    labs = np.zeros((T, C, bk_max, L - 1), np.int32)
    ws = np.zeros((T, C, bk_max, L - 1), np.float32)
    for ci, k in enumerate(selected):
        dk = docs_by_client[k]
        bk = int(bks[ci])
        for t in range(T):
            idx = rng.choice(len(dk), size=bk, replace=len(dk) < bk)
            toks[t, ci, :bk] = dk[idx, :-1]
            labs[t, ci, :bk] = dk[idx, 1:]
            ws[t, ci, :bk] = 1.0
    return {"tokens": toks, "labels": labs, "weights": ws,
            "sizes": sizes.astype(np.float32)}
