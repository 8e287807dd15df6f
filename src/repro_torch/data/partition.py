"""Label-skew partitioners (paper §5.1).

* quantity-based skew (α): data of each label is divided into K·α/N
  portions; each client receives α randomly-assigned portions, so each
  client holds at most α classes (missing classes when α < N).
* distribution-based skew (β): p_k ~ Dir_N(β); client k receives a
  fraction p_{k,y} of the samples of class y.

Host-side numpy; returns per-client index arrays.
"""
from __future__ import annotations

from typing import List

import numpy as np


def quantity_skew(labels: np.ndarray, num_clients: int, alpha: int,
                  num_classes: int, rng: np.random.Generator) -> List[np.ndarray]:
    total_portions = num_clients * alpha
    per_class = max(1, total_portions // num_classes)

    # chop each class into `per_class` portions
    portions = []
    for y in range(num_classes):
        idx = rng.permutation(np.where(labels == y)[0])
        if len(idx) == 0:
            continue
        for chunk in np.array_split(idx, per_class):
            if len(chunk):
                portions.append(chunk)
    rng.shuffle(portions)

    clients: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for i, portion in enumerate(portions[: num_clients * alpha]):
        clients[i % num_clients].append(portion)
    out = []
    for parts in clients:
        if parts:
            out.append(np.concatenate(parts))
        else:  # degenerate fallback: give an empty client one random sample
            out.append(rng.choice(len(labels), size=1))
    return out


def dirichlet_skew(labels: np.ndarray, num_clients: int, beta: float,
                   num_classes: int, rng: np.random.Generator,
                   min_size: int = 2) -> List[np.ndarray]:
    n = len(labels)
    for _ in range(100):
        idx_clients: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
        for y in range(num_classes):
            idx = rng.permutation(np.where(labels == y)[0])
            if len(idx) == 0:
                continue
            p = rng.dirichlet(np.full(num_clients, beta))
            cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            for k, chunk in enumerate(np.split(idx, cuts)):
                if len(chunk):
                    idx_clients[k].append(chunk)
        sizes = [sum(len(c) for c in parts) for parts in idx_clients]
        if min(sizes) >= min_size:
            break
    out = []
    for parts in idx_clients:
        if parts:
            out.append(np.concatenate(parts))
        else:
            out.append(rng.choice(n, size=min_size))
    return out


def partition(labels: np.ndarray, num_clients: int, *, alpha: int = None,
              beta: float = None, num_classes: int = None,
              seed: int = 0) -> List[np.ndarray]:
    """Dispatch on (alpha | beta) — exactly one must be given."""
    if (alpha is None) == (beta is None):
        raise ValueError("give exactly one of alpha/beta")
    num_classes = num_classes or int(labels.max()) + 1
    rng = np.random.default_rng(seed)
    if alpha is not None:
        return quantity_skew(labels, num_clients, alpha, num_classes, rng)
    return dirichlet_skew(labels, num_clients, beta, num_classes, rng)
