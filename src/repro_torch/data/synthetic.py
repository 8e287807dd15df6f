"""Synthetic datasets (the container has no CIFAR download; the paper's
accuracy *ordering* is reproduced on structurally-equivalent synthetics).

* ``gaussian_images`` — CIFAR-shaped 32x32x3 classification with class
  prototypes + structured noise; linearly separable only in deep
  features, so the CNN must actually learn.
* ``token_stream`` — synthetic LM data with per-client skewed unigram
  distributions (Zipf with per-client permutation), the LM analogue of
  label skew used by the transformer SCALA examples.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_images(n: int, num_classes: int = 10, hw: int = 32,
                    channels: int = 3, noise: float = 0.6,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    # low-frequency class prototypes: random 4x4 patterns upsampled
    protos = rng.normal(size=(num_classes, 4, 4, channels)).astype(np.float32)
    protos = protos.repeat(hw // 4, axis=1).repeat(hw // 4, axis=2)
    labels = rng.integers(0, num_classes, size=n)
    x = protos[labels] + noise * rng.normal(
        size=(n, hw, hw, channels)).astype(np.float32)
    # per-sample random contrast/brightness so pixel means aren't trivial cues
    a = rng.uniform(0.8, 1.2, size=(n, 1, 1, 1)).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, size=(n, 1, 1, 1)).astype(np.float32)
    return (x * a + b), labels.astype(np.int64)


def token_stream(n_docs: int, doc_len: int, vocab: int, num_domains: int = 8,
                 zipf_a: float = 1.2, seed: int = 0):
    """Returns tokens (n_docs, doc_len) int32 and domain ids (n_docs,).

    Each domain is a different permutation of a Zipf distribution — the
    per-domain unigram skew that SCALA's logit adjustment targets in the
    LM setting.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base_p = ranks ** -zipf_a
    base_p /= base_p.sum()
    perms = [rng.permutation(vocab) for _ in range(num_domains)]
    domains = rng.integers(0, num_domains, size=n_docs)
    docs = np.empty((n_docs, doc_len), np.int32)
    for d in range(num_domains):
        sel = np.where(domains == d)[0]
        if len(sel) == 0:
            continue
        p = base_p[np.argsort(perms[d])]
        docs[sel] = rng.choice(vocab, size=(len(sel), doc_len), p=p)
    return docs, domains.astype(np.int64)
