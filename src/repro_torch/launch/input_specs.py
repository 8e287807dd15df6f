"""The shapes and logical axes of a SCALA training batch, for laying one
out over a :class:`repro_torch.sharding.Grid` (the reference's
``launch/input_specs.py:train_batch_specs``; the port needs no more of
that module).

    shapes, axes = train_batch_specs(cfg, shape, num_clients)
    batch_specs = tree_specs(axes, shapes, grid)   # build(spec, mesh=grid,
                                                   #       batch_specs=...)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.common import dtype_of


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype, with no storage."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      num_clients: int) -> Tuple[dict, dict]:
    """(shape tree, logical-axes tree) of one SCALA local step's batch:
    (C, B_k, S) tokens, labels and weights (labels over the whole prefix
    + text sequence, the prefix positions weighted 0), plus the frontend
    embeddings of a vision or audio arch."""
    C = num_clients
    if shape.global_batch % C:
        raise ValueError(f"global batch {shape.global_batch} of "
                         f"{shape.name!r} does not divide over {C} clients")
    bk = shape.global_batch // C
    P = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    text = shape.seq_len - P
    if text <= 0:
        raise ValueError(f"sequence {shape.seq_len} leaves no text after "
                         f"{P} prefix tokens")
    specs = {
        "tokens": ShapeDtype((C, bk, text), torch.int32),
        "labels": ShapeDtype((C, bk, shape.seq_len), torch.int32),
        "weights": ShapeDtype((C, bk, shape.seq_len), torch.float32),
    }
    row = ("client", "per_client_batch", "seq")
    axes = {"tokens": row, "labels": row, "weights": row}
    emb = dtype_of(cfg.dtype)
    for kind, key in (("vision", "prefix_emb"), ("audio", "memory_emb")):
        if cfg.frontend == kind:
            specs[key] = ShapeDtype((C, bk, cfg.num_prefix_tokens,
                                     cfg.frontend_dim), emb)
            axes[key] = ("client", "per_client_batch", "prefix", "frontend")
    return specs, axes
