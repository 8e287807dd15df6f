"""Shape stand-ins and logical axes for every entry point the dry run
traces (the reference's ``launch/input_specs.py``).

No storage is allocated: shapes come from :func:`~repro_torch.models.
transformer.init_params` and :func:`~repro_torch.models.transformer.
init_decode_cache` run on the ``meta`` device (:func:`on_meta`), where a
random draw computes nothing. A leaf of a spec tree is a
:class:`ShapeDtype`; :func:`meta_tree` makes ``meta`` tensors of a spec
tree, which a dry run steps on (:mod:`repro_torch.launch.dryrun`).

    shapes, axes = train_batch_specs(cfg, shape, num_clients)
    batch_specs = tree_specs(axes, shapes, grid)   # build(spec, mesh=grid,
                                                   #       batch_specs=...)
    p_shapes, p_axes = param_specs(cfg, num_clients)
    b_shapes, b_axes = prefill_batch_specs(cfg, shape)
    b_shapes, b_axes, c_shapes, c_axes = decode_batch_specs(cfg, shape)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import dtype_of
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype, with no storage."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class on_meta(TorchDispatchMode):
    """Every op that takes a ``device`` makes its result on ``meta``: a
    model's init, whatever device its generator names, then allocates
    nothing and draws no random number."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if any(a.name == "device" for a in func._schema.arguments):
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def spec_of(tree):
    """The :class:`ShapeDtype` tree of a tensor tree."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), tree)


def meta_tree(specs):
    """``meta`` tensors of a :class:`ShapeDtype` tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def meta_params(cfg: ModelConfig, num_clients: int = 0):
    """The params of ``cfg`` as ``meta`` tensors; ``num_clients > 0``
    stacks the client half over a leading (C, ...) axis (the SCALA
    layout), 0 leaves the merged (serving) layout."""
    with on_meta():
        params = T.init_params(torch.Generator(), cfg)
    if num_clients > 0:
        params["client"] = tree_map(
            lambda t: torch.empty((num_clients,) + tuple(t.shape),
                                  dtype=t.dtype, device="meta"),
            params["client"])
    return params


def _prefix_axes(tree):
    """Every axes leaf (a tuple of names) with ``"client"`` in front."""
    if isinstance(tree, dict):
        return {k: _prefix_axes(v) for k, v in tree.items()}
    return ("client",) + tree


def param_specs(cfg: ModelConfig, num_clients: int = 0):
    """(ShapeDtype tree, logical-axes tree) of the model's params:
    ``num_clients > 0`` the SCALA layout (the client half stacked over
    ``client``), 0 the merged layout."""
    shapes = spec_of(meta_params(cfg, num_clients))
    axes = T.param_axes(cfg)
    if num_clients > 0:
        axes = dict(axes, client=_prefix_axes(axes["client"]))
    return shapes, axes


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
    _frontend_specs(cfg, (C, bk), ("client", "per_client_batch"), specs,
                    axes, ("vision", "audio"))
    return specs, axes


def _frontend_specs(cfg, lead, lead_axes, specs, axes, kinds):
    """Add the encoder embeddings of a frontend arch among ``kinds``."""
    emb = dtype_of(cfg.dtype)
    for kind, key in (("vision", "prefix_emb"), ("audio", "memory_emb")):
        if cfg.frontend == kind and kind in kinds:
            specs[key] = ShapeDtype(lead + (cfg.num_prefix_tokens,
                                            cfg.frontend_dim), emb)
            axes[key] = lead_axes + ("prefix", "frontend")


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape
                        ) -> Tuple[dict, dict]:
    """(shape tree, axes tree) of a prefill batch: (B, S - P) tokens after
    a vision arch's P prefix embeddings, or beside an audio arch's
    memory."""
    B = shape.global_batch
    P = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    specs = {"tokens": ShapeDtype((B, shape.seq_len - P), torch.int32)}
    axes = {"tokens": ("batch", "seq")}
    _frontend_specs(cfg, (B,), ("batch",), specs, axes, ("vision", "audio"))
    return specs, axes


def decode_batch_specs(cfg: ModelConfig, shape: InputShape
                       ) -> Tuple[dict, dict, dict, dict]:
    """(batch shapes, batch axes, cache shapes, cache axes) of one decode
    step of B rows against caches of ``seq_len`` positions."""
    B = shape.global_batch
    specs = {"tokens": ShapeDtype((B, 1), torch.int32)}
    axes = {"tokens": ("batch", "seq")}
    _frontend_specs(cfg, (B,), ("batch",), specs, axes, ("audio",))
    cache = spec_of(T.init_decode_cache(cfg, B, shape.seq_len,
                                        device="meta"))
    return specs, axes, cache, T.cache_axes(cfg)
