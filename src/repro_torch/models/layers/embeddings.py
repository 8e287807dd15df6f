"""Token embeddings and the output head."""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init, dtype_of, embed_init


def embedding_init(gen: torch.Generator, cfg):
    return {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model),
                              dtype_of(cfg.param_dtype))}


def embedding_apply(params, tokens: torch.Tensor, cfg):
    return params["tok"][tokens].to(dtype_of(cfg.dtype))


def head_init(gen: torch.Generator, cfg):
    # Tied embeddings are deliberately *untied*, as in the reference:
    # SCALA keeps the embedding on the clients and the classifier head on
    # the server, and a tie would cross the split's privacy boundary.
    return {"out": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                              cfg.d_model, dtype_of(cfg.param_dtype))}


def head_apply(params, x: torch.Tensor, cfg):
    return x @ params["out"].to(x.dtype)
