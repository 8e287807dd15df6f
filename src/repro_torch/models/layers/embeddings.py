"""Token embeddings, learned positions and the output head."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, dtype_of, embed_init


def embedding_init(gen: torch.Generator, cfg):
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model),
                           dtype_of(cfg.param_dtype))}
    if cfg.pos_embed == "learned":
        p["pos"] = embed_init(gen, (cfg.max_position, cfg.d_model),
                              dtype_of(cfg.param_dtype))
    return p


def embedding_axes(cfg):
    a = {"tok": ("vocab", "embed")}
    if cfg.pos_embed == "learned":
        a["pos"] = ("position", "embed")
    return a


def embedding_apply(params, tokens: torch.Tensor, cfg, positions=None):
    """The tokens' rows in the compute dtype; with learned positions, plus
    the ``pos`` rows at ``positions`` (broadcast against ``tokens``)."""
    # F.embedding, not indexing: its backward sums the rows of a repeated
    # token in a fixed order (indexing's accumulating put does not on a
    # multi-threaded CPU), so a resumed run stays bitwise on its path
    x = F.embedding(tokens, params["tok"]).to(dtype_of(cfg.dtype))
    if cfg.pos_embed == "learned":
        if positions is None:
            raise ValueError("learned positions need the tokens' positions")
        x = x + F.embedding(positions, params["pos"]).to(x.dtype)
    return x


def head_init(gen: torch.Generator, cfg):
    # Tied embeddings are deliberately *untied*, as in the reference:
    # SCALA keeps the embedding on the clients and the classifier head on
    # the server, and a tie would cross the split's privacy boundary.
    return {"out": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                              cfg.d_model, dtype_of(cfg.param_dtype))}


def head_axes(cfg):
    return {"out": ("embed", "vocab")}


def head_apply(params, x: torch.Tensor, cfg):
    return x @ params["out"].to(x.dtype)
