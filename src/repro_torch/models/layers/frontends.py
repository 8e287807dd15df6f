"""The modality frontends' projector (the encoders are stubs, as in the
reference): callers supply pre-computed patch embeddings (vision,
``prefix_emb``) or encoder frames (audio, ``memory_emb``), and the
projector maps them into d_model. The vision prefix goes before the text;
the audio memory is cross-attended by every layer
(:mod:`repro_torch.models.blocks`)."""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init, dtype_of, gelu
from repro_torch.models.layers import norms


def projector_init(gen: torch.Generator, cfg):
    """Two-layer MLP projector (InternVL-style) frontend_dim -> d_model."""
    pd = dtype_of(cfg.param_dtype)
    return {
        "norm": norms.layer_norm_init(cfg.frontend_dim, gen.device),
        "fc1": dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                          cfg.frontend_dim, pd),
        "fc2": dense_init(gen, (cfg.d_model, cfg.d_model), cfg.d_model, pd),
    }


def projector_axes(cfg):
    return {
        "norm": norms.layer_norm_axes(),
        "fc1": ("frontend", "embed"),
        "fc2": ("embed", "embed_alt"),
    }


def projector_apply(params, emb, cfg):
    """emb: (B, P, frontend_dim) -> (B, P, d_model): the layer norm in
    float32, then fc1, tanh-gelu and fc2 in the compute dtype."""
    x = norms.layer_norm_apply(params["norm"], emb.float())
    x = x.to(dtype_of(cfg.dtype))
    x = gelu(x @ params["fc1"].to(x.dtype))
    return x @ params["fc2"].to(x.dtype)
