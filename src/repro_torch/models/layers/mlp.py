"""Dense FFN: gated (SwiGLU / GeGLU) or plain two-layer MLP."""
from __future__ import annotations

import torch

from repro_torch.models.common import ACTIVATIONS, dense_init, dtype_of


def _gated(cfg) -> bool:
    return cfg.act in ("silu", "gelu")


def mlp_init(gen: torch.Generator, cfg):
    pd = dtype_of(cfg.param_dtype)
    p = {
        "up": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.d_model, pd),
        "down": dense_init(gen, (cfg.d_ff, cfg.d_model), cfg.d_ff, pd),
    }
    if _gated(cfg):
        p["gate"] = dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.d_model, pd)
    return p


def mlp_axes(cfg):
    a = {"up": ("embed", "ffn"), "down": ("ffn", "embed")}
    if _gated(cfg):
        a["gate"] = ("embed", "ffn")
    return a


def mlp_apply(params, x: torch.Tensor, cfg):
    act = ACTIVATIONS[cfg.act]
    up = x @ params["up"].to(x.dtype)
    if _gated(cfg):
        h = act(x @ params["gate"].to(x.dtype)) * up
    else:
        h = act(up)
    return h @ params["down"].to(x.dtype)
