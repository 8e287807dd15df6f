"""RMSNorm and LayerNorm (functional): statistics in float32, result cast
back."""
from __future__ import annotations

import torch


def rms_norm_init(cfg, device=None):
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=device)}


def rms_norm_axes(cfg):
    return {"scale": ("embed",)}


def rms_norm_apply(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * params["scale"]).to(dtype)


def layer_norm_init(dim: int, device=None):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm_axes():
    return {"scale": ("embed",), "bias": ("embed",)}


def head_norm_axes():
    """The q / k head norm's (qwen3, gemma3): one scale per head dim."""
    return {"scale": ("head_dim",)}


def layer_norm_apply(params, x, eps: float = 1e-6):
    """LayerNorm over the last axis with the reference's biased variance
    (``jnp.var``)."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)
