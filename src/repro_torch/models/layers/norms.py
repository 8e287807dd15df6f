"""RMSNorm (functional): statistics in float32, result cast back."""
from __future__ import annotations

import torch


def rms_norm_init(cfg, device=None):
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=device)}


def rms_norm_apply(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * params["scale"]).to(dtype)
