"""Rotary position embeddings (applied per call from integer positions)."""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(float(theta), exps)   # a scalar base: no host copy


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: integer tensor [...]; returns (cos, sin) [..., half] in
    float32."""
    inv = _freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, heads, head_dim]; positions: (S,) shared or (B, S) per
    row (the per-slot decode positions).

    Rotates the halves (x[..., :half], x[..., half:]) -- the GPT-NeoX
    layout -- in float32 and casts back to x's dtype.
    """
    head_dim = x.shape[-1]
    if head_dim % 2:
        raise ValueError("rope requires an even head_dim")
    cos, sin = rope_angles(positions, head_dim, theta)   # [..., S, half]
    cos = cos[..., None, :]                              # broadcast heads
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
