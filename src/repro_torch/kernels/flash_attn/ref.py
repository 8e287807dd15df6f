"""Plain PyTorch version of the flash-attention forward (causal + window).

The kernel's own arithmetic: scores, softmax and the PV product in
float32, the output cast to q's dtype. (The reference's ``mha_ref`` casts
the probabilities to q's dtype before the PV product, as ``attend_dense``
does; in float32 the two are the same function.)
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_ref(q, k, v, *, causal: bool = True, window=None, scale=None):
    """q: (B, S, H, hd); k, v: (B, Skv, KV, hd) with KV dividing H (query
    head h reads kv head h // (H // KV)). Returns (B, S, H, hd)."""
    S, Skv = q.shape[1], k.shape[1]
    reps = q.shape[2] // k.shape[2]
    if reps > 1:
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
