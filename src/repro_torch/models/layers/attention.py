"""Multi-head attention: GQA + RoPE + sliding window + KV cache, and
cross-attention.

Three execution paths:

* ``attn_apply`` -- self-attention over a whole sequence (prefill). It
  goes through :func:`repro_torch.kernels.flash_attn.ops.flash_attention`:
  the Hopper kernel on a CUDA tensor, its plain version on the CPU.
* ``attn_decode`` -- one query token per row against the KV cache, with
  :func:`attend_dense` (plain products, as the reference computes decode
  outside any kernel). Every row carries its own position, so one batched
  call steps serving slots at different lengths.
* ``cross_attn_apply`` -- every query against every row of an encoder
  memory, through the same ``flash_attention`` with ``causal=False``:
  the Hopper kernel's non-causal mode on a CUDA tensor, its plain version
  on the CPU. A decode step projects the memory's keys and values anew
  each time, as the reference does; nothing of them is cached.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.layers import norms
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, *, cross: bool = False):
    """Self-attention params, or with ``cross`` a cross-attention's (no
    q/k norm, as the reference's)."""
    pd = dtype_of(cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), d, pd),
        "wk": dense_init(gen, (d, kv, hd), d, pd),
        "wv": dense_init(gen, (d, kv, hd), d, pd),
        "wo": dense_init(gen, (h, hd, d), h * hd, pd),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=pd, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=pd, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=pd, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = {"scale": torch.ones((hd,), device=dev)}
        p["k_norm"] = {"scale": torch.ones((hd,), device=dev)}
    return p


def attn_axes(cfg, *, cross: bool = False):
    """The logical axes of :func:`attn_init`'s params, leaf for leaf."""
    a = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        a["bq"] = ("heads", "head_dim")
        a["bk"] = ("kv_heads", "head_dim")
        a["bv"] = ("kv_heads", "head_dim")
    if cfg.qk_norm and not cross:
        a["q_norm"] = norms.head_norm_axes()
        a["k_norm"] = norms.head_norm_axes()
    return a


# ---------------------------------------------------------------------------
# core attend (q/k/v already projected and roped)
# ---------------------------------------------------------------------------


def _mask(q_pos, kv_pos, *, causal: bool, window: Optional[int]):
    """Boolean mask [..., Sq, Skv]; True = attend."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k <= q
    if window is not None:
        m &= (q - k) < window
    m &= k >= 0  # kv_pos < 0 marks invalid / unwritten cache slots
    return m


def attend_dense(q, k, v, q_pos, kv_pos, *, causal: bool,
                 window: Optional[int]):
    """q: (B,Sq,H,hd); k/v: (B,Skv,H,hd); positions: (S,) shared or
    (B,S) per row. Probabilities are cast to q's dtype before the PV
    product, as in the reference."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _mask(q_pos, kv_pos, causal=causal, window=window)
    mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def _project(x, w, b):
    """x: (B,S,d) @ w: (d,heads,hd) [+ b: (heads,hd)] -> (B,S,heads,hd)."""
    d, heads, hd = w.shape
    y = (x @ w.reshape(d, heads * hd).to(x.dtype)).view(
        *x.shape[:-1], heads, hd)
    return y if b is None else y + b.to(x.dtype)


def _project_q(params, x, cfg):
    q = _project(x, params["wq"], params.get("bq"))
    if "q_norm" in params:
        q = norms.rms_norm_apply(params["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(params, x, cfg):
    k = _project(x, params["wk"], params.get("bk"))
    v = _project(x, params["wv"], params.get("bv"))
    if "k_norm" in params:
        k = norms.rms_norm_apply(params["k_norm"], k, cfg.norm_eps)
    return k, v


def _project_out(params, out):
    h, hd, d = params["wo"].shape
    return out.reshape(*out.shape[:-2], h * hd) @ params["wo"].reshape(
        h * hd, d).to(out.dtype)


def _repeat_kv(k, num_heads):
    reps = num_heads // k.shape[2]
    return k.repeat_interleave(reps, dim=2) if reps > 1 else k


# ---------------------------------------------------------------------------
# full-sequence apply (prefill)
# ---------------------------------------------------------------------------


def attn_apply(params, x, cfg, *, positions, window=None,
               return_kv: bool = False):
    """Causal self-attention over a whole sequence; ``positions`` is
    ``arange(S)`` (the kernel masks by row index).

    ``return_kv=True`` also returns the post-rope, pre-GQA ``(k, v)`` --
    exactly what the decode cache stores -- so the fused prefill fills
    the cache from the projections it attends with.
    """
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=window)
    y = _project_out(params, out)
    return (y, (k, v)) if return_kv else y


def prefill_cache(k, v, positions, cache_len: int, dtype):
    """Scatter a prompt's roped k/v (B, P, kv, hd) into a fresh decode
    cache of length ``cache_len``.

    Position ``p`` lands in slot ``p % cache_len`` -- the ring layout the
    windowed decode reads (for global layers ``cache_len >= P``, so the
    modulo is the identity). Only the last ``min(P, cache_len)`` tokens
    are kept: a ring holds exactly that many.
    """
    B, P = k.shape[:2]
    n = min(P, cache_len)
    slots = positions[P - n:] % cache_len
    kc = torch.zeros((B, cache_len) + tuple(k.shape[2:]), dtype=dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, slots] = k[:, P - n:].to(dtype)
    vc[:, slots] = v[:, P - n:].to(dtype)
    return {"k": kc, "v": vc}


def cross_attn_apply(params, x, memory, cfg):
    """Cross-attention: queries from x (B, S, d), keys and values from the
    encoder memory (B, M, d), every query seeing every memory row."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, memory, cfg)
    return _project_out(params, flash_attention(q, k, v, causal=False))


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype, device=None):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes():
    return {
        "k": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
        "v": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    }


def decode_qkv(params, x, index, cfg):
    """Project and rope one token per row at its own position.
    x: (B,1,d); index: (B,) positions. Returns q (B,1,H,hd) and the new
    k, v rows (B,1,kv,hd)."""
    q = _project_q(params, x, cfg)
    k_new, v_new = _project_kv(params, x, cfg)
    if cfg.pos_embed == "rope":
        pos = index[:, None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    return q, k_new, v_new


def write_rows(cache, k_new, v_new, widx):
    """Write each row's new k/v at its own slot ``widx`` (B,), in place."""
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    cache["k"][rows, widx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, widx] = v_new[:, 0].to(cache["v"].dtype)


def attend_cache(params, q, cache, index, kv_pos, cfg, window):
    """q (B,1,H,hd) of the tokens at ``index`` (B,) against the cache
    rows at positions ``kv_pos`` (B, L); -1 marks an invalid row."""
    dtype = q.dtype
    kf = _repeat_kv(cache["k"].to(dtype), cfg.num_heads)
    vf = _repeat_kv(cache["v"].to(dtype), cfg.num_heads)
    out = attend_dense(q, kf, vf, index[:, None], kv_pos, causal=True,
                       window=window)
    return _project_out(params, out)


def attn_decode(params, x, cache, index, cfg, *, window=None):
    """One-token decode. x: (B,1,d); cache k/v: (B,Smax,kv,hd); index: (B,)
    = tokens already in each row's cache (the new token's position).

    The cache is updated in place (the reference returns a new one; in
    place saves a cache-sized copy per layer and step) and returned. The
    write index is clamped into the cache, as the reference's
    ``dynamic_update_slice`` clamps it. Returns (y, cache).
    """
    q, k_new, v_new = decode_qkv(params, x, index, cfg)
    Smax = cache["k"].shape[1]
    write_rows(cache, k_new, v_new, index.clamp(0, Smax - 1))
    kv_pos = torch.arange(Smax, device=x.device)[None, :]
    # slots beyond a row's index are unwritten: mark invalid with pos = -1
    kv_pos = torch.where(kv_pos <= index[:, None], kv_pos, -1)
    return attend_cache(params, q, cache, index, kv_pos, cfg, window), cache
