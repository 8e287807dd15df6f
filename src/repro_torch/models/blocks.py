"""Residual block assembly: one BlockSpec -> params / apply / cache.

A block is pre-norm -> attention (+residual) -> pre-norm -> dense FFN
(+residual). The other mixers and FFNs of :mod:`repro.models.blocks`
(mamba, xLSTM, MoE, cross-attention) raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models.layers import attention, mlp, norms


def check_spec(spec: BlockSpec) -> None:
    if spec.mixer != "attn" or spec.ffn != "dense" or spec.cross_attn:
        raise NotImplementedError(
            f"block mixer={spec.mixer!r} ffn={spec.ffn!r} "
            f"cross_attn={spec.cross_attn}: only attention + dense FFN "
            "blocks are ported")


def cache_length(spec: BlockSpec, max_len: int) -> int:
    """KV rows a layer keeps: the window's ring for windowed layers."""
    return max_len if spec.window is None else min(max_len, spec.window)


def block_init(gen: torch.Generator, spec: BlockSpec, cfg: ModelConfig):
    check_spec(spec)
    return {
        "norm1": norms.rms_norm_init(cfg, gen.device),
        "mixer": attention.attn_init(gen, cfg),
        "norm2": norms.rms_norm_init(cfg, gen.device),
        "ffn": mlp.mlp_init(gen, cfg),
    }


def _ffn(params, x, cfg):
    h = norms.rms_norm_apply(params["norm2"], x, cfg.norm_eps)
    return x + mlp.mlp_apply(params["ffn"], h, cfg)


def block_apply(params, x, spec: BlockSpec, cfg: ModelConfig, *, positions):
    """Full-sequence forward."""
    check_spec(spec)
    h = norms.rms_norm_apply(params["norm1"], x, cfg.norm_eps)
    x = x + attention.attn_apply(params["mixer"], h, cfg,
                                 positions=positions, window=spec.window)
    return _ffn(params, x, cfg)


def block_prefill(params, x, spec: BlockSpec, cfg: ModelConfig, *,
                  positions, max_len: int, cache_dtype):
    """Full-sequence forward that also emits this block's decode cache,
    structured like :func:`block_cache_init`. Returns (y, cache)."""
    check_spec(spec)
    h = norms.rms_norm_apply(params["norm1"], x, cfg.norm_eps)
    h, (k, v) = attention.attn_apply(params["mixer"], h, cfg,
                                     positions=positions, window=spec.window,
                                     return_kv=True)
    cache = attention.prefill_cache(k, v, positions,
                                    cache_length(spec, max_len), cache_dtype)
    return _ffn(params, x + h, cfg), cache


def block_cache_init(spec: BlockSpec, cfg: ModelConfig, batch: int,
                     max_len: int, dtype, device=None):
    check_spec(spec)
    return attention.init_cache(cfg, batch, cache_length(spec, max_len),
                                dtype, device)


def block_decode(params, x, cache, index, spec: BlockSpec, cfg: ModelConfig):
    """One-token decode; ``index`` (B,) holds each row's position.
    Updates ``cache`` in place. Returns (y, cache)."""
    check_spec(spec)
    h = norms.rms_norm_apply(params["norm1"], x, cfg.norm_eps)
    if spec.window is not None:
        # windowed ring cache: write at index % cache_len
        widx = torch.remainder(index, cache["k"].shape[1])
        h, cache = _decode_ring(params["mixer"], h, cache, index, widx, cfg,
                                spec.window)
    else:
        h, cache = attention.attn_decode(params["mixer"], h, cache, index,
                                         cfg, window=None)
    return _ffn(params, x + h, cfg), cache


def _decode_ring(params, x, cache, index, widx, cfg, window):
    """Decode against a ring buffer of size <= window (SWA layers).

    Each ring slot's position is reconstructed from the row's write index,
    so the relative-window mask stays exact.
    """
    cache_len = cache["k"].shape[1]
    q, k_new, v_new = attention.decode_qkv(params, x, index, cfg)
    attention.write_rows(cache, k_new, v_new, widx)
    # slot i holds position: the largest p <= index with p % cache_len == i
    slots = torch.arange(cache_len, device=x.device)[None, :]
    delta = torch.remainder(widx[:, None] - slots, cache_len)
    kv_pos = index[:, None] - delta
    kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
    y = attention.attend_cache(params, q, cache, index, kv_pos, cfg, window)
    return y, cache
