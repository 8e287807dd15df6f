"""Residual block assembly: one BlockSpec -> params / axes / apply /
cache.

A block is pre-norm -> mixer (+residual) [-> pre-norm -> cross-attention
over the encoder memory (+residual)] [-> pre-norm -> FFN (+residual)].
The mixer is attention, mamba, mLSTM or sLSTM, the FFN dense or MoE;
xLSTM blocks carry their FFN inside the mixer (``ffn == 'none'``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models.layers import (attention, mamba, mlp, moe, norms,
                                       xlstm)

MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


def check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in MIXERS or spec.ffn not in FFNS:
        raise NotImplementedError(
            f"block mixer={spec.mixer!r} ffn={spec.ffn!r}: the port has "
            f"mixers {MIXERS} and FFNs {FFNS}")


def cache_length(spec: BlockSpec, max_len: int) -> int:
    """KV rows a layer keeps: the window's ring for windowed layers."""
    return max_len if spec.window is None else min(max_len, spec.window)


_MIXER_INIT = {
    "attn": attention.attn_init,
    "mamba": mamba.mamba_init,
    "mlstm": xlstm.mlstm_init,
    "slstm": xlstm.slstm_init,
}


def block_init(gen: torch.Generator, spec: BlockSpec, cfg: ModelConfig):
    check_spec(spec)
    p = {
        "norm1": norms.rms_norm_init(cfg, gen.device),
        "mixer": _MIXER_INIT[spec.mixer](gen, cfg),
    }
    if spec.cross_attn:
        p["norm_cross"] = norms.rms_norm_init(cfg, gen.device)
        p["cross"] = attention.attn_init(gen, cfg, cross=True)
    if spec.ffn == "dense":
        p["norm2"] = norms.rms_norm_init(cfg, gen.device)
        p["ffn"] = mlp.mlp_init(gen, cfg)
    elif spec.ffn == "moe":
        p["norm2"] = norms.rms_norm_init(cfg, gen.device)
        p["ffn"] = moe.moe_init(gen, cfg)
    return p


_MIXER_AXES = {
    "attn": attention.attn_axes,
    "mamba": mamba.mamba_axes,
    "mlstm": xlstm.mlstm_axes,
    "slstm": xlstm.slstm_axes,
}


def block_axes(spec: BlockSpec, cfg: ModelConfig):
    """The logical axes of :func:`block_init`'s params, leaf for leaf."""
    check_spec(spec)
    a = {
        "norm1": norms.rms_norm_axes(cfg),
        "mixer": _MIXER_AXES[spec.mixer](cfg),
    }
    if spec.cross_attn:
        a["norm_cross"] = norms.rms_norm_axes(cfg)
        a["cross"] = attention.attn_axes(cfg, cross=True)
    if spec.ffn == "dense":
        a["norm2"] = norms.rms_norm_axes(cfg)
        a["ffn"] = mlp.mlp_axes(cfg)
    elif spec.ffn == "moe":
        a["norm2"] = norms.rms_norm_axes(cfg)
        a["ffn"] = moe.moe_axes(cfg)
    return a


def _dropless(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with an MoE capacity that drops nothing: one-token decode
    routes each token alone and never drops, so the fused prefill must
    not either, or it departs from the token-by-token path it replaces."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _cross(params, x, spec: BlockSpec, cfg, memory):
    """The cross-attention sublayer, where the block has one."""
    if not spec.cross_attn:
        return x
    h = norms.rms_norm_apply(params["norm_cross"], x, cfg.norm_eps)
    return x + attention.cross_attn_apply(params["cross"], h, memory, cfg)


def _ffn(params, x, spec: BlockSpec, cfg):
    """The FFN sublayer: (y, the MoE router loss or None)."""
    if spec.ffn == "none":
        return x, None
    h = norms.rms_norm_apply(params["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = moe.moe_apply(params["ffn"], h, cfg)
        return x + y, aux
    return x + mlp.mlp_apply(params["ffn"], h, cfg), None


def block_apply(params, x, spec: BlockSpec, cfg: ModelConfig, *, positions,
                memory=None):
    """Full-sequence forward. Returns (y, aux): the MoE router loss, a
    float32 zero for the other FFNs."""
    check_spec(spec)
    h = norms.rms_norm_apply(params["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        h = attention.attn_apply(params["mixer"], h, cfg,
                                 positions=positions, window=spec.window)
    elif spec.mixer == "mamba":
        h = mamba.mamba_apply(params["mixer"], h, cfg)
    elif spec.mixer == "mlstm":
        h = xlstm.mlstm_apply(params["mixer"], h, cfg)
    else:
        h = xlstm.slstm_apply(params["mixer"], h, cfg)
    y, aux = _ffn(params, _cross(params, x + h, spec, cfg, memory), spec,
                  cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, aux


def block_prefill(params, x, spec: BlockSpec, cfg: ModelConfig, *,
                  positions, max_len: int, cache_dtype, memory=None):
    """Full-sequence forward that also emits this block's decode cache,
    structured like :func:`block_cache_init`; an MoE FFN routes dropless
    and its router loss is dropped (serving does not train). Returns (y,
    cache)."""
    check_spec(spec)
    h = norms.rms_norm_apply(params["norm1"], x, cfg.norm_eps)
    if spec.mixer == "attn":
        h, (k, v) = attention.attn_apply(params["mixer"], h, cfg,
                                         positions=positions,
                                         window=spec.window, return_kv=True)
        cache = attention.prefill_cache(k, v, positions,
                                        cache_length(spec, max_len),
                                        cache_dtype)
    elif spec.mixer == "mamba":
        h, cache = mamba.mamba_prefill(params["mixer"], h, cfg, cache_dtype)
    elif spec.mixer == "mlstm":
        h, cache = xlstm.mlstm_prefill(params["mixer"], h, cfg, cache_dtype)
    else:
        h, cache = xlstm.slstm_prefill(params["mixer"], h, cfg)
    if spec.ffn == "moe":
        cfg = _dropless(cfg)
    return _ffn(params, _cross(params, x + h, spec, cfg, memory), spec,
                cfg)[0], cache


def block_cache_init(spec: BlockSpec, cfg: ModelConfig, batch: int,
                     max_len: int, dtype, device=None):
    check_spec(spec)
    if spec.mixer == "mamba":
        return mamba.init_cache(cfg, batch, dtype, device)
    if spec.mixer == "mlstm":
        return xlstm.mlstm_init_cache(cfg, batch, dtype, device)
    if spec.mixer == "slstm":
        return xlstm.slstm_init_cache(cfg, batch, dtype, device)
    return attention.init_cache(cfg, batch, cache_length(spec, max_len),
                                dtype, device)


def block_cache_axes(spec: BlockSpec):
    """The logical axes of :func:`block_cache_init`'s cache."""
    check_spec(spec)
    if spec.mixer == "mamba":
        return mamba.cache_axes()
    if spec.mixer == "mlstm":
        return xlstm.mlstm_cache_axes()
    if spec.mixer == "slstm":
        return xlstm.slstm_cache_axes()
    return attention.cache_axes()


def block_decode(params, x, cache, index, spec: BlockSpec, cfg: ModelConfig,
                 *, memory=None):
    """One-token decode; ``index`` (B,) holds each row's position.
    Attention updates ``cache`` in place; the recurrent mixers return new
    state tensors. An MoE FFN routes at the configured capacity (one
    token a row drops nothing). Returns (y, cache)."""
    check_spec(spec)
    h = norms.rms_norm_apply(params["norm1"], x, cfg.norm_eps)
    if spec.mixer == "mamba":
        h, cache = mamba.mamba_decode(params["mixer"], h, cache, cfg)
    elif spec.mixer == "mlstm":
        h, cache = xlstm.mlstm_decode(params["mixer"], h, cache, cfg)
    elif spec.mixer == "slstm":
        h, cache = xlstm.slstm_decode(params["mixer"], h, cache, cfg)
    elif spec.window is not None:
        # windowed ring cache: write at index % cache_len
        widx = torch.remainder(index, cache["k"].shape[1])
        h, cache = _decode_ring(params["mixer"], h, cache, index, widx, cfg,
                                spec.window)
    else:
        h, cache = attention.attn_decode(params["mixer"], h, cache, index,
                                         cfg, window=None)
    return _ffn(params, _cross(params, x + h, spec, cfg, memory), spec,
                cfg)[0], cache


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
