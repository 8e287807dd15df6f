"""Transformer assembly with the SCALA split layout.

Params are split into the SFL halves, one entry per layer keyed by its
absolute index::

    {'client': {'embed', 'blocks': {'blk0', ..., 'blk{split-1}'}},
     'server': {'blocks': {'blk{split}', ..., 'blk{L-1}'},
                'final_norm', 'head'}}

The reference stacks the server's repeated layer groups for a
``lax.scan`` (:func:`_layout`); here they are a per-layer loop, and
:mod:`repro_torch.convert` unstacks reference params into this layout.
Decode caches are ``{'blk{l}': {'k', 'v'}}`` over every layer.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.common import dtype_of
from repro_torch.models.layers import embeddings, norms


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _layout(cfg: ModelConfig):
    """(client_layers, prologue_layers, first_scan, n_scan_groups) of the
    reference's stacked layout."""
    gs = cfg.group_size
    split = cfg.split_layer
    r = (cfg.num_layers - split) % gs
    first_scan = split + r
    n_scan = (cfg.num_layers - first_scan) // gs
    return (list(range(split)), list(range(split, first_scan)), first_scan,
            n_scan)


def check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r}")
    if cfg.pos_embed not in ("rope", "none"):
        raise NotImplementedError(f"pos_embed {cfg.pos_embed!r}")
    for spec in cfg.block_specs:
        B.check_spec(spec)


def _layers(params, cfg: ModelConfig) -> Iterator[Tuple[int, BlockSpec, dict]]:
    """(layer index, spec, block params) in order, client half first."""
    for l in range(cfg.num_layers):
        half = "client" if l < cfg.split_layer else "server"
        yield l, cfg.block_spec(l), params[half]["blocks"][f"blk{l}"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random params on ``gen``'s device, drawn from ``gen``."""
    check_supported(cfg)
    blocks = {f"blk{l}": B.block_init(gen, cfg.block_spec(l), cfg)
              for l in range(cfg.num_layers)}
    split = cfg.split_layer
    return {
        "client": {
            "embed": embeddings.embedding_init(gen, cfg),
            "blocks": {f"blk{l}": blocks[f"blk{l}"] for l in range(split)},
        },
        "server": {
            "blocks": {f"blk{l}": blocks[f"blk{l}"]
                       for l in range(split, cfg.num_layers)},
            "final_norm": norms.rms_norm_init(cfg, gen.device),
            "head": embeddings.head_init(gen, cfg),
        },
    }


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------


def _head(params, x, cfg: ModelConfig, head_mode: str):
    if head_mode == "last":
        x = x[:, -1:]
    x = norms.rms_norm_apply(params["server"]["final_norm"], x, cfg.norm_eps)
    if head_mode == "feats":
        return x
    return embeddings.head_apply(params["server"]["head"], x, cfg)


def client_forward(client_params, batch, cfg: ModelConfig):
    """The client half: embedding + the first ``split_layer`` blocks.
    Returns the SFL activation upload ``{'x', 'positions'}``."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embeddings.embedding_apply(client_params["embed"], tokens, cfg)
    for l in range(cfg.split_layer):
        x = B.block_apply(client_params["blocks"][f"blk{l}"], x,
                          cfg.block_spec(l), cfg, positions=positions)
    return {"x": x, "positions": positions}


def server_forward(server_params, acts, cfg: ModelConfig, *,
                   head_mode: str = "full"):
    """The server half on (possibly concatenated) activations ``{'x',
    'positions'}``: logits (B, S, V), or the final-normed features with
    ``head_mode='feats'``, or the last position's with 'last'. Returns
    (out, aux); aux is the MoE router loss, zero for the ported dense
    blocks."""
    check_supported(cfg)
    x, positions = acts["x"], acts["positions"]
    for l in range(cfg.split_layer, cfg.num_layers):
        x = B.block_apply(server_params["blocks"][f"blk{l}"], x,
                          cfg.block_spec(l), cfg, positions=positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head({"server": server_params}, x, cfg, head_mode), aux


def forward(params, batch, cfg: ModelConfig, *, head_mode: str = "full"):
    """Merged (non-split) forward: logits (B, S, V), or (B, 1, V) with
    ``head_mode='last'``, or the final-normed features with 'feats'."""
    check_supported(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embeddings.embedding_apply(params["client"]["embed"], tokens, cfg)
    for _, spec, p in _layers(params, cfg):
        x = B.block_apply(p, x, spec, cfg, positions=positions)
    return _head(params, x, cfg, head_mode)


def forward_prefill_cached(params, batch, cfg: ModelConfig, max_len: int,
                           cache_dtype=None):
    """Fused serving prefill: one trunk pass over the whole prompt that
    also fills every layer's decode cache.

    Returns (logits (B, 1, V), cache): the logits at the last prompt
    position and a cache structured like :func:`init_decode_cache`
    ``(cfg, B, max_len)``, so :func:`decode_step` continues from it.
    """
    check_supported(cfg)
    dtype = cache_dtype or dtype_of(cfg.dtype)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embeddings.embedding_apply(params["client"]["embed"], tokens, cfg)
    cache = {}
    for l, spec, p in _layers(params, cfg):
        x, cache[f"blk{l}"] = B.block_prefill(
            p, x, spec, cfg, positions=positions, max_len=max_len,
            cache_dtype=dtype)
    return _head(params, x, cfg, "last"), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device=None):
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    return {f"blk{l}": B.block_cache_init(cfg.block_spec(l), cfg, batch,
                                          max_len, dtype, device)
            for l in range(cfg.num_layers)}


def decode_step(params, batch, cache, index, cfg: ModelConfig):
    """One-token decode on the merged model.

    batch: {'tokens': (B, 1)}; index: an int shared by every row, or a
    (B,) tensor with each row's own position (the serving engine steps
    slots at different lengths in one call). The cache is updated in
    place. Returns (logits (B, 1, V), cache).
    """
    tokens = batch["tokens"]
    index = torch.as_tensor(index, device=tokens.device).long()
    if index.dim() == 0:
        index = index.expand(tokens.shape[0])
    x = embeddings.embedding_apply(params["client"]["embed"], tokens, cfg)
    for l, spec, p in _layers(params, cfg):
        x, cache[f"blk{l}"] = B.block_decode(p, x, cache[f"blk{l}"], index,
                                             spec, cfg)
    return _head(params, x, cfg, "full"), cache
