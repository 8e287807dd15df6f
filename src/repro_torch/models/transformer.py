"""Transformer assembly with the SCALA split layout.

Params are split into the SFL halves, one entry per layer keyed by its
absolute index::

    {'client': {'embed', 'projector'?,
                'blocks': {'blk0', ..., 'blk{split-1}'}},
     'server': {'blocks': {'blk{split}', ..., 'blk{L-1}'},
                'final_norm', 'head'}}

The reference stacks the server's repeated layer groups for a
``lax.scan`` (:func:`_layout`); here they are a per-layer loop (a group
rematerialized as one checkpoint for the recurrent archs,
:func:`server_forward`), and :mod:`repro_torch.convert` unstacks
reference params into this layout.
Decode caches are ``{'blk{l}': ...}`` over every layer: ``{'k', 'v'}``
for attention, the recurrent state for mamba (``conv``, ``h``), mLSTM
(``conv``, ``C``, ``n``, ``m``) and sLSTM (``c``, ``n``, ``m``, ``h``).

A frontend arch takes its encoder's output in the batch (the encoders are
stubs, as in the reference): a vision arch's ``prefix_emb`` (B, P, fd),
projected and put before the text, which then sits at positions P ..
P + S - 1; an audio arch's ``memory_emb`` (B, M, fd), projected into the
memory that every cross-attention layer reads (the client half uploads it
beside ``x``).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.common import dtype_of
from repro_torch.models.layers import embeddings, frontends, norms


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


def group_specs(cfg: ModelConfig):
    """The block specs of one of the reference's scan groups (one period
    of the layer pattern, from the first scanned layer on)."""
    _, _, first_scan, _ = _layout(cfg)
    return [cfg.block_spec(first_scan + j) for j in range(cfg.group_size)]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.frontend not in (None, "vision", "audio"):
        raise NotImplementedError(f"frontend {cfg.frontend!r}")
    if cfg.pos_embed not in ("rope", "none", "learned"):
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
    client = {"embed": embeddings.embedding_init(gen, cfg)}
    if cfg.frontend:
        client["projector"] = frontends.projector_init(gen, cfg)
    client["blocks"] = {f"blk{l}": blocks[f"blk{l}"] for l in range(split)}
    return {
        "client": client,
        "server": {
            "blocks": {f"blk{l}": blocks[f"blk{l}"]
                       for l in range(split, cfg.num_layers)},
            "final_norm": norms.rms_norm_init(cfg, gen.device),
            "head": embeddings.head_init(gen, cfg),
        },
    }


def param_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_params`'s tree, leaf for leaf: the
    reference's ``param_axes`` over this package's per-layer layout (the
    reference's stacked server groups carry a leading ``"layers"`` axis;
    here each layer is its own ``blk{l}``)."""
    check_supported(cfg)
    split = cfg.split_layer
    blocks = {f"blk{l}": B.block_axes(cfg.block_spec(l), cfg)
              for l in range(cfg.num_layers)}
    client = {"embed": embeddings.embedding_axes(cfg)}
    if cfg.frontend:
        client["projector"] = frontends.projector_axes(cfg)
    client["blocks"] = {f"blk{l}": blocks[f"blk{l}"] for l in range(split)}
    return {
        "client": client,
        "server": {
            "blocks": {f"blk{l}": blocks[f"blk{l}"]
                       for l in range(split, cfg.num_layers)},
            "final_norm": norms.rms_norm_axes(cfg),
            "head": embeddings.head_axes(cfg),
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


def _embed_inputs(client_params, batch, cfg: ModelConfig):
    """(x, positions, memory): the embedded tokens (after the projected
    image prefix for vision), their positions ``arange`` over the whole
    row, and the projected audio memory (None without one)."""
    tokens = batch["tokens"]
    memory = None
    if cfg.frontend == "vision":
        prefix = frontends.projector_apply(client_params["projector"],
                                           batch["prefix_emb"], cfg)
        P = prefix.shape[1]
        positions = torch.arange(P + tokens.shape[1], device=tokens.device)
        x = embeddings.embedding_apply(client_params["embed"], tokens, cfg,
                                       positions=positions[None, P:])
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    else:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = embeddings.embedding_apply(client_params["embed"], tokens, cfg,
                                       positions=positions[None, :])
        if cfg.frontend == "audio":
            memory = frontends.projector_apply(client_params["projector"],
                                               batch["memory_emb"], cfg)
    return x, positions, memory


def client_forward(client_params, batch, cfg: ModelConfig):
    """The client half: embedding (and the frontend's projector) + the
    first ``split_layer`` blocks. Returns the SFL activation upload
    ``{'x', 'positions'}``, and ``'memory'`` for an audio arch."""
    check_supported(cfg)
    x, positions, memory = _embed_inputs(client_params, batch, cfg)
    for l in range(cfg.split_layer):
        # the client blocks' router loss is dropped, as the reference's
        x, _ = B.block_apply(client_params["blocks"][f"blk{l}"], x,
                             cfg.block_spec(l), cfg, positions=positions,
                             memory=memory)
    out = {"x": x, "positions": positions}
    if memory is not None:
        out["memory"] = memory
    return out


def default_remat(cfg: ModelConfig) -> bool:
    """Whether the server half recomputes its scan groups on the backward
    pass by default: for the recurrent (mLSTM / sLSTM) archs, whose saved
    activations at full width would fill a card (the reference
    rematerializes every arch's groups; the attention archs here keep
    theirs, so each of their layers launches its kernels once a step)."""
    return any(spec.mixer in ("mlstm", "slstm") for spec in cfg.block_specs)


def server_forward(server_params, acts, cfg: ModelConfig, *,
                   head_mode: str = "full", remat=None):
    """The server half on (possibly concatenated) activations ``{'x',
    'positions', 'memory'?}``: logits (B, S, V), or the final-normed
    features with ``head_mode='feats'``, or the last position's with
    'last'. Returns (out, aux); aux is the MoE router loss summed over
    the server's blocks, zero for the other FFNs.

    ``remat`` (default :func:`default_remat`): under autograd each of the
    reference's scan groups (:func:`_layout`; the prologue is not one)
    runs through ``torch.utils.checkpoint``, which keeps only its input
    and reruns it on every backward pass through it, as the reference's
    ``jax.checkpoint`` around its group scan."""
    check_supported(cfg)
    x, positions, memory = acts["x"], acts["positions"], acts.get("memory")
    if remat is None:
        remat = default_remat(cfg)

    def run(x, aux, layers):
        for l in layers:
            x, a = B.block_apply(server_params["blocks"][f"blk{l}"], x,
                                 cfg.block_spec(l), cfg, positions=positions,
                                 memory=memory)
            aux = aux + a
        return x, aux

    _, prologue, first, n_groups = _layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = run(x, aux, prologue)
    gs = cfg.group_size
    for g in range(n_groups):
        layers = range(first + g * gs, first + (g + 1) * gs)
        if remat and torch.is_grad_enabled():
            # the blocks draw no random numbers: no RNG state to keep
            x, aux = checkpoint(run, x, aux, layers, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = run(x, aux, layers)
    return _head({"server": server_params}, x, cfg, head_mode), aux


def forward(params, batch, cfg: ModelConfig, *, head_mode: str = "full"):
    """Merged (non-split) forward: logits (B, S, V), or (B, 1, V) with
    ``head_mode='last'``, or the final-normed features with 'feats'."""
    check_supported(cfg)
    x, positions, memory = _embed_inputs(params["client"], batch, cfg)
    for _, spec, p in _layers(params, cfg):
        x, _ = B.block_apply(p, x, spec, cfg, positions=positions,
                             memory=memory)
    return _head(params, x, cfg, head_mode)


def forward_prefill(params, batch, cfg: ModelConfig):
    """Serving prefill: the whole trunk, the next-token logits only (B, 1,
    V)."""
    return forward(params, batch, cfg, head_mode="last")


def forward_prefill_cached(params, batch, cfg: ModelConfig, max_len: int,
                           cache_dtype=None):
    """Fused serving prefill: one trunk pass over the whole prompt that
    also fills every layer's decode cache.

    Returns (logits (B, 1, V), cache): the logits at the last prompt
    position and a cache structured like :func:`init_decode_cache`
    ``(cfg, B, max_len)``, so :func:`decode_step` continues from it.
    A vision prefix is refused, as in the reference (it would shift the
    cached positions against the token index decode uses); the audio
    memory is not cached: decode recomputes it from the batch each step.
    """
    check_supported(cfg)
    if cfg.frontend == "vision":
        raise NotImplementedError(
            "forward_prefill_cached does not support vision prefixes")
    dtype = cache_dtype or dtype_of(cfg.dtype)
    x, positions, memory = _embed_inputs(params["client"], batch, cfg)
    cache = {}
    for l, spec, p in _layers(params, cfg):
        x, cache[f"blk{l}"] = B.block_prefill(
            p, x, spec, cfg, positions=positions, max_len=max_len,
            cache_dtype=dtype, memory=memory)
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


def cache_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_decode_cache`'s tree."""
    check_supported(cfg)
    return {f"blk{l}": B.block_cache_axes(cfg.block_spec(l))
            for l in range(cfg.num_layers)}


def decode_step(params, batch, cache, index, cfg: ModelConfig):
    """One-token decode on the merged model.

    batch: {'tokens': (B, 1), 'memory_emb'?: (B, M, fd)}; index: an int
    shared by every row, or a (B,) tensor with each row's own position
    (the serving engine steps slots at different lengths in one call).
    An audio arch projects ``memory_emb`` anew each step, as the
    reference. The cache is updated in place. Returns (logits (B, 1, V),
    cache).
    """
    tokens = batch["tokens"]
    index = torch.as_tensor(index, device=tokens.device).long()
    if index.dim() == 0:
        index = index.expand(tokens.shape[0])
    client = params["client"]
    memory = None
    if cfg.frontend == "audio":
        memory = frontends.projector_apply(client["projector"],
                                           batch["memory_emb"], cfg)
    x = embeddings.embedding_apply(client["embed"], tokens, cfg,
                                   positions=index[:, None])
    for l, spec, p in _layers(params, cfg):
        x, cache[f"blk{l}"] = B.block_decode(p, x, cache[f"blk{l}"], index,
                                             spec, cfg, memory=memory)
    return _head(params, x, cfg, "full"), cache
