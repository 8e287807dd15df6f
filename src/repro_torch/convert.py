"""Reference params and checkpoints -> the port's layout.

The reference (:mod:`repro.models.transformer`) keeps the client blocks
and the server prologue per layer and stacks the server's repeated layer
groups with a leading ``(n_scan,)`` axis; a federated checkpoint also
stacks the client half over the ``K`` client slots. This module reads
such a tree -- nested dicts of numpy arrays, or a ``repro.checkpoint``
``.npz`` read with numpy alone -- and returns the port's per-layer dicts
of tensors (:mod:`repro_torch.models.transformer`).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import _layout

FULL_STATE_PREFIX = ".inner/.params/"


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_tensor(a, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def per_layer(client_blocks, prologue, groups, cfg: ModelConfig) -> Dict[int, dict]:
    """{layer index: subtree} from the reference's three block
    collections (params or decode caches)."""
    client_l, prologue_l, first_scan, n_scan = _layout(cfg)
    out = {l: client_blocks[f"blk{i}"] for i, l in enumerate(client_l)}
    out.update({l: prologue[f"blk{i}"] for i, l in enumerate(prologue_l)})
    gs = cfg.group_size
    for j in range(gs if n_scan else 0):
        for g in range(n_scan):
            out[first_scan + g * gs + j] = _map(lambda a, g=g: a[g],
                                                groups[f"blk{j}"])
    return out


def params_from_reference(tree, cfg: ModelConfig, device="cpu"):
    """Reference params ``{'client', 'server'}`` (numpy leaves; the client
    half merged, or stacked over K client slots, of which slot 0 -- the
    aggregated global client half -- is served) -> port params."""
    client = tree["client"]
    tok_shape = (cfg.vocab_size, cfg.d_model)
    shape = np.shape(client["embed"]["tok"])
    if shape[1:] == tok_shape:
        client = _map(lambda a: a[0], client)
    elif shape != tok_shape:
        raise ValueError(f"client embedding has shape {shape}, expected "
                         f"{tok_shape} or (K,)+{tok_shape} for {cfg.name}")
    server = tree["server"]
    # an empty prologue or groups collection leaves no key in a checkpoint
    layers = per_layer(client["blocks"], server.get("prologue", {}),
                       server.get("groups", {}), cfg)

    def t(sub):
        return _map(lambda a: to_tensor(a, device), sub)

    split = cfg.split_layer
    return {
        "client": {"embed": t(client["embed"]),
                   "blocks": {f"blk{l}": t(layers[l]) for l in range(split)}},
        "server": {"blocks": {f"blk{l}": t(layers[l])
                              for l in range(split, cfg.num_layers)},
                   "final_norm": t(server["final_norm"]),
                   "head": t(server["head"])},
    }


def _nest(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def params_from_npz(path: str, cfg: ModelConfig, device="cpu"):
    """Port params from a ``repro.checkpoint`` file: a params checkpoint
    (merged or K-stacked client half), or a full training-state one whose
    params sit under the ``.inner/.params/`` key prefix."""
    probe = "client/embed/tok"
    with np.load(path) as data:
        files = set(data.files)
        if probe in files:
            prefix = ""
        elif FULL_STATE_PREFIX + probe in files:
            prefix = FULL_STATE_PREFIX
        else:
            raise ValueError(
                f"checkpoint {path!r} has neither {probe!r} nor "
                f"{FULL_STATE_PREFIX + probe!r}: not a params or full-state "
                "training checkpoint")
        flat = {k[len(prefix):]: data[k] for k in files
                if k.startswith(prefix) and
                k[len(prefix):].split("/", 1)[0] in ("client", "server")}
    return params_from_reference(_nest(flat), cfg, device)
