"""Reference params, optimizer state and checkpoints -> the port's layout.

The reference (:mod:`repro.models.transformer`) keeps the client blocks
and the server prologue per layer and stacks the server's repeated layer
groups with a leading ``(n_scan,)`` axis; a federated checkpoint also
stacks the client half over the ``K`` client slots. This module reads
such a tree -- nested dicts of numpy arrays, or a ``repro.checkpoint``
``.npz`` read with numpy alone -- and returns the port's per-layer dicts
of tensors (:mod:`repro_torch.models.transformer`): merged for serving
(:func:`params_from_reference`), or in the training layout with the K
axis kept (:func:`train_params_from_reference`), together with the
engine's optimizer state and step (:func:`train_state_from_reference`).

AlexNet (the CNN family) keeps the reference's tree -- ``convs``, ``fcs``
(tuples here) and ``head`` -- and changes one layout: conv weights go from
HWIO to the OIHW of ``F.conv2d``. The FC weights keep theirs, because
:mod:`repro_torch.models.alexnet` flattens in the reference's NHWC order.
The FL / SFL baselines' states convert the same way
(:func:`baseline_state_from_reference`), a whole reference
``Trainer.save`` checkpoint converts to the port's program state
(:func:`program_state_from_reference`), and the async runtime's
``AsyncFedState`` to the port's (:func:`async_state_from_reference`).
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
    """A tensor that owns its memory: a read-only array (a JAX buffer's
    host view) is copied, not shared. A bfloat16 array (numpy's
    ``ml_dtypes`` extension type, which torch does not read) comes over
    as its 16-bit patterns."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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


def _client_half(client, cfg: ModelConfig, device):
    """A reference client-half tree (params, or an optimizer-state tree
    shaped like them) -> the port's; leading axes are kept."""
    t = lambda sub: _map(lambda a: to_tensor(a, device), sub)
    out = {"embed": t(client["embed"])}
    if "projector" in client:      # a frontend arch's (vision, audio)
        out["projector"] = t(client["projector"])
    out["blocks"] = {f"blk{l}": t(client["blocks"][f"blk{l}"])
                     for l in range(cfg.split_layer)}
    return out


def _server_half(server, cfg: ModelConfig, device):
    """A reference server-half tree -> the port's per-layer one."""
    t = lambda sub: _map(lambda a: to_tensor(a, device), sub)
    # an empty prologue or groups collection leaves no key in a checkpoint
    layers = per_layer({f"blk{l}": None for l in range(cfg.split_layer)},
                       server.get("prologue", {}), server.get("groups", {}),
                       cfg)
    return {"blocks": {f"blk{l}": t(layers[l])
                       for l in range(cfg.split_layer, cfg.num_layers)},
            "final_norm": t(server["final_norm"]),
            "head": t(server["head"])}


def _hwio_to_oihw(a):
    """(..., H, W, I, O) -> (..., O, I, H, W); leading (K,) axes kept."""
    return np.moveaxis(np.asarray(a), (-1, -2), (-4, -3))


def alexnet_params_from_reference(tree, device="cpu"):
    """A reference AlexNet tree (full, or one half; leading slot axes
    kept) -> the port's: conv weights HWIO -> OIHW, lists -> tuples."""
    t = lambda a: to_tensor(a, device)
    out = {}
    if "convs" in tree:
        out["convs"] = tuple({"w": t(_hwio_to_oihw(c["w"])), "b": t(c["b"])}
                             for c in tree["convs"])
    if "fcs" in tree:
        out["fcs"] = tuple({"w": t(f["w"]), "b": t(f["b"])}
                           for f in tree["fcs"])
    if "head" in tree:
        out["head"] = {"w": t(tree["head"]["w"]), "b": t(tree["head"]["b"])}
    return out


def _halves(cfg: ModelConfig):
    """The (client, server) half converters of ``cfg``'s family."""
    if cfg.family == "cnn":
        cnn = lambda tree, cfg, device: alexnet_params_from_reference(
            tree, device)
        return cnn, cnn
    return _client_half, _server_half


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
    return {"client": _client_half(client, cfg, device),
            "server": _server_half(tree["server"], cfg, device)}


def train_params_from_reference(tree, cfg: ModelConfig, device="cpu"):
    """Reference training params -> the port's training layout: the
    client half keeps its leading (K,) slot axis (or stays merged, for
    :func:`repro_torch.api.build` to repeat over the slots)."""
    client, server = _halves(cfg)
    return {"client": client(tree["client"], cfg, device),
            "server": server(tree["server"], cfg, device)}


def _opt_half(state, half, cfg, device):
    """One half's optimizer state: ``()`` (SGD), a params-shaped tree
    (momentum) or ``{'mu', 'nu', 'count'}`` (AdamW)."""
    if isinstance(state, (tuple, list)) and len(state) == 0:
        return ()
    if isinstance(state, dict) and set(state) == {"mu", "nu", "count"}:
        return {"mu": half(state["mu"], cfg, device),
                "nu": half(state["nu"], cfg, device),
                "count": to_tensor(state["count"], device)}
    return half(state, cfg, device)


def train_state_from_reference(state, cfg: ModelConfig, device="cpu"):
    """A reference ``engine.TrainState`` (numpy leaves) -> the port's
    :class:`repro_torch.core.engine.TrainState`: params in the training
    layout, each half's optimizer state converted alike, the step as an
    int."""
    from repro_torch.core.engine import TrainState

    opt = state.opt_state
    client, server = _halves(cfg)
    return TrainState(
        params=train_params_from_reference(state.params, cfg, device),
        opt_state={"client": _opt_half(opt["client"], client, cfg, device),
                   "server": _opt_half(opt["server"], server, cfg, device)},
        step=int(np.asarray(state.step)))


def _nest(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _params_tree_from_npz(path: str):
    """The reference params tree of a ``repro.checkpoint`` file: a params
    checkpoint (merged or K-stacked client half), or a full training-state
    one whose params sit under the ``.inner/.params/`` key prefix."""
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
    return _nest(flat)


def params_from_npz(path: str, cfg: ModelConfig, device="cpu"):
    """Merged port params (for serving) from a ``repro.checkpoint``
    file."""
    return params_from_reference(_params_tree_from_npz(path), cfg, device)


def train_params_from_npz(path: str, cfg: ModelConfig, device="cpu"):
    """Port training params (the client half's K axis kept) from a
    ``repro.checkpoint`` file."""
    return train_params_from_reference(_params_tree_from_npz(path), cfg,
                                       device)


def baseline_state_from_reference(tree, method: str, device="cpu"):
    """A reference baseline state (numpy leaves; leading slot axes kept)
    -> the port's. For an FL method: the AlexNet weights, or its round
    state ``{'h': slot-stacked weights (FedDyn), 'server_opt': FedOpt's
    state}``; for an SFL method ``{'wc', 'ws'}`` and sfl_localloss's
    ``'aux'`` head (its (feat_dim, N) weight applies unchanged: the port
    flattens in the reference's NHWC order)."""
    from repro_torch.core.baselines import FL_METHODS, SFL_METHODS

    conv = lambda sub: alexnet_params_from_reference(sub, device)
    if method in FL_METHODS:
        if tree and set(tree) <= {"h", "server_opt"}:
            out = {}
            if "h" in tree:
                out["h"] = conv(tree["h"])
            if "server_opt" in tree:
                out["server_opt"] = _opt_half(
                    tree["server_opt"], lambda t, cfg, dev: conv(t), None,
                    device)
            return out
        return conv(tree)
    if method not in SFL_METHODS:
        raise ValueError(f"{method!r} is not an FL/SFL baseline")
    out = {"wc": conv(tree["wc"]), "ws": conv(tree["ws"])}
    if "aux" in tree:
        out["aux"] = {"w": to_tensor(tree["aux"]["w"], device)}
    return out


def _listify(tree):
    """Nested dicts from :func:`_nest` with the reference's lists back:
    a dict whose keys are all indices becomes a list."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def program_state_from_reference(flat: Dict[str, np.ndarray], spec,
                                 device="cpu"):
    """``(inner, fed)`` of the port's program state from a reference
    ``Trainer.save`` checkpoint's arrays (``.inner/...``, ``.fed/...``
    keys): the SCALA state (params, optimizer state, step) or a
    baseline's, and a dict of the federation entries the file holds
    (FedDyn's ``h``, a server optimizer's ``server_opt``; a state with
    no leaves, such as SGD's, is absent), which the caller lays over its
    own initial ``fed``. A federation state that holds the JAX
    scheduler's key (masked / sparse with a participation spec) raises
    ValueError: the port's scheduler cannot continue it."""
    from types import SimpleNamespace

    from repro_torch.core.baselines import FL_METHODS, SFL_METHODS

    tree = _listify(_nest(flat))
    inner, fed = tree[".inner"], tree.get(".fed") or {}
    if spec.method in FL_METHODS + SFL_METHODS:
        return (baseline_state_from_reference(inner, spec.method, device),
                baseline_state_from_reference(fed, spec.method, device)
                if fed else {})
    if "sched" in fed:
        raise ValueError(
            "this reference checkpoint's federation state holds the JAX "
            "participation scheduler's jax.random key, which the port "
            "cannot continue (it draws its masks from numpy): resume "
            "refuses it; start from its params instead (--init-params)")
    if set(fed) - {"server_opt"}:
        raise ValueError(
            "this reference checkpoint holds the async runtime's state, "
            "whose jax.random key drives its delays; the port draws them "
            "from numpy and cannot continue it: resume refuses it (its "
            "schedule converts with async_state_from_reference, its params "
            "start a run with --init-params)")
    cfg = spec.model_config()
    state = SimpleNamespace(
        params=inner[".params"],
        opt_state=inner.get(".opt_state", {"client": (), "server": ()}),
        step=inner[".step"])
    parts = {}
    if fed:      # server FedOpt's state, over the server half
        parts["server_opt"] = _opt_half(fed["server_opt"], _halves(cfg)[1],
                                        cfg, device)
    return train_state_from_reference(state, cfg, device), parts


def async_state_from_reference(afed, cfg: ModelConfig, seed: int,
                               device="cpu"):
    """A reference ``repro.fed.AsyncFedState`` (numpy leaves, or any
    object with its fields) -> the port's :class:`repro_torch.fed.
    AsyncFedState`: the schedule (``version``, ``finish_time``,
    ``server_version``, ``now``, ``retries``, ``ring_versions``) as host
    numpy in the reference's dtypes, the dense snapshots or the delta
    ring in the port's client layout, the server optimizer's state and
    the guards' running median.
    ``key`` is dropped: the port's delays come from the numpy stream
    ``seed`` (or a recorded model), so both packages can start from one
    state with the same delays injected."""
    from repro_torch.fed.runtime import AsyncFedState

    client, server = _halves(cfg)
    empty = lambda t: isinstance(t, (tuple, list)) and len(t) == 0  # noqa
    half = lambda t: () if empty(t) else client(t, cfg, device)     # noqa
    retries = afed.retries
    K = np.shape(afed.version)[0]
    return AsyncFedState(
        client_params=half(afed.client_params),
        version=np.array(afed.version, np.int32),
        server_version=int(np.asarray(afed.server_version)),
        finish_time=np.array(afed.finish_time, np.float32),
        now=np.float32(np.asarray(afed.now)),
        seed=int(seed),
        agg_state=() if empty(afed.agg_state) else _map(
            lambda a: to_tensor(a, device), afed.agg_state),
        server_opt=_opt_half(afed.server_opt, server, cfg, device),
        ring=half(afed.ring),
        ring_versions=(() if empty(afed.ring_versions)
                       else np.array(afed.ring_versions, np.int32)),
        retries=(np.zeros((K,), np.int32) if empty(retries)
                 else np.array(retries, np.int32)),
        guard=() if empty(getattr(afed, "guard", ())) else _map(
            lambda a: to_tensor(a, device), afed.guard))
