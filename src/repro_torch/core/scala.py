"""Model adapters: a model's two halves as a :class:`SplitModel`; and
the reference's three legacy steps, each a name for an engine backend
with plain SGD (deprecated, each warning once a process):

  ===========================  ==============
  legacy entry point           engine backend
  ===========================  ==============
  scala_local_step             ``"logits"``
  scala_local_step_fused       ``"lace"``
  scala_local_step_fused_dp    ``"lace_dp"``
  ===========================  ==============

The dry run (:mod:`repro_torch.launch.dryrun`) steps through them, as the
reference's does."""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ScalaConfig
from repro_torch.core import engine
from repro_torch.core.engine import SplitModel

# legacy entry points that already warned this process (warn once each)
_DEPRECATION_WARNED: set = set()


def _warn_deprecated(name: str, use: str) -> None:
    if name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(name)
    warnings.warn(
        f"repro_torch.core.scala.{name} is a legacy compatibility shim; use "
        f"{use} instead (the engine threads optimizers/schedules and runs "
        "the whole round -- see repro_torch.core.engine and repro_torch."
        "fed)", DeprecationWarning, stacklevel=3)


def scala_local_step(model: SplitModel, params, batch, scala: ScalaConfig,
                     *, lr: Optional[float] = None):
    """One SCALA local iteration with plain SGD on the materialized-logits
    backend: params ``{'client': stacked (C, ...), 'server': ...}``, batch
    leaves (C, B_k, ...); returns (params, metrics).

    .. deprecated:: use :func:`repro_torch.core.engine.make_split_step`
       (``backend="logits"``).
    """
    _warn_deprecated("scala_local_step",
                     "engine.make_split_step(backend='logits')")
    return engine.local_step(model, params, batch, scala, backend="logits",
                             lr=lr)


def scala_local_step_fused(model: SplitModel, params, batch,
                           scala: ScalaConfig, *, lr: Optional[float] = None,
                           ce_chunk: Optional[int] = None):
    """:func:`scala_local_step` with the fused LACE loss: the head product
    and the adjusted cross-entropy in one pass that never materializes
    the (tokens, V) logits (K1 + K2 on a card).

    .. deprecated:: use :func:`repro_torch.core.engine.make_split_step`
       (``backend="lace"``).
    """
    _warn_deprecated("scala_local_step_fused",
                     "engine.make_split_step(backend='lace')")
    return engine.local_step(model, params, batch, scala, backend="lace",
                             lr=lr, ce_chunk=ce_chunk)


def scala_local_step_fused_dp(model: SplitModel, params, batch,
                              scala: ScalaConfig, mesh, batch_specs, *,
                              lr: Optional[float] = None,
                              ce_chunk: Optional[int] = None):
    """One SCALA local iteration with plain SGD on backend ``lace_dp``
    over the grid ``mesh`` (params this rank's, the batch global, cut by
    ``batch_specs``): :func:`repro_torch.core.engine.local_step`.

    .. deprecated:: use :func:`repro_torch.core.engine.make_split_step`
       (``backend="lace_dp"``).
    """
    _warn_deprecated("scala_local_step_fused_dp",
                     "engine.make_split_step(backend='lace_dp')")
    return engine.local_step(model, params, batch, scala, backend="lace_dp",
                             lr=lr, ce_chunk=ce_chunk, mesh=mesh,
                             batch_specs=batch_specs)


def transformer_split_model(cfg: ModelConfig, *, remat=None) -> SplitModel:
    """The transformer's client half (embedding + ``split_layer``
    blocks) and server half (the rest + final norm + head). ``remat``:
    the server's scan groups recomputed on the backward pass
    (``models.transformer.server_forward``; None: on for the recurrent
    archs). The reference's ``dp_loss`` (the ``lace`` backend's loss
    reduced over an ambient mesh) has no counterpart: the port has no
    ambient mesh, and its ``lace_dp`` backend reduces over an explicit
    grid.

    A frontend arch's batch carries its encoder output: an audio arch's
    client half uploads the projected ``memory`` beside ``x``, which the
    engine concatenates and hands to ``server_fwd`` / ``server_trunk``;
    a vision arch's ``x`` holds the projected image prefix before the
    text, so its ``labels`` and ``weights`` cover the prefix rows too
    (weight 0: the priors and losses leave them out)."""
    from repro_torch.models import transformer as T

    def client_fwd(wc, batch):
        return T.client_forward(wc, batch, cfg)

    def server_fwd(ws, acts):
        return T.server_forward(ws, acts, cfg, remat=remat)

    def server_trunk(ws, acts):
        return T.server_forward(ws, acts, cfg, head_mode="feats",
                                remat=remat)

    def head_weight(ws):
        return ws["head"]["out"]

    def head_grad_merge(d_ws, g_w):
        d_ws = dict(d_ws)
        d_ws["head"] = {"out": d_ws["head"]["out"] + g_w.to(
            d_ws["head"]["out"].dtype)}
        return d_ws

    return SplitModel(client_fwd=client_fwd, server_fwd=server_fwd,
                      num_classes=cfg.vocab_size, server_trunk=server_trunk,
                      head_weight=head_weight,
                      head_grad_merge=head_grad_merge)


def alexnet_split_model(split: str = "s2", num_classes: int = 10) -> SplitModel:
    """AlexNet's client convs and server rest: the ``logits`` backend
    only (no trunk/head split, as in the reference)."""
    from repro_torch.models import alexnet as A

    def client_fwd(wc, batch):
        return {"x": A.client_forward_from_split(wc, batch["x"], split)}

    def server_fwd(ws, acts):
        logits = A.server_forward_from_split(ws, acts["x"], split)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    return SplitModel(client_fwd=client_fwd, server_fwd=server_fwd,
                      num_classes=num_classes)
