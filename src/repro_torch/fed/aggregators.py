"""Client-model aggregation, the FL phase of a round.

An :class:`Aggregator` turns the round's :class:`AggContext` into
normalized per-client weights; the round runner averages the stacked
client halves with them (eq. 10). Ported: ``fedavg`` (uniform over the
participants) and ``weighted`` (data-size proportional, the default).
The prior-aware, staleness and hierarchical aggregators of
:mod:`repro.fed.aggregators` wait for the federation slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.split import normalize_client_weights

AGGREGATORS = ("fedavg", "weighted", "bias_compensated", "staleness_weighted",
               "hierarchical")
PORTED = ("fedavg", "weighted")


@dataclass(frozen=True)
class AggContext:
    """Per-round inputs: num_clients C (the stacked slot count); mask
    (C,) 0/1 or None (full participation); data_sizes (C,) or None
    (uniform)."""

    num_clients: int = 0
    mask: Optional[Any] = None
    data_sizes: Optional[Any] = None

    @property
    def C(self) -> int:
        if self.num_clients:
            return self.num_clients
        for a in (self.mask, self.data_sizes):
            if a is not None:
                return a.shape[0]
        raise ValueError("AggContext cannot resolve the client count; set "
                         "num_clients")

    def base_weights(self, device=None):
        """data_sizes, or ones when None."""
        if self.data_sizes is not None:
            return self.data_sizes.float()
        return torch.ones(self.C, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class Aggregator:
    """``client_weights(ctx, state) -> (weights (C,), state)``, normalized
    (the state is the reference's; the ported aggregators keep none)."""

    name: str
    client_weights: Callable[[AggContext, Any], Tuple[Any, Any]]


def fedavg() -> Aggregator:
    """Uniform average over the participating clients."""

    def client_weights(ctx: AggContext, state):
        w = torch.ones(ctx.C, dtype=torch.float32)
        if ctx.mask is not None:
            w = w.to(ctx.mask.device)
        elif ctx.data_sizes is not None:
            w = w.to(ctx.data_sizes.device)
        return normalize_client_weights(w, ctx.mask), state

    return Aggregator(name="fedavg", client_weights=client_weights)


def weighted() -> Aggregator:
    """Data-size proportional FedAvg (eq. 10); uniform without sizes."""

    def client_weights(ctx: AggContext, state):
        device = ctx.mask.device if ctx.mask is not None else None
        return normalize_client_weights(ctx.base_weights(device),
                                        ctx.mask), state

    return Aggregator(name="weighted", client_weights=client_weights)


def make_aggregator(spec: str) -> Aggregator:
    """``"fedavg"`` | ``"weighted"``; the reference's other specs raise
    NotImplementedError."""
    parts = spec.split(":")
    name, args = parts[0], parts[1:]
    if name in PORTED and args:
        raise ValueError(f"aggregator {name!r} takes no spec arguments, "
                         f"got {spec!r}")
    if name == "fedavg":
        return fedavg()
    if name == "weighted":
        return weighted()
    if name in AGGREGATORS or name == "staleness":
        raise NotImplementedError(
            f"aggregator {spec!r} is not ported yet (the port has "
            f"{PORTED}); the prior-aware, staleness and hierarchical "
            "aggregators come with the federation slice")
    raise ValueError(f"unknown aggregator {name!r}; expected {AGGREGATORS}")
