"""Client-model aggregation, the FL phase of a round.

An :class:`Aggregator` turns the round's :class:`AggContext` into
normalized per-client weights; the round runner averages the stacked
client halves with them (eq. 10):

  ============================  ============================================
  aggregator                    per-client weight (before normalization)
  ============================  ============================================
  :func:`fedavg`                ``mask_k`` (uniform over the participants)
  :func:`weighted`              ``mask_k * n_k`` (eq. 10, the default)
  :func:`bias_compensated`      ``mask_k * n_k * exp(-gamma * TV(P_k, P))``
  :func:`staleness_weighted`    ``mask_k * n_k * decay^age_k`` (age_k: rounds
                                since client k last took part, in the
                                aggregator's state)
  :func:`hierarchical`          ``within_edge_k * top_e`` (edges fold their
                                own clients, the server folds the edges)
  ============================  ============================================

Every weight goes through the mask-safe
:func:`repro_torch.core.split.normalize_client_weights`, so absent
clients (mask 0 or size 0) drop out without NaNs; every rule is a few
tensor operations on the weights' device, with no host copy.

``shard_local`` (``fedavg``, ``weighted``, ``hierarchical``) gives the raw
weights of one client shard's slots on a grid of ranks (the ``lace_dp``
sparse round and async event): the caller's global renormalization of
``raw * decay * mask`` (a sum over the client shards) reproduces the
flat weights. A stateful or prior-aware aggregator has none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.label_stats import client_and_concat_priors
from repro_torch.core.split import normalize_client_weights, weighted_mean

AGGREGATORS = ("fedavg", "weighted", "bias_compensated", "staleness_weighted",
               "hierarchical")


def aggregation_priors(num_classes: int, labels, weights=None,
                       client_axis: int = 0):
    """(P_k (C, N), P_global (N,)) over one round's labels for the
    prior-aware aggregators; ``labels`` / ``weights`` carry the client
    axis at ``client_axis`` (engine round batches: 1; baseline batches:
    0). Zero-weight entries (padding rows) are left out; the participation
    mask is not applied, so P_global is the whole population's."""
    C = labels.shape[client_axis]
    lab = labels.movedim(client_axis, 0).reshape(C, -1)
    w = (None if weights is None
         else weights.movedim(client_axis, 0).reshape(C, -1))
    return client_and_concat_priors(lab, num_classes, w)


@dataclass(frozen=True)
class AggContext:
    """Per-round inputs: num_clients C (the stacked slot count); mask
    (C,) 0/1 or None (full participation); data_sizes (C,) or None
    (uniform); p_k (C, N) and p_global (N,), the round's label priors,
    given only to an aggregator that ``needs_priors``."""

    num_clients: int = 0
    mask: Optional[Any] = None
    data_sizes: Optional[Any] = None
    p_k: Optional[Any] = None
    p_global: Optional[Any] = None

    @property
    def C(self) -> int:
        if self.num_clients:
            return self.num_clients
        for a in (self.mask, self.data_sizes, self.p_k):
            if a is not None:
                return a.shape[0]
        raise ValueError("AggContext cannot resolve the client count; set "
                         "num_clients")

    @property
    def device(self):
        for a in (self.mask, self.data_sizes, self.p_k):
            if a is not None:
                return a.device
        return torch.device("cpu")

    def ones(self):
        return torch.ones(self.C, dtype=torch.float32, device=self.device)

    def base_weights(self):
        """data_sizes, or ones when None."""
        if self.data_sizes is not None:
            return self.data_sizes.float()
        return self.ones()


@dataclass(frozen=True)
class Aggregator:
    """``init(num_clients, device) -> state`` builds the (possibly empty)
    carry; ``client_weights(ctx, state) -> (weights (C,), state)`` gives
    normalized weights; ``aggregate`` is the weighted mean of the stacked
    client params with them."""

    name: str
    init: Callable[..., Any]
    client_weights: Callable[[AggContext, Any], Tuple[Any, Any]]
    needs_priors: bool = False
    stateful: bool = False
    #: ``shard_local(mask_l, sizes_l, reduce=None, n_shards=1) -> (C_l,)``
    #: raw weights of one shard's local slot block; ``reduce`` sums a
    #: tensor over the client shards (None: one shard). None when the
    #: aggregator cannot run on a sharded client axis.
    shard_local: Optional[Callable] = None

    def aggregate(self, stacked_params, ctx: AggContext, state=()):
        """(stacked (C, ...) client params, ctx, state) -> (averaged
        client params, new state)."""
        w, state = self.client_weights(ctx, state)
        return weighted_mean(stacked_params, w), state


def _stateless_init(num_clients: int, device=None):
    return ()


def fedavg() -> Aggregator:
    """Uniform average over the participating clients."""

    def client_weights(ctx: AggContext, state):
        return normalize_client_weights(ctx.ones(), ctx.mask), state

    def shard_local(mask_l, sizes_l, reduce=None, n_shards: int = 1):
        return torch.ones_like(mask_l, dtype=torch.float32)

    return Aggregator(name="fedavg", init=_stateless_init,
                      client_weights=client_weights, shard_local=shard_local)


def weighted() -> Aggregator:
    """Data-size proportional FedAvg (eq. 10); uniform without sizes."""

    def client_weights(ctx: AggContext, state):
        return normalize_client_weights(ctx.base_weights(), ctx.mask), state

    def shard_local(mask_l, sizes_l, reduce=None, n_shards: int = 1):
        return sizes_l.float()

    return Aggregator(name="weighted", init=_stateless_init,
                      client_weights=client_weights, shard_local=shard_local)


def bias_compensated(gamma: float = 2.0) -> Aggregator:
    """BESplit-style bias compensation: client k's weight decays with the
    total-variation distance of its round label distribution P_k from the
    global prior P, ``w_k ∝ mask_k n_k exp(-gamma TV(P_k, P))``; gamma = 0
    is :func:`weighted`."""

    def client_weights(ctx: AggContext, state):
        if ctx.p_k is None or ctx.p_global is None:
            raise ValueError("bias_compensated needs ctx.p_k/p_global "
                             "(round label priors)")
        tv = 0.5 * (ctx.p_k.float() - ctx.p_global.float()[None]).abs().sum(-1)
        w = ctx.base_weights() * torch.exp(-gamma * tv)
        return normalize_client_weights(w, ctx.mask), state

    return Aggregator(name="bias_compensated", init=_stateless_init,
                      client_weights=client_weights, needs_priors=True)


def staleness_weighted(decay: float = 0.5) -> Aggregator:
    """GAS-style staleness decay: state ``{'age': (C,)}``, the rounds since
    each client last took part; a returning client's weight is scaled by
    ``decay ** age``. Participants' ages reset to 0, absentees' grow by 1.
    Needs stable client identities (a participation scheduler over the
    static slots): under full participation every age stays 0 and this
    is :func:`weighted`."""

    def init(num_clients: int, device=None):
        return {"age": torch.zeros(num_clients, dtype=torch.float32,
                                   device=device)}

    def client_weights(ctx: AggContext, state):
        age = state["age"]
        w = ctx.base_weights() * torch.pow(
            torch.tensor(decay, dtype=torch.float32, device=age.device), age)
        w = normalize_client_weights(w, ctx.mask)
        mask = ctx.mask if ctx.mask is not None else torch.ones_like(age)
        return w, {"age": torch.where(mask > 0, torch.zeros_like(age),
                                      age + 1.0)}

    return Aggregator(name="staleness_weighted", init=init,
                      client_weights=client_weights, stateful=True)


def hierarchical(edges: int, edge: str = "weighted",
                 top: str = "weighted") -> Aggregator:
    """Two-tier (edge -> server) aggregation over ``edges`` contiguous slot
    blocks: each edge folds its participants with the ``edge`` rule
    (``weighted``: by data size; ``fedavg``: uniform), the server folds the
    edges with the ``top`` rule (``weighted``: by the edge's participating
    data mass; ``fedavg``: uniform over non-empty edges), as one flat
    weight ``w_k = within_edge(k) * top(edge_of(k))``. Weighted / weighted
    is exactly :func:`weighted`; an empty edge gets weight 0, and a round
    with no participant at all falls back to the flat normalization. C
    must divide by ``edges``."""
    if edge not in ("fedavg", "weighted") or top not in ("fedavg",
                                                         "weighted"):
        raise ValueError(f"hierarchical tiers must be 'fedavg' or "
                         f"'weighted', got edge={edge!r} top={top!r}")
    if edges < 1:
        raise ValueError(f"edges must be >= 1, got {edges}")

    def tiers(mask, sizes, n_edges):
        """(within-edge weights (C,), edge masses T (n_edges,))."""
        C = mask.shape[0]
        if C % n_edges:
            raise ValueError(f"{C} client slots do not divide into "
                             f"{n_edges} edges")
        base = sizes if edge == "weighted" else torch.ones_like(sizes)
        raw = (base * mask).reshape(n_edges, C // n_edges)
        S = raw.sum(1)
        within = (raw / S.clamp(min=1e-8)[:, None]).reshape(C)
        T = torch.where(S > 0, S if top == "weighted" else torch.ones_like(S),
                        torch.zeros_like(S))
        return within, T

    def client_weights(ctx: AggContext, state):
        C = ctx.C
        mask = ctx.mask.float() if ctx.mask is not None else ctx.ones()
        within, T = tiers(mask, ctx.base_weights(), edges)
        tot = T.sum()
        w = within * torch.repeat_interleave(T / tot.clamp(min=1e-8),
                                             C // edges)
        fallback = normalize_client_weights(ctx.ones(), ctx.mask)
        return torch.where(tot > 0, w, fallback), state

    def shard_local(mask_l, sizes_l, reduce=None, n_shards: int = 1):
        if edges % n_shards:
            raise ValueError(f"hierarchical edges={edges} must divide over "
                             f"the {n_shards} client shards")
        edges_l = edges // n_shards
        within, T = tiers(mask_l.float(), sizes_l.float(), edges_l)
        tot = T.sum()
        if reduce is not None:
            tot = reduce(tot)
        return within * torch.repeat_interleave(T / tot.clamp(min=1e-8),
                                                mask_l.shape[0] // edges_l)

    return Aggregator(name="hierarchical", init=_stateless_init,
                      client_weights=client_weights, shard_local=shard_local)


def make_aggregator(spec: str) -> Aggregator:
    """``"fedavg"`` | ``"weighted"`` | ``"bias_compensated[:GAMMA]"`` |
    ``"staleness_weighted[:DECAY]"`` (alias ``staleness``) |
    ``"hierarchical:EDGES[:EDGE[:TOP]]"``; without GAMMA or DECAY, the
    aggregator's own default (2.0, 0.5, as in the reference)."""
    parts = spec.split(":")
    name, args = parts[0], parts[1:]
    if name in ("fedavg", "weighted") and args:
        raise ValueError(f"aggregator {name!r} takes no spec arguments, "
                         f"got {spec!r}")
    if name == "fedavg":
        return fedavg()
    if name == "weighted":
        return weighted()
    if name == "bias_compensated":
        if len(args) > 1:
            raise ValueError("bias_compensated spec is "
                             "'bias_compensated[:GAMMA]'")
        return (bias_compensated(gamma=float(args[0])) if args
                else bias_compensated())
    if name == "hierarchical":
        if not args or len(args) > 3:
            raise ValueError("hierarchical spec is "
                             "'hierarchical:EDGES[:EDGE[:TOP]]'")
        return hierarchical(edges=int(args[0]),
                            edge=args[1] if len(args) > 1 else "weighted",
                            top=args[2] if len(args) > 2 else "weighted")
    if name in ("staleness_weighted", "staleness"):
        if len(args) > 1:
            raise ValueError("staleness_weighted spec is "
                             "'staleness_weighted[:DECAY]'")
        return (staleness_weighted(decay=float(args[0])) if args
                else staleness_weighted())
    raise ValueError(f"unknown aggregator {name!r}; expected {AGGREGATORS}")
