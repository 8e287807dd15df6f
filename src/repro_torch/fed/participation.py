"""Participation scheduling: which clients join each round.

SCALA's partial-participation setting changes the label distribution of
the participating subset every round, so the engine recomputes the
priors and logit adjustments per subset. As in the reference, the client
count C is static (the stacked (C, ...) client layout never changes
shape) and participation is a per-round 0/1 mask over the slots, folded
into the token weights: masked-out clients add nothing to the priors,
the losses or the aggregation.

  =================  =====================================================
  scheduler          per-round subset
  =================  =====================================================
  :func:`full`       everyone, every round (stateless)
  :func:`uniform`    ``m = max(1, round(frac * C))`` clients uniformly
                     without replacement (a random permutation's prefix),
                     optionally balanced over ``shards`` slot blocks
  :func:`dirichlet`  availability p ~ Dirichlet(alpha 1) each round, then
                     m clients without replacement by Gumbel-top-k on
                     log p (the m largest scores, ties to the lower slot)
  =================  =====================================================

The reference draws from ``jax.random`` inside the compiled round; the
port draws each mask on the host, so the round knows its mask (and, in
sparse mode, its gather indices) without a device sync, and its masks are
not the reference's. A scheduler's state is a small int64 CPU tensor
``[seed, count]``: round ``count`` draws from
``np.random.default_rng([seed, count])`` and returns ``[seed, count +
1]``. It lives in ``ProgramState.fed["sched"]``, so the program-state
checkpoint saves it as any other leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

SCHEDULERS = ("full", "uniform", "dirichlet")


@dataclass(frozen=True)
class ParticipationScheduler:
    """``init(seed) -> state``; ``sample(state) -> (mask (C,) float32 0/1
    numpy array, new state)``.

    ``subset_size`` is the static per-round participant count (every
    scheduler samples exactly this many ones); the sparse round sizes its
    dense compute axis from it. ``shards``: the ones are balanced over
    this many contiguous slot blocks (1: unconstrained).
    """

    name: str
    num_clients: int
    init: Callable[[int], Any]
    sample: Callable[[Any], Tuple[np.ndarray, Any]]
    stateful: bool = True
    subset_size: Optional[int] = None
    shards: int = 1


def _subset_size(num_clients: int, frac: float) -> int:
    m = max(1, round(num_clients * frac))
    return min(m, num_clients)


def _seed_state(seed: int):
    return torch.tensor([int(seed), 0], dtype=torch.int64)


def _draw(state):
    """(this round's generator, the state after it)."""
    seed, count = (int(x) for x in state.tolist())
    return (np.random.default_rng([seed, count]),
            torch.tensor([seed, count + 1], dtype=torch.int64))


def _mask(num_clients: int, picks) -> np.ndarray:
    mask = np.zeros(num_clients, np.float32)
    mask[picks] = 1.0
    return mask


def full(num_clients: int) -> ParticipationScheduler:
    """Full participation, as a scheduler."""

    def init(seed):
        return ()

    def sample(state):
        return np.ones(num_clients, np.float32), state

    return ParticipationScheduler(name="full", num_clients=num_clients,
                                  init=init, sample=sample, stateful=False,
                                  subset_size=num_clients)


def uniform(num_clients: int, frac: float,
            shards: int = 1) -> ParticipationScheduler:
    """Uniform sampling without replacement of round(frac * C) clients.

    ``shards > 1`` balances the subset over ``shards`` contiguous slot
    blocks: ``m / shards`` clients drawn uniformly within each block of
    ``C / shards`` slots (m rounded up to a multiple of ``shards``).
    """
    if shards < 1 or num_clients % shards:
        raise ValueError(f"{num_clients} clients do not divide into "
                         f"{shards} shards")
    m = _subset_size(num_clients, frac)
    m = min(num_clients, ((m + shards - 1) // shards) * shards)
    block = num_clients // shards
    m_l = m // shards

    def sample(state):
        rng, state = _draw(state)
        if shards == 1:
            picks = rng.permutation(num_clients)[:m]
        else:
            picks = np.concatenate([s * block + rng.permutation(block)[:m_l]
                                    for s in range(shards)])
        return _mask(num_clients, picks), state

    return ParticipationScheduler(name="uniform", num_clients=num_clients,
                                  init=_seed_state, sample=sample,
                                  subset_size=m, shards=shards)


def dirichlet(num_clients: int, frac: float,
              alpha: float = 0.3) -> ParticipationScheduler:
    """Dirichlet-skewed availability: p ~ Dir(alpha 1) per round, then m
    clients without replacement in proportion to p (Gumbel-top-k)."""
    m = _subset_size(num_clients, frac)

    def sample(state):
        rng, state = _draw(state)
        g = rng.gamma(alpha, size=num_clients)
        avail = g / max(g.sum(), 1e-8)
        score = np.log(avail + 1e-20) + rng.gumbel(size=num_clients)
        # the m largest scores, equal scores to the lower slot id: the
        # reference's lax.top_k rule
        return _mask(num_clients,
                     np.argsort(-score, kind="stable")[:m]), state

    return ParticipationScheduler(name="dirichlet", num_clients=num_clients,
                                  init=_seed_state, sample=sample,
                                  subset_size=m)


def make_participation(spec: str, num_clients: int) -> ParticipationScheduler:
    """``"full"`` | ``"uniform:FRAC[:SHARDS]"`` |
    ``"dirichlet:FRAC[:ALPHA]"``."""
    parts = spec.split(":")
    name = parts[0]
    if name == "full":
        return full(num_clients)
    if name == "uniform":
        if len(parts) not in (2, 3):
            raise ValueError("uniform spec is 'uniform:FRAC[:SHARDS]'")
        shards = int(parts[2]) if len(parts) == 3 else 1
        return uniform(num_clients, float(parts[1]), shards=shards)
    if name == "dirichlet":
        if len(parts) not in (2, 3):
            raise ValueError("dirichlet spec is 'dirichlet:FRAC[:ALPHA]'")
        alpha = float(parts[2]) if len(parts) == 3 else 0.3
        return dirichlet(num_clients, float(parts[1]), alpha=alpha)
    raise ValueError(f"unknown participation scheduler {name!r}; "
                     f"expected {SCHEDULERS}")
