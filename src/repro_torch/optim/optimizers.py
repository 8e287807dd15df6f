"""Functional optimizers on param trees: SGD (the paper's default, §5.1),
momentum and AdamW. The math runs in float32 and the new params are cast
back to each param's dtype, as in the reference (SGD keeps float64
params in float64, for the float64 reference runs of the card checks).

``update(grads, state, params, lr) -> (new_params, new_state)``; the
state mirrors the reference's tree (``()`` for SGD, a params-shaped tree
for momentum, ``{'mu', 'nu', 'count'}`` for AdamW), so a reference
optimizer state converts leaf for leaf. Client halves pass stacked
(C, ...) leaves: every rule is elementwise, and AdamW's step count may be
a (C,) tensor, one per client.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, float], Tuple[Any, Any]]


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _math(a):
    """``a`` in float32, or in float64 when it already is (a float64
    reference run keeps its precision)."""
    return a.to(torch.promote_types(a.dtype, torch.float32))


def sgd(weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        def step(p, g):
            g = _math(g)
            if weight_decay:
                g = g + weight_decay * _math(p)
            return (_math(p) - lr * g).to(p.dtype)
        return tree_map(step, params, grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(_zeros, params)

    def update(grads, state, params, lr):
        def step(p, g, m):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            m_new = beta * m + g
            d = g + beta * m_new if nesterov else m_new
            return (p.float() - lr * d).to(p.dtype), m_new

        both = tree_map(step, params, grads, state)
        return _split(both, 0), _split(both, 1)

    return Optimizer(init, update)


def _split(tree, i):
    """Component ``i`` of a tree whose leaves are (param, state) pairs."""
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = leaves(params)[0].device
        return {"mu": tree_map(_zeros, params), "nu": tree_map(_zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def per_leaf(c, a):
            # a (C,) count broadcasts over the stacked client axis
            return c.reshape(c.shape + (1,) * (a.dim() - c.dim()))

        mu = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads,
                      state["mu"])
        nu = tree_map(lambda g, v: b2 * v + (1 - b2) * g.float() * g.float(),
                      grads, state["nu"])

        def step(p, m, v):
            upd = (m / per_leaf(c1, m)) / (torch.sqrt(v / per_leaf(c2, v))
                                           + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        return (tree_map(step, params, mu, nu),
                {"mu": mu, "nu": nu, "count": count})

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(weight_decay=kw.get("weight_decay", 0.0))
    if name == "momentum":
        return momentum(beta=kw.get("momentum", 0.9),
                        weight_decay=kw.get("weight_decay", 0.0))
    if name == "adamw":
        return adamw(weight_decay=kw.get("weight_decay", 0.0))
    raise ValueError(f"unknown optimizer {name!r}")
