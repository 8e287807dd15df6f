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

from repro_torch.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class Optimizer:
    """``update(grads, state, params, lr, donate=False) -> (new_params,
    new_state)``. ``donate=True``: the caller gives up ``params`` and
    ``state`` (it never reads them again), so SGD and momentum write the
    new values into their dense tensors, in every bit what they would
    return otherwise; a stacked client half of qwen1.5-0.5b over 16 slots
    is ~11.7 GB a copy, and a functional update holds two copies more."""

    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _math_dtype(a):
    return torch.promote_types(a.dtype, torch.float32)


def _math(a):
    """``a`` in float32, or in float64 when it already is (a float64
    reference run keeps its precision)."""
    return a.to(_math_dtype(a))


def _slices(a, n: int = 1 << 26):
    """``a`` split along its first axis into views of at most ~n entries."""
    if a.dim() == 0 or a.numel() <= n:
        return (a,)
    return a.split(max(1, n // max(1, a[0].numel())))


def _owned(a, donate: bool) -> bool:
    """Whether ``a`` may be overwritten: donated and dense (a broadcast
    client half, stride 0 over its slots, is shared by every slot)."""
    return donate and a.is_contiguous()


def _descend(p, d, lr, donate=False):
    """``p - lr * d`` in ``_math(d)``'s dtype, cast back to p's, as
    ``(-lr) * d + p``: the same in every bit (IEEE negation is exact).
    Computed slice by slice (:func:`_slices`), so no float32 temporary is
    larger than a slice: a bf16 leaf (the 4-slot embedding of a 6-layer
    internvl2-26b is 9.1 GB in float32) would otherwise take three float32
    copies of itself. A donated dense p of that dtype takes the result in
    place."""
    if _owned(p, donate) and p.dtype == _math_dtype(d):
        for ps, ds in zip(_slices(p), _slices(d)):
            ps.add_(torch.mul(_math(ds), -lr))
        return p
    out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    own_dtype = p.dtype == _math_dtype(d)
    for os_, ps, ds in zip(_slices(out), _slices(p), _slices(d)):
        if own_dtype:      # the product written into the result: no copy
            torch.mul(_math(ds), -lr, out=os_).add_(ps)
        else:
            os_.copy_(torch.mul(_math(ds), -lr).add_(_math(ps)))
    return out


def sgd(weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr, donate=False):
        def step(p, g):
            # g keeps its dtype: _descend upcasts it a slice at a time
            if weight_decay:
                g = _math(g) + weight_decay * _math(p)
            return _descend(p, g, lr, donate)
        return tree_map(step, params, grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(_zeros, params)

    def update(grads, state, params, lr, donate=False):
        def step(p, g, m):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            # beta * m + g
            m_new = (m.mul_(beta) if _owned(m, donate)
                     else torch.mul(m, beta)).add_(g)
            d = g + beta * m_new if nesterov else m_new
            return _descend(p, d, lr, donate), m_new

        both = [step(p, g, m) for p, g, m in zip(
            leaves(params), leaves(grads), leaves(state))]
        return (unflatten(params, [b[0] for b in both]),
                unflatten(state, [b[1] for b in both]))

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = leaves(params)[0].device
        return {"mu": tree_map(_zeros, params), "nu": tree_map(_zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr, donate=False):
        # out of place whatever ``donate`` says
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
