"""Nested-dict param trees: the port's stand-in for JAX pytrees.

A tree is a dict of trees, a tuple of trees, or a leaf (a tensor, or any
other value such as None). Dicts keep their key order, so two trees of
one structure flatten to leaves in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree) -> List[Any]:
    """The leaves in order (an empty tuple has none)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, values):
    """A tree of ``tree``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more values than leaves")
    return out
