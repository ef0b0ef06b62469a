"""Nested-dict trees of tensors (the port's stand-in for ``jax.tree_util``).

Leaves are visited in sorted-key order, as ``jax.tree_util`` flattens a
dict, so leaf ``i`` here is leaf ``i`` of the reference's tree — what lets
a per-leaf random stream line up with the reference's per-leaf keys.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_paths", "tree_unflatten", "tree_map"]

PyTree = Any


def tree_paths(tree: PyTree, prefix: str = "") -> list[str]:
    """Dotted path of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}{k}.")]
    return [prefix.rstrip(".")]


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
