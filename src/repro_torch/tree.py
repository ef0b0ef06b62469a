"""Trees of tensors, nested dicts and lists (the port's stand-in for
``jax.tree_util``).

Leaves are visited as ``jax.tree_util`` flattens: a dict in sorted-key
order, a list in its own order, so leaf ``i`` here is leaf ``i`` of the
reference's tree — what lets a per-leaf random stream line up with the
reference's per-leaf keys. Anything else, a tuple included, is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_paths", "tree_unflatten", "tree_map", "tree_pop_leaves"]

PyTree = Any


def tree_paths(tree: PyTree, prefix: str = "") -> list[str]:
    """Dotted path of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [p for i, t in enumerate(tree) for p in tree_paths(t, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """A tree shaped like ``like`` holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(t) for t in node]
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_pop_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in leaf order, each replaced by None in its
    container: the caller then holds the only references, and can release
    a leaf by dropping it from the list."""
    leaves = tree_leaves(tree)

    def clear(node):
        for k in (list(node) if isinstance(node, dict) else range(len(node))):
            if isinstance(node[k], (dict, list)):
                clear(node[k])
            else:
                node[k] = None

    clear(tree)
    return leaves
