"""Nested-dict trees: the parameter, optimizer and checkpoint trees of the
port (the counterpart of ``jax.tree`` over the JAX package's dicts).

A leaf's name is its key path joined by ``.``, and leaves come in the order
of ``jax.tree.leaves`` (keys sorted at every level), so a leaf has the same
name and place in both frameworks: in a checkpoint's manifest, in the
optimizer's moments and in a list of gradients.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable


def flatten(tree: Any, prefix: str = "") -> dict:
    """``{name: leaf}`` in leaf order."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}{k}."))
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict whose leaves are ``flat``'s values, nested by the
    ``.``-joined names."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def tree_leaves(tree: Any) -> list:
    return list(flatten(tree).values())


def tree_unflatten(tree: Any, leaves: Iterable) -> dict:
    """``tree``'s nesting with ``leaves``, in leaf order, as its leaves."""
    return unflatten(dict(zip(flatten(tree), leaves, strict=True)))


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


__all__ = ["flatten", "tree_leaves", "tree_map", "tree_unflatten", "unflatten"]
