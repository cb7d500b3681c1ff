"""Param trees: nested dicts, lists and tuples of tensors (or arrays).

``tree_leaves`` visits leaves in JAX's ``tree_util`` order (dict keys sorted,
lists and tuples in order), so a tree laid out as the reference's has its
leaves in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """``leaves`` (in ``tree_leaves`` order) into the structure of ``like``."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(x) for x in t)
        return next(it)

    return fill(like)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``; a dict key enters the
    path as itself, a list or tuple index as ``"[i]"``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)
