"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

Parameters and optimizer moments are NamedTuples (``MRParams``,
``GRUParams``), tuples, lists or dicts of tensors; these helpers walk them in
a fixed order.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree``, depth first, dicts in key order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, keeping its structure."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` (in ``tree_leaves`` order)."""
    return _rebuild(tree, iter(leaves))


def _rebuild(tree: Any, it) -> Any:
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(sub, it) for sub in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(sub, it) for sub in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)
