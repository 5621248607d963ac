"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

Parameters and optimizer moments are NamedTuples (``MRParams``,
``GRUParams``), tuples, lists or dicts of tensors; these helpers walk them in
a fixed order. The batch and stream modes keep one such tree whose every leaf
has a leading system or slot axis (what ``jax.vmap`` maps over in the JAX
package): ``tree_stack`` builds it, ``tree_index`` reads one slot and
``tree_write_slot`` overwrites one in place.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


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


def tree_stack(trees: list) -> Any:
    """One tree whose leaves stack those of ``trees`` along a new axis 0."""
    columns = zip(*(tree_leaves(t) for t in trees))
    return tree_unflatten(trees[0], [torch.stack(col) for col in columns])


def tree_index(tree: Any, i: int) -> Any:
    """Slot ``i`` of a stacked tree (views of its leaves)."""
    return tree_map(lambda leaf: leaf[i], tree)


@torch.no_grad()
def tree_write_slot(tree: Any, i: int, one: Any) -> None:
    """Overwrite slot ``i`` of a stacked tree with the leaves of ``one``."""
    for full, new in zip(tree_leaves(tree), tree_leaves(one)):
        full[i].copy_(torch.as_tensor(new, dtype=full.dtype, device=full.device))
