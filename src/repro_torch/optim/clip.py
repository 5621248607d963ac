"""Gradient clipping (counterpart of ``repro/optim/clip.py``).

``stacked=True`` clips a tree whose leaves carry a leading slot axis, each
slot by its own norm: what ``jax.vmap`` of the clip gives in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree: Any, stacked: bool = False) -> torch.Tensor:
    """The norm over every leaf: a scalar, or [S] per slot when ``stacked``."""
    if stacked:
        return torch.sqrt(
            sum(x.to(torch.float32).square().flatten(1).sum(1) for x in tree_leaves(tree))
        )
    return torch.sqrt(sum(x.to(torch.float32).square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(
    grads: Any, max_norm: float, stacked: bool = False
) -> tuple[Any, torch.Tensor]:
    """Scale ``grads`` so their global norm is at most ``max_norm``; returns
    (clipped grads, the norm before clipping)."""
    norm = global_norm(grads, stacked)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)

    def clip(g):
        s = scale.reshape(scale.shape + (1,) * (g.ndim - scale.ndim))
        return (g.to(torch.float32) * s).to(g.dtype)

    return tree_map(clip, grads), norm
