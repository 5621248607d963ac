"""Gradient clipping (counterpart of ``repro/optim/clip.py``)."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(x.to(torch.float32).square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale ``grads`` so their global norm is at most ``max_norm``; returns
    (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm
