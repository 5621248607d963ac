"""AdamW (counterpart of ``repro/optim/adamw.py``).

m and v are float32 whatever the parameters' type, and the weight decay is
decoupled (Loshchilov & Hutter): applied to the parameter, not folded into
the moment. The state mirrors the parameters' structure.

A state whose ``step`` is [S] updates a tree stacked along a leading slot
axis, each slot with its own step count and learning rate (``lr`` a float or
an [S] tensor): what ``jax.vmap`` of the update gives in the JAX package.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32: a scalar, or [S] for a slot-stacked tree
    m: Any  # like params, float32
    v: Any  # like params, float32


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    lr: float | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[Any, AdamWState]:
    """Returns (new_params, new_state). Params keep their dtype."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def per_slot(x, like):
        if isinstance(x, torch.Tensor) and x.ndim == 1:
            return x.reshape(x.shape + (1,) * (like.ndim - 1))
        return x

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * g32.square()
        delta = (m / per_slot(bc1, m)) / (torch.sqrt(v / per_slot(bc2, v)) + eps)
        p32 = p.to(torch.float32)
        new_p = p32 - per_slot(lr, p32) * (delta + weight_decay * p32)
        return new_p.to(p.dtype), m, v

    leaves = [tree_leaves(t) for t in (grads, state.m, state.v, params)]
    out = [upd(*args) for args in zip(*leaves)]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return tree_unflatten(params, new_p), AdamWState(
        step=step, m=tree_unflatten(params, new_m), v=tree_unflatten(params, new_v)
    )
