"""The LM train step on one device (``repro/parallel/steps.py``).

``TrainState`` is (params in the config's dtype, AdamW's m and v in float32,
step), as in the JAX package. ``make_train_step`` returns the step
function: the loss and its gradients (``models/model.py`` ``train_loss``
under ``torch.autograd``; the gradients in the parameters' dtype), the
global-norm clip to 1.0, then AdamW with decoupled weight decay, each step
giving a new state (nothing is updated in place). ``microbatch`` k > 1 runs
the batch as k sequential slices and sums their gradients in float32 before
dividing by k, as the JAX package's ``lax.scan`` does: less activation
memory for the same arithmetic.

The JAX package jits the step over a mesh with sharded state; the port has
no sharding rules yet and refuses a mesh of more than one device
(``launch/train.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, materialize, tree_map_specs
from repro_torch.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    m: Any
    v: Any
    step: torch.Tensor  # int32 scalar


def _opt_spec_like(spec_tree):
    """m and v specs: the parameters' shapes and axes, float32."""
    return tree_map_specs(
        lambda s: ParamSpec(s.shape, s.axes, dtype="float32", init="zeros"), spec_tree
    )


def train_state_specs(cfg: ModelConfig) -> TrainState:
    ps = M.param_specs(cfg)
    opt = _opt_spec_like(ps)
    return TrainState(params=ps, m=opt, v=_opt_spec_like(ps),
                      step=ParamSpec((), (), dtype="int32", init="zeros"))  # fmt: skip


def init_train_state(generator: torch.Generator, cfg: ModelConfig, device) -> TrainState:
    """Random parameters drawn from ``generator``, zero moments, step 0."""
    params = materialize(generator, M.param_specs(cfg), device)
    opt = adamw_init(params)
    return TrainState(params=params, m=opt.m, v=opt.v, step=opt.step)


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, device, lr: float = 3e-4,
                    weight_decay: float = 0.1, microbatch: int = 1):  # fmt: skip
    """The step ``step_fn(state, batch) -> (state, metrics)`` for batches of
    ``shape`` on ``device`` (``batch``: tensors, moved there when they are
    elsewhere; ``data/pipeline.py`` ``to_device_batch`` makes them). ``metrics``: ``loss``, ``ce``, ``moe_aux`` and
    ``grad_norm`` (before the clip), float32 tensors on the device."""
    if shape.mode != "train":
        raise ValueError(f"make_train_step: shape {shape.name!r} is a {shape.mode} shape")
    B = shape.global_batch
    if microbatch < 1 or B % microbatch:
        raise ValueError(f"make_train_step: microbatch {microbatch} must divide batch {B}")
    device = torch.device(device)

    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = M.train_loss(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def grads_of(params, batch):
        if microbatch == 1:
            return loss_and_grads(params, batch)
        parts = [{k: v[i * B // microbatch : (i + 1) * B // microbatch] for k, v in batch.items()}
                 for i in range(microbatch)]  # fmt: skip
        acc, losses, metrics = None, [], []
        for part in parts:
            loss, m, g = loss_and_grads(params, part)
            g = [x.to(torch.float32) for x in g]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            losses.append(loss)
            metrics.append(m)
        mean = lambda xs: torch.stack(xs).mean(0)
        return (mean(losses), {k: mean([m[k] for m in metrics]) for k in metrics[0]},
                [a / microbatch for a in acc])  # fmt: skip

    def step_fn(state: TrainState, batch: dict):
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        loss, metrics, grads = grads_of(state.params, batch)
        grads, gnorm = clip_by_global_norm(tree_unflatten(state.params, list(grads)), 1.0)
        opt = AdamWState(step=state.step, m=state.m, v=state.v)
        params, opt = adamw_update(grads, opt, state.params, lr=lr, weight_decay=weight_decay)
        new = TrainState(params=params, m=opt.m, v=opt.v, step=opt.step)
        return new, dict(metrics, grad_norm=gnorm, loss=loss)

    return step_fn
