"""Training runs of the recovery (counterpart of ``repro/core/engine.py``).

The JAX package compiles the whole run into one ``lax.scan`` program. Here
``run_epoch`` is a Python loop over optimizer steps: PyTorch runs eagerly,
and on the card each step queues its kernels without waiting for them. The
minibatch indices come from ``torch.randint`` with the caller's generator on
the data's device, and every metric stays on the device until the run ends,
when they are stacked: the loop makes no host readback.

Batch mode recovers many systems at once, and the streaming service trains
all its slots at once: both are ``jax.vmap`` of the train step in the JAX
package. Their counterpart here is ``stacked_train_step``: every leaf carries
a leading system (or slot) axis, ``torch.func.vmap`` runs ``mr_loss`` over
it (a kernel row's kernel as its slot-axis form, one launch for all slots),
and one ``torch.autograd.grad`` of the summed losses
gives every slot its own gradient (the slots share no parameter). Clip and
AdamW then act per slot, each with its own step count and learning rate.
``recover_many`` is the batch-mode program ``RecoveryPlan.run_batch`` runs;
``stack_systems`` pads a mixed set of systems to one shape for it. Each
system draws its initial weights from its own generator
(``system_generators``), where the JAX package folds the seed's key.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.library import normalization_transform
from repro_torch.core.merinda import (
    MRConfig,
    MRParams,
    init_mr,
    mr_forward,
    mr_loss,
    mr_train_step,
    prune_stacked,
    recover_coefficients,
)
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unflatten

WARMUP_STEPS = 50  # linear LR warmup, as the JAX engine


def make_phys(cfg: MRConfig, norm: dict | None, device: torch.device | str):
    """(T^T, out_scale) for physical-unit sparsity penalties, or None.

    norm is the stats dict from data/windows.make_windows; see mr_loss.
    """
    if norm is None:
        return None
    n_vars = cfg.state_dim + cfg.input_dim
    mean = np.concatenate([np.asarray(norm["mean"]), np.zeros(cfg.input_dim)])
    scale = np.concatenate([np.asarray(norm["scale"]), np.ones(cfg.input_dim)])
    T = normalization_transform(mean, scale, n_vars, cfg.order)
    return (
        torch.as_tensor(T.T, dtype=torch.float32, device=device),
        torch.as_tensor(scale[: cfg.state_dim], dtype=torch.float32, device=device),
    )


def run_epoch(
    params: MRParams,
    opt_state,
    ys: torch.Tensor,  # [N, T, n]
    us: torch.Tensor | None,  # [N, T, m] | None
    generator: torch.Generator,
    lr: float,
    phys: tuple | None,
    *,
    cfg: MRConfig,
    steps: int,
    batch_size: int | None,
):
    """``steps`` optimizer steps; returns (params, opt_state, metrics).

    metrics maps loss, recon_mse, sparsity_l1, grad_norm and lr to [steps]
    tensors on the data's device.
    """
    n = ys.shape[0]
    bs = batch_size or n
    rows = []
    lrs = []
    for step in range(steps):
        if bs < n:
            idx = torch.randint(0, n, (bs,), generator=generator, device=ys.device)
            yb = ys.index_select(0, idx)
            ub = None if us is None else us.index_select(0, idx)
        else:
            yb, ub = ys, us
        lr_t = lr * min(1.0, (step + 1.0) / WARMUP_STEPS)
        params, opt_state, aux = mr_train_step(params, opt_state, cfg, yb, ub, lr_t, phys)
        rows.append(aux)
        lrs.append(lr_t)
    metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]} if rows else {}
    # pinned and non-blocking on the card: any other host-to-device copy waits
    lr = torch.tensor(lrs, dtype=torch.float32)
    if ys.device.type == "cuda":
        lr = lr.pin_memory()
    metrics["lr"] = lr.to(ys.device, non_blocking=True)
    return params, opt_state, metrics


def history_from_metrics(metrics: dict, log_every: int) -> list[dict]:
    """One dict per logged step (the JAX package's history format)."""
    if not log_every:
        return []
    host = {k: v.cpu().numpy() for k, v in metrics.items()}
    steps = next(iter(host.values())).shape[0]
    return [
        {k: float(v[s]) for k, v in host.items()} | {"step": s}
        for s in range(0, steps, log_every)
    ]


# ---------------------------------------------------------------------------
# many recoveries at once: a leading system or slot axis on every leaf
# ---------------------------------------------------------------------------
def stacked_train_step(
    params: MRParams,  # leaves [S, ...]
    opt_state,  # AdamWState with step [S]
    cfg: MRConfig,
    ys: torch.Tensor,  # [S, B, T, n]
    us: torch.Tensor | None,  # [S, B, T, m] | None
    lr: float | torch.Tensor,  # a float, or [S] per slot
    phys: tuple | None = None,
):
    """``mr_train_step`` of every slot at once (``jax.vmap(mr_train_step)``).

    Returns (params, opt_state, metrics) with metrics of shape [S].
    ``mr_loss`` runs under ``torch.func.vmap``: on the card the rows that
    launch a kernel (fused, ``*_kernel``) launch its slot-axis form once for
    all slots, through the kernel Function's vmap rule
    (``kernels/runtime.kernel_function``), and the one ``torch.autograd.grad``
    below pulls the gradients back through its stacked plain recompute.
    """
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    in_dims = (0, 0, None if us is None else 0)
    loss, aux = torch.func.vmap(lambda p, y, u: mr_loss(p, cfg, y, u, phys), in_dims)(
        leaves, ys, us
    )
    grads = torch.autograd.grad(
        loss.sum(), tree_leaves(leaves), allow_unused=True, materialize_grads=True
    )
    grads, gnorm = clip_by_global_norm(tree_unflatten(params, list(grads)), 1.0, stacked=True)
    params, opt_state = adamw_update(grads, opt_state, params, lr=lr, weight_decay=1e-4)
    metrics = {k: v.detach() for k, v in aux.items()}
    return params, opt_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)


@torch.no_grad()
def stacked_theta(params: MRParams, cfg: MRConfig, ys: torch.Tensor, us: torch.Tensor | None):
    """Mean-over-windows Theta of every slot: ys [S, N, T, n] -> [S, n_terms, n]
    (one slot-axis launch on the card for a fused or ``*_kernel`` row)."""
    in_dims = (0, 0, None if us is None else 0)
    return torch.func.vmap(lambda p, y, u: mr_forward(p, cfg, y, u)[0].mean(dim=0), in_dims)(
        params, ys, us
    )


def gather_windows(xs: torch.Tensor | None, idx: torch.Tensor) -> torch.Tensor | None:
    """Per-slot minibatch: xs [S, N, ...] at idx [S, bs] -> [S, bs, ...]."""
    if xs is None:
        return None
    return xs[torch.arange(xs.shape[0], device=xs.device)[:, None], idx]


def seeded_generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and the integer ``path``
    (``numpy.random.SeedSequence`` spawn keys): the port's ``fold_in``."""
    state = np.random.SeedSequence(seed, spawn_key=path).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def system_generators(seed: int, n_systems: int, device) -> list[torch.Generator]:
    """One generator per system, seeded from (seed, index): the port's
    ``engine.system_keys``, so one-at-a-time and stacked recovery draw the
    same initial weights."""
    return [seeded_generator(seed, i, device=device) for i in range(n_systems)]


def recover_one(
    cfg: MRConfig,
    ys: torch.Tensor,  # [N, T, n]
    us: torch.Tensor | None,
    generator: torch.Generator,
    steps: int = 500,
    lr: float = 3e-3,
    batch_size: int | None = None,
    n_active: int | None = None,
) -> torch.Tensor:
    """Init -> train -> mean-over-windows Theta [n_terms, n] for ONE system."""
    params = init_mr(generator, cfg, ys.device)
    params, _, _ = run_epoch(
        params, adamw_init(params), ys, us, generator, lr, None,
        cfg=cfg, steps=steps, batch_size=batch_size,
    )  # fmt: skip
    return recover_coefficients(params, cfg, ys, us, n_active=n_active)


def recover_many(
    cfg: MRConfig,
    ys_batch: torch.Tensor,  # [S, N, T, n]
    us_batch: torch.Tensor | None,  # [S, N, T, m] | None
    generators: Sequence[torch.Generator],  # one per system: initial weights
    sampler: torch.Generator,  # minibatch indices of every system
    steps: int = 500,
    lr: float = 3e-3,
    batch_size: int | None = None,
    n_active: int | None = None,
) -> torch.Tensor:
    """``recover_one`` of S systems as one stacked program: theta [S, n_terms, n].

    The learning rate warms up over ``WARMUP_STEPS``, as in ``run_epoch``;
    with ``batch_size`` set, each step draws [S, batch_size] window indices
    from ``sampler`` (outside the vmapped loss) and gathers them per system.
    """
    per_system = [init_mr(g, cfg, ys_batch.device) for g in generators]
    params = tree_stack(per_system)
    opt_state = tree_stack([adamw_init(p) for p in per_system])
    S, n = ys_batch.shape[:2]
    bs = batch_size or n
    for step in range(steps):
        yb, ub = ys_batch, us_batch
        if bs < n:
            idx = torch.randint(0, n, (S, bs), generator=sampler, device=ys_batch.device)
            yb, ub = gather_windows(ys_batch, idx), gather_windows(us_batch, idx)
        lr_t = lr * min(1.0, (step + 1.0) / WARMUP_STEPS)
        params, opt_state, _ = stacked_train_step(params, opt_state, cfg, yb, ub, lr_t)
    theta = stacked_theta(params, cfg, ys_batch, us_batch)
    return theta if n_active is None else prune_stacked(theta, n_active)


def stack_systems(
    names: Sequence[str],
    window: int = 32,
    stride: int = 4,
    n_samples: int = 600,
) -> tuple[np.ndarray, np.ndarray | None, list[dict], MRConfig]:
    """Generate, window and zero-pad a mixed set of systems for ``recover_many``.

    State and input dims are zero-padded to the set's maxima (a padded state
    channel is identically zero, so its library terms vanish). Returns
    (ys [S, N, T, n_max], us [S, N, T, m_max] or None, per-system norm stats,
    an MRConfig), host-side.
    """
    from repro_torch.data.dynamics import generate_trajectory, get_system
    from repro_torch.data.windows import make_windows

    specs = [get_system(n) for n in names]
    dts = {s.dt for s in specs}
    if len(dts) > 1:
        raise ValueError(
            f"stack_systems requires a common sampling dt, got {sorted(dts)} "
            f"for {list(names)} — stack only systems generated on one grid"
        )
    n_max = max(s.state_dim for s in specs)
    m_max = max(s.input_dim for s in specs)
    yws, uws, norms = [], [], []
    for spec in specs:
        _, ys, us = generate_trajectory(spec.name, n_samples=n_samples)
        yw, uw, norm = make_windows(ys, us, window=window, stride=stride)
        N, T = yw.shape[:2]
        yws.append(np.pad(yw, ((0, 0), (0, 0), (0, n_max - spec.state_dim))))
        if m_max:
            uws.append(
                np.zeros((N, T, m_max), np.float32)
                if uw is None
                else np.pad(uw, ((0, 0), (0, 0), (0, m_max - uw.shape[-1])))
            )
        norms.append(norm)
    cfg = MRConfig(
        state_dim=n_max,
        input_dim=m_max,
        order=max(s.order for s in specs),
        hidden=32,
        dense_hidden=64,
        dt=dts.pop(),
    )
    return np.stack(yws), (np.stack(uws) if m_max else None), norms, cfg
