"""Training run of one recovery (counterpart of ``repro/core/engine.py``).

The JAX package compiles the whole run into one ``lax.scan`` program. Here
``run_epoch`` is a Python loop over optimizer steps: PyTorch runs eagerly,
and on the card each step queues its kernels without waiting for them. The
minibatch indices come from ``torch.randint`` with the caller's generator on
the data's device, and every metric stays on the device until the run ends,
when they are stacked: the loop makes no host readback.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.library import normalization_transform
from repro_torch.core.merinda import MRConfig, MRParams, mr_train_step

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
    metrics["lr"] = torch.tensor(lrs, dtype=torch.float32, device=ys.device)
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
