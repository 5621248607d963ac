"""PINN + Sparse Regression baseline (``repro/core/pinn_sr.py``; Chen et al.,
Nature Comm. 2021, ref [20]).

A tanh-MLP x_hat(t) fits the measurements; the derivative dx_hat/dt at the
collocation points ties it to a sparse combination of library terms:

    L = ||x_hat(t_i) - x_i||^2
      + w_phys * ||dx_hat/dt - Theta(x_hat, u) @ Xi||^2
      + w_l1 * ||Xi||_1

with periodic hard thresholding of Xi (the "SR" alternation).

``jax.jvp`` through the scalar time input becomes a tangent carried by hand
through the Fourier features and the MLP (``mlp_x(..., tangent=True)``:
d sin(kt) = k cos(kt), dh <- dh @ w, dh <- dh * (1 - tanh^2)), plain
differentiable ops, so the outer gradient flows through the derivative as
it does through ``jax.jvp``. ``xi_mask`` is a leaf of the parameters, as in
the JAX package: the gradient reaches it and AdamW moves it between
thresholdings.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.library import n_library_terms, polynomial_features
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class PinnSRConfig:
    state_dim: int
    input_dim: int = 0
    order: int = 2
    width: int = 64
    depth: int = 3
    fourier_k: int = 16  # sin/cos(k t_hat) input features (spectral-bias fix)
    w_phys: float = 1.0
    w_l1: float = 1e-3
    threshold: float = 0.05
    threshold_every: int = 200

    @property
    def n_terms(self) -> int:
        return n_library_terms(self.state_dim + self.input_dim, self.order)


class PinnSRParams(NamedTuple):
    mlp: list  # [(w, b), ...]
    xi: torch.Tensor  # [n_terms, n_state]
    xi_mask: torch.Tensor  # [n_terms, n_state]


def init_pinn_sr(generator: torch.Generator, cfg: PinnSRConfig, device,
                 dtype=torch.float32) -> PinnSRParams:  # fmt: skip
    """Random initial parameters drawn from ``generator``: each layer's w is
    standard normal over sqrt(fan-in), b zero; Xi zero, its mask one."""
    d_in = 1 + 2 * cfg.fourier_k
    dims = [d_in] + [cfg.width] * (cfg.depth - 1) + [cfg.state_dim]
    mlp = []
    for di, do in zip(dims[:-1], dims[1:]):
        w = torch.randn(di, do, generator=generator, device=device) / di**0.5
        mlp.append((w.to(dtype), torch.zeros(do, dtype=dtype, device=device)))
    xi = torch.zeros(cfg.n_terms, cfg.state_dim, dtype=dtype, device=device)
    return PinnSRParams(mlp=mlp, xi=xi, xi_mask=torch.ones_like(xi))


def mlp_x(params: PinnSRParams, t: torch.Tensor, tangent: bool = False):
    """t: [...] -> x_hat [..., n_state] through Fourier features and the MLP.

    ``tangent=True`` also returns dx_hat/dt [..., n_state] (the forward-mode
    derivative along dt = 1 that ``jax.jvp`` gives in the JAX package).
    """
    d_in = params.mlp[0][0].shape[0]
    K = (d_in - 1) // 2
    feats, dfeats = [t[..., None]], [torch.ones_like(t)[..., None]]
    if K:
        k = torch.arange(1, K + 1, dtype=t.dtype, device=t.device)
        ang = t[..., None] * k  # t is trainer-normalized to ~N(0,1)
        sin, cos = torch.sin(ang), torch.cos(ang)
        feats += [sin, cos]
        dfeats += [cos * k, -sin * k]
    h, dh = torch.cat(feats, dim=-1), torch.cat(dfeats, dim=-1)
    for i, (w, b) in enumerate(params.mlp):
        h = h @ w + b
        dh = dh @ w
        if i < len(params.mlp) - 1:
            h = torch.tanh(h)
            dh = dh * (1.0 - h * h)
    return (h, dh) if tangent else h


def pinn_sr_loss(params: PinnSRParams, cfg: PinnSRConfig, ts, xs, us=None):
    """ts: [N], xs: [N, n]. Physics residual on the carried time derivative."""
    x_hat, dx_dt = mlp_x(params, ts, tangent=True)
    data = ((x_hat - xs) ** 2).mean()
    z = x_hat if us is None or cfg.input_dim == 0 else torch.cat([x_hat, us], dim=-1)
    feats = polynomial_features(z, cfg.state_dim + cfg.input_dim, cfg.order)
    xi = params.xi * params.xi_mask
    phys = ((dx_dt - feats @ xi) ** 2).mean()
    l1 = xi.abs().mean()
    loss = data + cfg.w_phys * phys + cfg.w_l1 * l1
    return loss, {"data_mse": data, "phys_mse": phys, "l1": l1}


def _pinn_step(params, opt_state, cfg: PinnSRConfig, ts, xs, us, lr):
    """One AdamW step on the loss, its gradient clipped to global norm 5."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = pinn_sr_loss(tree_unflatten(params, leaves), cfg, ts, xs, us)
        grads = torch.autograd.grad(loss, leaves)
    grads, _ = clip_by_global_norm(tree_unflatten(params, list(grads)), 5.0)
    params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
    aux = {k: v.detach() for k, v in aux.items()}
    return params, opt_state, dict(aux, loss=loss.detach())


def train_pinn_sr(
    cfg: PinnSRConfig,
    ts: torch.Tensor,
    xs: torch.Tensor,
    us: torch.Tensor | None = None,
    steps: int = 2000,
    lr: float = 1e-2,
    seed: int = 0,
    params: PinnSRParams | None = None,
):
    """Train from ``params`` (by default ``init_pinn_sr`` from a generator
    seeded with ``seed`` on the tensors' device) and return (params,
    history). The time input is normalized to O(1) with the population std,
    as ``jnp.std``: a raw t saturates the tanh MLP, and the recovered Xi is in
    normalized-time units (d/dt_hat). ``history`` holds the losses every 100
    steps (a readback each)."""
    t_mu, t_sd = ts.mean(), ts.std(correction=0) + 1e-8
    ts = (ts - t_mu) / t_sd
    if params is None:
        generator = torch.Generator(device=ts.device).manual_seed(seed)
        params = init_pinn_sr(generator, cfg, ts.device)
    opt_state = adamw_init(params)
    history = []
    for step in range(steps):
        params, opt_state, aux = _pinn_step(params, opt_state, cfg, ts, xs, us, lr)
        if step and step % cfg.threshold_every == 0:  # SR alternation
            mask = (params.xi.abs() >= cfg.threshold).to(params.xi.dtype)
            params = params._replace(xi_mask=mask)
        if step % 100 == 0:
            history.append({k: float(v) for k, v in aux.items()} | {"step": step})
    return params, history


def recovered_xi(params: PinnSRParams) -> torch.Tensor:
    return params.xi * params.xi_mask
