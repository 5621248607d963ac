"""SINDy baseline: sequential thresholded least squares (``repro/core/sindy.py``).

The paper compares MERINDA against SINDy (Table 5; refs [12, 18]). Given a
trajectory X[t] (and inputs U[t]) we estimate derivatives, build the monomial
library Theta(X, U), and solve the sparse regression

    dX/dt = Theta(X, U) @ Xi

with ridge-regularized least squares + hard thresholding (Brunton et al.).
The active-set mask is a float tensor carried through a fixed number of
STLSQ rounds with masked ridge solves, all on the tensors' device: no round
reads anything back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.library import polynomial_features


class SindyFit(NamedTuple):
    coef: torch.Tensor  # [n_terms, n_state]
    mask: torch.Tensor  # [n_terms, n_state] bool active set
    residual: torch.Tensor  # scalar: ||dX - Theta @ coef||^2 / N


def finite_difference(x: torch.Tensor, dt: float) -> torch.Tensor:
    """2nd-order central differences (one-sided at the ends). x: [T, n]."""
    return torch.gradient(x, spacing=dt, dim=0, edge_order=1)[0]


def _masked_ridge(
    theta: torch.Tensor, dx: torch.Tensor, mask: torch.Tensor, lam: float
) -> torch.Tensor:
    """Solve min ||Theta_masked w - dx||^2 + lam ||w||^2 per state dim.

    Masking zeroes columns; the ridge term keeps the normal equations
    well-posed with zeroed (inactive) columns, whose coefficients the mask
    then re-zeroes. One batched solve over the [n_state, n_terms, n_terms]
    grams.
    """
    n_terms = theta.shape[1]
    th = theta[None, :, :] * mask.T[:, None, :]  # [n_state, N, n_terms]
    eye = torch.eye(n_terms, dtype=theta.dtype, device=theta.device)
    gram = th.transpose(1, 2) @ th + lam * eye
    rhs = th.transpose(1, 2) @ dx.T[:, :, None]  # [n_state, n_terms, 1]
    w = torch.linalg.solve(gram, rhs)[..., 0]  # [n_state, n_terms]
    return w.T * mask


def stlsq(
    theta: torch.Tensor,
    dx: torch.Tensor,
    threshold: float = 0.1,
    lam: float = 1e-5,
    n_iters: int = 10,
) -> SindyFit:
    """STLSQ on precomputed features. theta: [N, n_terms], dx: [N, n_state]."""
    n_terms, n_state = theta.shape[1], dx.shape[1]
    mask = torch.ones((n_terms, n_state), dtype=theta.dtype, device=theta.device)
    for _ in range(n_iters):
        coef = _masked_ridge(theta, dx, mask, lam)
        mask = (coef.abs() >= threshold).to(theta.dtype)
    coef = _masked_ridge(theta, dx, mask, lam)
    resid = ((theta @ coef - dx) ** 2).mean()
    return SindyFit(coef=coef, mask=mask.to(torch.bool), residual=resid)


def fit_sindy(
    x: torch.Tensor,
    dt: float,
    order: int = 2,
    u: torch.Tensor | None = None,
    threshold: float = 0.1,
    lam: float = 1e-5,
    n_iters: int = 10,
) -> SindyFit:
    """End-to-end SINDy: derivatives -> library -> STLSQ.

    x: [T, n_state]; u: optional [T, m] exogenous inputs appended to the
    library variables (SINDYc-style).
    """
    dx = finite_difference(x, dt)
    z = x if u is None else torch.cat([x, u], dim=-1)
    theta = polynomial_features(z, z.shape[-1], order)
    return stlsq(theta, dx, threshold=threshold, lam=lam, n_iters=n_iters)


def sindy_dynamics(order: int):
    """Return f(y, u, t, coef) evaluating the recovered model (for ``ode.solve``)."""

    def f(y, u, t, coef):
        z = y if u is None or u.shape[-1] == 0 else torch.cat([y, u], dim=-1)
        feats = polynomial_features(z, z.shape[-1], order)
        return feats @ coef

    return f
