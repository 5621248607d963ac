"""Fixed-step ODE solvers (counterpart of ``repro/core/ode.py:23-113``).

The SOLVE() of the MERINDA loss: ``Y_est = SOLVE(Y(0), theta_est, U)``, and
the multi-substep cell of the NODE baseline. Python loops over the grid;
autograd differentiates through them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Dynamics = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Any], torch.Tensor]
# f(y, u, t, args) -> dy/dt


def _euler_step(f: Dynamics, y, u, t, dt, args):
    return y + dt * f(y, u, t, args)


def _heun_step(f: Dynamics, y, u, t, dt, args):
    k1 = f(y, u, t, args)
    k2 = f(y + dt * k1, u, t + dt, args)
    return y + 0.5 * dt * (k1 + k2)


def _rk4_step(f: Dynamics, y, u, t, dt, args):
    k1 = f(y, u, t, args)
    k2 = f(y + 0.5 * dt * k1, u, t + 0.5 * dt, args)
    k3 = f(y + 0.5 * dt * k2, u, t + 0.5 * dt, args)
    k4 = f(y + dt * k3, u, t + dt, args)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


_STEPPERS = {"euler": _euler_step, "heun": _heun_step, "rk4": _rk4_step}


def odeint(
    f: Dynamics,
    y0: torch.Tensor,
    ts: torch.Tensor,
    us: torch.Tensor | None = None,
    args: Any = None,
    method: str = "rk4",
) -> torch.Tensor:
    """Integrate f over the time grid ``ts`` [T].

    us: optional inputs on the same grid, [T, *batch, m] (zero-order hold
    within a step). The steps are ``diff(ts)``, not a constant. Returns the
    trajectory [T, *y0.shape]; trajectory[0] == y0.
    """
    step = _STEPPERS[method]
    if us is None:
        us = torch.zeros((ts.shape[0], 0), dtype=y0.dtype, device=y0.device)
    dts = torch.diff(ts)
    y, ys = y0, [y0]
    for i in range(ts.shape[0] - 1):
        y = step(f, y, us[i], ts[i], dts[i], args)
        ys.append(y)
    return torch.stack(ys, dim=0)


def multi_step_solver_cell(
    f: Dynamics,
    y: torch.Tensor,
    u: torch.Tensor,
    dt: torch.Tensor | float,
    args: Any = None,
    method: str = "euler",
    n_substeps: int = 6,
) -> torch.Tensor:
    """One NODE-style cell forward pass: ``n_substeps`` sequential solver
    substeps of ``sub_dt = dt / n_substeps``, substep ``i`` at
    ``t = i * sub_dt`` (``repro/core/ode.py:87-113``)."""
    step = _STEPPERS[method]
    sub_dt = dt / n_substeps
    for i in range(n_substeps):
        y = step(f, y, u, i * sub_dt, sub_dt, args)
    return y
