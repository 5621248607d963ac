"""Benchmark dynamical systems (counterpart of ``repro/data/dynamics.py``).

The paper's case studies, regenerated with the RK4 integrator at a fine
internal step (``dt / oversample``) in float32 and subsampled, as
``repro/data/dynamics.py:298-325`` does. Each system carries its
ground-truth sparse coefficient matrix in the polynomial library basis.

- lorenz: chaotic Lorenz-63
- f8: F-8 Crusader short-period model (cubic)
- lotka_volterra: predator-prey (Hudson Bay lynx/hare regime)
- pathogen: pathogen / immune-cell interaction
- aid: Bergman minimal model of glucose-insulin dynamics, with insulin input
- damped_oscillator: linear 2-state damped harmonic oscillator
- controlled_pendulum: small-angle pendulum with sinusoidal torque input

Trajectories are host-side data set-up: they are integrated on the CPU and
returned as numpy arrays, like the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.library import n_library_terms, term_names
from repro_torch.core.ode import odeint


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    name: str
    state_dim: int
    input_dim: int
    order: int  # minimal library order that contains the true dynamics
    dynamics: Callable  # f(y, u, t, args) -> dy/dt
    y0: tuple
    dt: float
    t_end: float
    input_fn: Callable | None = None  # u(t) exogenous drive, t [T] -> [T, m]
    true_coef: Callable | None = None  # () -> [n_terms, n] ground truth


def _coef(n_vars: int, order: int, n_state: int, names: list[str], entries: dict) -> np.ndarray:
    """Ground-truth matrix from {(term, state index): value}."""
    c = np.zeros((n_library_terms(n_vars, order), n_state))
    ix = {n: i for i, n in enumerate(term_names(n_vars, order, names))}
    for (term, j), value in entries.items():
        c[ix[term], j] = value
    return c


# --- Lorenz-63 --------------------------------------------------------------
def _lorenz(y, u, t, args):
    sigma, rho, beta = 10.0, 28.0, 8.0 / 3.0
    x, yv, z = y[..., 0], y[..., 1], y[..., 2]
    return torch.stack([sigma * (yv - x), x * (rho - z) - yv, x * yv - beta * z], dim=-1)


def _lorenz_coef():
    return _coef(
        3,
        2,
        3,
        ["x", "y", "z"],
        {
            ("x", 0): -10.0,
            ("y", 0): 10.0,
            ("x", 1): 28.0,
            ("y", 1): -1.0,
            ("x*z", 1): -1.0,
            ("x*y", 2): 1.0,
            ("z", 2): -8.0 / 3.0,
        },
    )


# --- F-8 Crusader (cubic short-period model) --------------------------------
def _f8(y, u, t, args):
    x1, x2, x3 = y[..., 0], y[..., 1], y[..., 2]
    dx1 = (
        -0.877 * x1
        + x3
        - 0.088 * x1 * x3
        + 0.47 * x1**2
        - 0.019 * x2**2
        - x1**2 * x3
        + 3.846 * x1**3
    )
    dx2 = x3
    dx3 = -4.208 * x1 - 0.396 * x3 - 0.47 * x1**2 - 3.564 * x1**3
    return torch.stack([dx1, dx2, dx3], dim=-1)


def _f8_coef():
    return _coef(
        3,
        3,
        3,
        ["x1", "x2", "x3"],
        {
            ("x1", 0): -0.877,
            ("x3", 0): 1.0,
            ("x1*x3", 0): -0.088,
            ("x1^2", 0): 0.47,
            ("x2^2", 0): -0.019,
            ("x1^2*x3", 0): -1.0,
            ("x1^3", 0): 3.846,
            ("x3", 1): 1.0,
            ("x1", 2): -4.208,
            ("x3", 2): -0.396,
            ("x1^2", 2): -0.47,
            ("x1^3", 2): -3.564,
        },
    )


# --- Lotka-Volterra (Hudson Bay lynx/hare regime) ---------------------------
_LV = (0.55, 0.028, 0.84, 0.026)  # a, b, c, d (per-year, pelt-count scale)


def _lotka(y, u, t, args):
    a, b, c, d = _LV
    h, l = y[..., 0], y[..., 1]
    return torch.stack([a * h - b * h * l, -c * l + d * h * l], dim=-1)


def _lotka_coef():
    a, b, c, d = _LV
    return _coef(
        2, 2, 2, ["h", "l"], {("h", 0): a, ("h*l", 0): -b, ("l", 1): -c, ("h*l", 1): d}
    )


# --- Pathogenic attack (innate immune response) -----------------------------
def _pathogen(y, u, t, args):
    p, i = y[..., 0], y[..., 1]
    dp = 1.2 * p - 0.9 * p * i
    di = 0.05 + 0.6 * p * i - 0.8 * i
    return torch.stack([dp, di], dim=-1)


def _pathogen_coef():
    return _coef(
        2,
        2,
        2,
        ["p", "i"],
        {("p", 0): 1.2, ("p*i", 0): -0.9, ("1", 1): 0.05, ("p*i", 1): 0.6, ("i", 1): -0.8},
    )


# --- AID: Bergman minimal model (glucose G, remote insulin X, plasma I) -----
_BERGMAN = dict(p1=0.028, p2=0.025, p3=1.3e-5, n=0.23, gb=4.5, ib=15.0)


def _aid_input(t):
    # insulin bolus schedule + meal disturbance (periodic), per 5-min units
    bolus = 25.0 * (torch.sin(2 * math.pi * t / 60.0) > 0.95).to(t.dtype)
    return torch.stack([bolus], dim=-1)


def _aid(y, u, t, args):
    p = _BERGMAN
    g, x, i = y[..., 0], y[..., 1], y[..., 2]
    u_ins = u[..., 0] if u is not None and u.shape[-1] else 0.0
    dg = -p["p1"] * (g - p["gb"]) - x * g
    dx = -p["p2"] * x + p["p3"] * (i - p["ib"])
    di = -p["n"] * (i - p["ib"]) + u_ins / 12.0
    return torch.stack([dg, dx, di], dim=-1)


def _aid_coef():
    p = _BERGMAN
    return _coef(
        4,
        2,
        3,
        ["g", "x", "i", "u"],
        {
            ("1", 0): p["p1"] * p["gb"],
            ("g", 0): -p["p1"],
            ("g*x", 0): -1.0,
            ("x", 1): -p["p2"],
            ("i", 1): p["p3"],
            ("1", 1): -p["p3"] * p["ib"],
            ("i", 2): -p["n"],
            ("1", 2): p["n"] * p["ib"],
            ("u", 2): 1.0 / 12.0,
        },
    )


# --- damped harmonic oscillator (linear 2-state testbed) --------------------
_OSC = (2.0, 0.3)  # omega, damping c


def _damped_osc(y, u, t, args):
    omega, c = _OSC
    x, v = y[..., 0], y[..., 1]
    return torch.stack([v, -(omega**2) * x - c * v], dim=-1)


def _damped_osc_coef():
    omega, c = _OSC
    return _coef(2, 2, 2, ["x", "v"], {("v", 0): 1.0, ("x", 1): -(omega**2), ("v", 1): -c})


# --- controlled pendulum (small-angle, sinusoidal torque input) -------------
_PEND = (4.9, 0.35)  # g/l, damping


def _pend_input(t):
    return torch.stack([0.6 * torch.sin(1.1 * t)], dim=-1)


def _pendulum(y, u, t, args):
    gl, c = _PEND
    th, w = y[..., 0], y[..., 1]
    tq = u[..., 0] if u is not None and u.shape[-1] else 0.0
    return torch.stack([w, -gl * th - c * w + tq], dim=-1)


def _pendulum_coef():
    gl, c = _PEND
    return _coef(
        3, 2, 2, ["th", "w", "u"], {("w", 0): 1.0, ("th", 1): -gl, ("w", 1): -c, ("u", 1): 1.0}
    )


SYSTEMS: dict[str, SystemSpec] = {
    "lorenz": SystemSpec(
        "lorenz", 3, 0, 2, _lorenz, (-8.0, 7.0, 27.0), 0.01, 10.0, None, _lorenz_coef
    ),
    "f8": SystemSpec("f8", 3, 0, 3, _f8, (0.3, 0.0, 0.2), 0.01, 12.0, None, _f8_coef),
    "lotka_volterra": SystemSpec(
        "lotka_volterra", 2, 0, 2, _lotka, (30.0, 4.0), 0.05, 40.0, None, _lotka_coef
    ),
    "pathogen": SystemSpec(
        "pathogen", 2, 0, 2, _pathogen, (0.5, 0.3), 0.02, 30.0, None, _pathogen_coef
    ),
    "aid": SystemSpec("aid", 3, 1, 2, _aid, (7.0, 0.0, 18.0), 5.0, 1000.0, _aid_input, _aid_coef),
    "damped_oscillator": SystemSpec(
        "damped_oscillator", 2, 0, 2, _damped_osc, (1.2, 0.0), 0.01, 20.0, None, _damped_osc_coef
    ),
    "controlled_pendulum": SystemSpec(
        "controlled_pendulum",
        2,
        1,
        2,
        _pendulum,
        (0.6, 0.0),
        0.01,
        20.0,
        _pend_input,
        _pendulum_coef,
    ),
}


def get_system(name: str) -> SystemSpec:
    if name not in SYSTEMS:
        raise KeyError(f"unknown system {name!r}; available: {', '.join(sorted(SYSTEMS))}")
    return SYSTEMS[name]


def true_coef(name: str) -> np.ndarray:
    """Ground-truth coefficients [n_terms, n_state] of a registered system."""
    return np.asarray(get_system(name).true_coef(), float)


def embed_true_coef(spec: SystemSpec, n_state: int, n_input: int, order: int) -> np.ndarray:
    """``spec``'s ground truth in a larger, zero-padded library.

    A mixed stream fleet is padded to common (n_state, n_input, order), so its
    recovered coefficients live in the padded basis; this maps the spec's
    [n_terms_spec, state_dim] truth into [n_terms(n_state + n_input, order),
    n_state], zeros elsewhere. States are named s0.., inputs i0.. on both
    sides, so every term of the spec's library appears by name in the padded
    one.
    """
    if spec.true_coef is None:
        raise ValueError(f"system {spec.name!r} has no ground-truth coefficients")
    if order < spec.order or n_state < spec.state_dim or n_input < spec.input_dim:
        raise ValueError(f"padded library smaller than {spec.name!r}'s own library")
    small = np.asarray(spec.true_coef(), float)

    def names(n: int, m: int, k: int) -> list[str]:
        return term_names(n + m, k, [f"s{i}" for i in range(n)] + [f"i{j}" for j in range(m)])

    ix = {name: k for k, name in enumerate(names(n_state, n_input, order))}
    big = np.zeros((n_library_terms(n_state + n_input, order), n_state))
    for k, name in enumerate(names(spec.state_dim, spec.input_dim, spec.order)):
        big[ix[name], : spec.state_dim] = small[k]
    return big


def generate_trajectory(
    name: str,
    n_samples: int | None = None,
    noise_std: float = 0.0,
    seed: int = 0,
    oversample: int = 4,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integrate a system and return (ts [T], ys [T, n], us [T, m]).

    RK4 in float32 at dt/oversample on the CPU, subsampled to the spec's dt.
    """
    spec = get_system(name)
    n_samples = n_samples or int(spec.t_end / spec.dt)
    fine = n_samples * oversample
    ts_fine = torch.linspace(0.0, n_samples * spec.dt, fine + 1, dtype=torch.float64).float()
    if spec.input_fn is not None:
        us_fine = spec.input_fn(ts_fine)
    else:
        us_fine = torch.zeros((fine + 1, 0))
    y0 = torch.tensor(spec.y0, dtype=torch.float32)
    with torch.no_grad():
        ys_fine = odeint(spec.dynamics, y0, ts_fine, us=us_fine, method="rk4")
    sl = slice(None, None, oversample)
    ts, ys, us = ts_fine[sl].numpy(), ys_fine[sl].numpy(), us_fine[sl].numpy()
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        ys = ys + noise_std * ys.std(axis=0, keepdims=True) * rng.standard_normal(ys.shape)
    return ts, ys.astype(np.float32), us.astype(np.float32)
