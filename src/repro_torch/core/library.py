"""Polynomial candidate-function library (counterpart of ``repro/core/library.py``).

An n-dimensional model with M-th order nonlinearity draws from C(M+n, n)
monomial terms; the exponent table is built statically (numpy ints) so the
evaluation is one vectorized power and product. The numpy parts are copies
of the JAX package's, kept here so the port imports nothing of it.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch


def n_library_terms(n_vars: int, order: int) -> int:
    """C(M+n, n): number of monomials of total degree <= order in n_vars."""
    return math.comb(order + n_vars, n_vars)


def exponent_table(n_vars: int, order: int) -> np.ndarray:
    """[n_terms, n_vars] integer exponents, graded-lex order (constant first)."""
    rows = []
    for total in range(order + 1):
        for combo in itertools.combinations_with_replacement(range(n_vars), total):
            e = [0] * n_vars
            for idx in combo:
                e[idx] += 1
            rows.append(e)
    table = np.asarray(rows, dtype=np.int32)
    assert table.shape[0] == n_library_terms(n_vars, order)
    return table


def term_names(n_vars: int, order: int, var_names: list[str] | None = None) -> list[str]:
    names = var_names or [f"x{i}" for i in range(n_vars)]
    out = []
    for row in exponent_table(n_vars, order):
        if not row.any():
            out.append("1")
            continue
        parts = []
        for name, e in zip(names, row):
            if e == 1:
                parts.append(name)
            elif e > 1:
                parts.append(f"{name}^{e}")
        out.append("*".join(parts))
    return out


@functools.lru_cache(maxsize=16)
def _exponents(n_vars: int, order: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The exponent table as a tensor, made once per device: a host-to-device
    copy inside the training loop would stall it on every RK4 stage."""
    return torch.as_tensor(exponent_table(n_vars, order), dtype=dtype, device=device)


def polynomial_features(x: torch.Tensor, n_vars: int, order: int) -> torch.Tensor:
    """x: [..., n_vars] -> [..., n_terms], as prod(x**e) over the exponent table.

    Grad-safe: d/dx x**0 = 0 * x**-1 is NaN at x == 0, and one ``where``
    does not stop a NaN cotangent, so the zero exponents go through the
    double-``where`` guard of ``repro/core/library.py:70-75``.

    The product over the variables is a chain of multiplies, left to right,
    over ``unbind``: ``torch.prod``'s backward reads back whether any factor
    is zero, which would make every training step wait for the card.
    """
    table = _exponents(n_vars, order, x.dtype, x.device)
    xb = x[..., None, :]
    is_zero = table == 0
    ones = torch.ones_like(xb)
    x_safe = torch.where(is_zero, ones, xb)
    factors = torch.where(is_zero, ones, x_safe**table).unbind(-1)
    out = factors[0]
    for factor in factors[1:]:
        out = out * factor
    return out


def normalization_transform(
    mean: np.ndarray, scale: np.ndarray, n_vars: int, order: int
) -> np.ndarray:
    """Basis-change matrix T for z-scored coordinates: phi(z) = T @ phi(y).

    z_j = (y_j - mean_j) / scale_j; each normalized monomial expands
    binomially into raw monomials of equal or lower degree, so a model
    recovered on normalized windows maps exactly back to physical units.
    """
    table = exponent_table(n_vars, order)
    index = {tuple(row): i for i, row in enumerate(table)}
    n_terms = table.shape[0]
    T = np.zeros((n_terms, n_terms))
    for k, row in enumerate(table):
        acc: dict[tuple, float] = {tuple([0] * n_vars): 1.0}
        for j, e in enumerate(row):
            if e == 0:
                continue
            # ((y_j - mu)/s)^e = s^-e * sum_r C(e,r) y^r (-mu)^(e-r)
            expand = {
                r: math.comb(e, r) * ((-mean[j]) ** (e - r)) / (scale[j] ** e)
                for r in range(e + 1)
            }
            new_acc: dict[tuple, float] = {}
            for exps, c in acc.items():
                for r, cr in expand.items():
                    e2 = list(exps)
                    e2[j] += r
                    key = tuple(e2)
                    new_acc[key] = new_acc.get(key, 0.0) + c * cr
            acc = new_acc
        for exps, c in acc.items():
            T[k, index[exps]] += c
    return T


def denormalize_theta(
    theta_z: np.ndarray,  # [n_terms, n_state] coefficients in z coordinates
    mean: np.ndarray,
    scale: np.ndarray,
    n_vars: int,
    order: int,
    n_state: int | None = None,
) -> np.ndarray:
    """Map coefficients recovered on normalized windows to physical units."""
    n_state = n_state if n_state is not None else theta_z.shape[1]
    mean = np.asarray(mean, float)
    scale = np.asarray(scale, float)
    if mean.shape[0] < n_vars:  # inputs appended unnormalized
        mean = np.concatenate([mean, np.zeros(n_vars - mean.shape[0])])
        scale = np.concatenate([scale, np.ones(n_vars - scale.shape[0])])
    T = normalization_transform(mean, scale, n_vars, order)
    theta_y = T.T @ np.asarray(theta_z, float)
    return theta_y * scale[None, :n_state]
