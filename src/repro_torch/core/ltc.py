"""Liquid Time-Constant (LTC) cell, the paper's primary baseline
(counterpart of ``repro/core/ltc.py``).

    dh/dt = -[1/tau + f(x, h)] * h + f(x, h) * A,     f = sigmoid(W x + U h + b)

integrated with the fused semi-implicit Euler update, ``n_substeps``
dependent substeps per input sample:

    h_{k+1} = (h_k + sub_dt * f * A) / (1 + sub_dt * (1/tau + f))

``sub_dt = dt / n_substeps`` is rounded to float32 once (``ltc_sub_dt``), the
value the JAX package's float32 arithmetic sees and the one the CUDA kernel
(``kernels/csrc/mr_step_ltc.cu``) is handed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LTCParams(NamedTuple):
    w_in: torch.Tensor  # [d_in, hidden]
    w_rec: torch.Tensor  # [hidden, hidden]
    bias: torch.Tensor  # [hidden]
    a: torch.Tensor  # [hidden]   equilibrium target A
    inv_tau: torch.Tensor  # [hidden]   1/tau


def init_ltc(
    generator: torch.Generator,
    d_in: int,
    hidden: int,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> LTCParams:
    w_in = torch.randn(d_in, hidden, generator=generator, device=device) / d_in**0.5
    w_rec = torch.randn(hidden, hidden, generator=generator, device=device) / hidden**0.5
    a = torch.randn(hidden, generator=generator, device=device) * 0.5
    return LTCParams(
        w_in=w_in.to(dtype),
        w_rec=w_rec.to(dtype),
        bias=torch.zeros(hidden, dtype=dtype, device=device),
        a=a.to(dtype),
        inv_tau=torch.full((hidden,), 0.5, dtype=dtype, device=device),
    )


def ltc_sub_dt(dt: float, n_substeps: int) -> float:
    """``dt / n_substeps`` rounded to float32 once."""
    return float(np.float32(dt / n_substeps))


def ltc_cell(
    params: LTCParams,
    x: torch.Tensor,  # [B, d_in]
    h: torch.Tensor,  # [B, hidden]
    dt: float = 1.0,
    n_substeps: int = 6,
) -> torch.Tensor:
    """One LTC time step: ``n_substeps`` fused-solver iterations."""
    sub_dt = ltc_sub_dt(dt, n_substeps)
    drive = x @ params.w_in + params.bias  # the input part is loop-invariant
    for _ in range(n_substeps):
        f = torch.sigmoid(drive + h @ params.w_rec)
        num = h + sub_dt * f * params.a
        den = 1.0 + sub_dt * (params.inv_tau + f)
        h = num / den
    return h


def ltc_scan(
    params: LTCParams,
    xs: torch.Tensor,  # [B, T, d_in]
    h0: torch.Tensor,  # [B, hidden]
    dt: float = 1.0,
    n_substeps: int = 6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The LTC over a sequence: (h_T [B, H], hs [B, T, H])."""
    h, hs = h0, []
    for t in range(xs.shape[1]):
        h = ltc_cell(params, xs[:, t], h, dt=dt, n_substeps=n_substeps)
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def ltc_op_counts(d_in: int, hidden: int, n_substeps: int, batch: int = 1) -> dict:
    """Analytic per-time-step operation counts."""
    mac_in = batch * d_in * hidden  # once per step
    mac_rec = batch * hidden * hidden * n_substeps  # every substep
    elementwise = batch * hidden * (6 * n_substeps)  # sigmoid/sum/div per substep
    return {
        "macs": mac_in + mac_rec,
        "elementwise": elementwise,
        "sequential_depth": n_substeps,
    }
