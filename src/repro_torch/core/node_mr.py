"""NODE-based MR encoder, the ODE-RNN baseline (counterpart of ``repro/core/node_mr.py``).

Between observations the hidden state evolves under a learned vector field
``f(h) = tanh(h.W_f1 + b_f1).W_f2 + b_f2``, integrated with ``n_substeps``
Euler substeps; after them the observation is injected linearly:

    h <- euler^K(h) + x.W_in + b_in
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ode import multi_step_solver_cell


class NodeEncoderParams(NamedTuple):
    w_f1: torch.Tensor  # [hidden, hidden]  vector-field MLP
    b_f1: torch.Tensor
    w_f2: torch.Tensor  # [hidden, hidden]
    b_f2: torch.Tensor
    w_in: torch.Tensor  # [d_in, hidden]   observation injection
    b_in: torch.Tensor


def init_node_encoder(
    generator: torch.Generator,
    d_in: int,
    hidden: int,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> NodeEncoderParams:
    s = 1.0 / hidden**0.5
    w_f1 = torch.randn(hidden, hidden, generator=generator, device=device) * s
    w_f2 = torch.randn(hidden, hidden, generator=generator, device=device) * s * 0.1
    w_in = torch.randn(d_in, hidden, generator=generator, device=device) / d_in**0.5
    zeros = lambda: torch.zeros(hidden, dtype=dtype, device=device)
    return NodeEncoderParams(
        w_f1=w_f1.to(dtype),
        b_f1=zeros(),
        w_f2=w_f2.to(dtype),
        b_f2=zeros(),
        w_in=w_in.to(dtype),
        b_in=zeros(),
    )


def node_sub_dt(dt: float, n_substeps: int) -> float:
    """The Euler substep: float32 ``dt`` divided by ``n_substeps`` in float32,
    as ``multi_step_solver_cell`` computes it from a float32 ``dt``."""
    return float(np.float32(dt) / np.float32(n_substeps))


def node_scan(
    params: NodeEncoderParams,
    xs: torch.Tensor,  # [B, T, d_in]
    h0: torch.Tensor,  # [B, hidden]
    dt: float = 1.0,
    n_substeps: int = 6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ODE-RNN over a sequence: (h_T [B, H], hs [B, T, H]).

    The one source of the NODE step: the ``node`` encoder row and the fused
    stage's plain version both call it.
    """

    def field(h, u, t, args):
        z = torch.tanh(h @ params.w_f1 + params.b_f1)
        return z @ params.w_f2 + params.b_f2

    # a fill on the device: torch.tensor(dt, device=...) would copy from the
    # host and wait for the card on every call
    dt = torch.full((), dt, dtype=h0.dtype, device=h0.device)
    h, hs = h0, []
    for t in range(xs.shape[1]):
        x_t = xs[:, t]
        h = multi_step_solver_cell(field, h, x_t, dt, method="euler", n_substeps=n_substeps)
        h = h + x_t @ params.w_in + params.b_in
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def node_encode(params: NodeEncoderParams, xs: torch.Tensor, cfg) -> torch.Tensor:
    """xs [B, T, d_in] -> h_T [B, hidden]; ``cfg`` gives dt and ltc_substeps."""
    h0 = torch.zeros(xs.shape[0], params.w_f1.shape[0], dtype=xs.dtype, device=xs.device)
    h_T, _ = node_scan(params, xs, h0, dt=cfg.dt, n_substeps=cfg.ltc_substeps)
    return h_T
