"""GRU neural-flow cell (counterpart of ``repro/core/neural_flow.py``).

Two cells share one parameter layout:

- ``gru_cell``: the standard GRU of the paper's hardware pipeline
  (Eqs. 12-15);
- ``gru_flow_cell``: the flow-corrected update
  ``h' = h + phi(dt) * alpha * (1 - z) * (c - h)`` with
  ``phi(dt) = tanh(softplus(time_scale) * dt)``, so ``phi(0) = 0`` makes the
  flow the identity at ``dt = 0``, and ``alpha = 0.4`` keeps it invertible.

The three gate affines are stored fused, ``w [D + H, 3H]`` with columns
``[r | z | c]``. The candidate gate is ``tanh(x.Wx_c + (r*h).Wh_c + b_c)``:
the reset gate scales ``h`` before the product, unlike ``torch.nn.GRU``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INV_LIPSCHITZ_ALPHA = 0.4  # 2/5, Bilos et al.: keeps the flow invertible


class GRUParams(NamedTuple):
    w: torch.Tensor  # [d_in + hidden, 3 * hidden], columns [r | z | c]
    b: torch.Tensor  # [3 * hidden]
    time_scale: torch.Tensor  # [hidden], log-scale of the time gate phi

    @property
    def hidden(self) -> int:
        return self.w.shape[1] // 3

    @property
    def d_in(self) -> int:
        return self.w.shape[0] - self.hidden


def init_gru(
    generator: torch.Generator,
    d_in: int,
    hidden: int,
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> GRUParams:
    scale = 1.0 / (d_in + hidden) ** 0.5
    w = torch.randn(d_in + hidden, 3 * hidden, generator=generator, device=device) * scale
    return GRUParams(
        w=w.to(dtype),
        b=torch.zeros(3 * hidden, dtype=dtype, device=device),
        time_scale=torch.zeros(hidden, dtype=dtype, device=device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0), with no threshold.

    ``torch.maximum`` splits the gradient at the tie x = 0 as ``jnp.maximum``
    does (``clamp_min`` would pass all of it), so the gradient at the zero
    initial ``time_scale`` is 0.5 in both frameworks.
    """
    return torch.log1p(torch.exp(-x.abs())) + torch.maximum(x, torch.zeros_like(x))


def _gates(params: GRUParams, x: torch.Tensor, h: torch.Tensor):
    """(r, z, c): one product for r and z, one for the candidate from r*h."""
    hidden = params.hidden
    xh = torch.cat([x, h], dim=-1)
    rz = xh @ params.w[:, : 2 * hidden] + params.b[: 2 * hidden]
    r = torch.sigmoid(rz[..., :hidden])
    z = torch.sigmoid(rz[..., hidden:])
    xrh = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(xrh @ params.w[:, 2 * hidden :] + params.b[2 * hidden :])
    return r, z, c


def gru_cell(params: GRUParams, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Standard GRU step (paper Eq. 15): h' = (1 - z) * c + z * h."""
    _, z, c = _gates(params, x, h)
    return (1.0 - z) * c + z * h


def gru_flow_cell(
    params: GRUParams, x: torch.Tensor, h: torch.Tensor, dt: torch.Tensor | float
) -> torch.Tensor:
    """Flow step: h' = h + phi(dt) * alpha * (1 - z) * (c - h)."""
    _, z, c = _gates(params, x, h)
    phi = torch.tanh(softplus(params.time_scale) * dt)
    return h + phi * INV_LIPSCHITZ_ALPHA * (1.0 - z) * (c - h)


def gru_scan_ref(
    params: GRUParams,
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    dts: torch.Tensor | None = None,  # [T], ones when None
    flow: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain sequence scan: (h_T [B, H], hs [B, T, H])."""
    T = xs.shape[1]
    if dts is None:
        dts = torch.ones(T, dtype=xs.dtype, device=xs.device)
    h, hs = h0, []
    for t in range(T):
        x_t = xs[:, t]
        h = gru_flow_cell(params, x_t, h, dts[t]) if flow else gru_cell(params, x_t, h)
        hs.append(h)
    return h, torch.stack(hs, dim=1)
