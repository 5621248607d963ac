"""Plain PyTorch versions of the fused MR step (``repro/kernels/mr_step/ref.py``).

One per kernel family. Each runs the encoder's own scan
(``core.neural_flow.gru_scan_ref``, ``core.ltc.ltc_scan``,
``core.node_mr.node_scan``) and then ``core.merinda.head_math``: the same
functions the unfused path runs, so each CUDA kernel (``csrc/mr_step*.cu``) is
held against the stage sequence itself.

``mr_tick_reference`` is the plain version of the banked service tick
(``csrc/mr_tick.cu``, ``repro/kernels/mr_step/ref.py:220-283``): the
streaming window helpers of ``data/windows.py``, ``mr_step_reference`` per
slot, then the EMA blend and the coefficient delta.
"""

from __future__ import annotations

import torch

from repro_torch.core.ltc import LTCParams, ltc_scan
from repro_torch.core.merinda import head_math
from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
from repro_torch.core.node_mr import NodeEncoderParams, node_scan
from repro_torch.data.windows import roll_buffer, window_views
from repro_torch.kernels.runtime import pin_fp32_matmul


def mr_step_reference(
    xs: torch.Tensor,  # [B, T, D] normalized windows
    h0: torch.Tensor,  # [B, H]
    wx: torch.Tensor,  # [D, 3H]
    wh: torch.Tensor,  # [H, 3H]
    b: torch.Tensor,  # [3H]
    time_scale: torch.Tensor,  # [H]
    dts: torch.Tensor,  # [T]
    w1: torch.Tensor,  # [H, Dh]
    b1: torch.Tensor,  # [Dh]
    w2: torch.Tensor,  # [Dh, K]
    b2: torch.Tensor,  # [K]
    flow: bool = True,
    act_bits: tuple[int, int] | None = None,
) -> torch.Tensor:
    """GRU(-flow) family. Returns the raw head output [B, K]."""
    pin_fp32_matmul()
    params = GRUParams(w=torch.cat([wx, wh], dim=0), b=b, time_scale=time_scale)
    h_T, _ = gru_scan_ref(params, xs, h0, dts=dts, flow=flow)
    return head_math(h_T, w1, b1, w2, b2, act_bits=act_bits)


def mr_step_ltc_reference(
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    w_in: torch.Tensor,  # [D, H]
    w_rec: torch.Tensor,  # [H, H]
    bias: torch.Tensor,  # [H]
    a: torch.Tensor,  # [H]   equilibrium target
    inv_tau: torch.Tensor,  # [H]
    w1: torch.Tensor,  # [H, Dh]
    b1: torch.Tensor,  # [Dh]
    w2: torch.Tensor,  # [Dh, K]
    b2: torch.Tensor,  # [K]
    *,
    dt: float = 1.0,
    n_substeps: int = 6,
    act_bits: tuple[int, int] | None = None,
) -> torch.Tensor:
    """LTC family: ``n_substeps`` semi-implicit substeps per input step, then
    the head. Returns the raw head output [B, K]."""
    pin_fp32_matmul()
    params = LTCParams(w_in=w_in, w_rec=w_rec, bias=bias, a=a, inv_tau=inv_tau)
    h_T, _ = ltc_scan(params, xs, h0, dt=dt, n_substeps=n_substeps)
    return head_math(h_T, w1, b1, w2, b2, act_bits=act_bits)


def mr_step_node_reference(
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    w_f1: torch.Tensor,  # [H, H]  vector-field MLP
    b_f1: torch.Tensor,  # [H]
    w_f2: torch.Tensor,  # [H, H]
    b_f2: torch.Tensor,  # [H]
    w_in: torch.Tensor,  # [D, H]  observation injection
    b_in: torch.Tensor,  # [H]
    w1: torch.Tensor,  # [H, Dh]
    b1: torch.Tensor,  # [Dh]
    w2: torch.Tensor,  # [Dh, K]
    b2: torch.Tensor,  # [K]
    *,
    dt: float = 1.0,
    n_substeps: int = 6,
    act_bits: tuple[int, int] | None = None,
) -> torch.Tensor:
    """NODE family: ``n_substeps`` Euler substeps and the input injection per
    input step, then the head. Returns the raw head output [B, K]."""
    pin_fp32_matmul()
    params = NodeEncoderParams(w_f1=w_f1, b_f1=b_f1, w_f2=w_f2, b_f2=b_f2, w_in=w_in, b_in=b_in)
    h_T, _ = node_scan(params, xs, h0, dt=dt, n_substeps=n_substeps)
    return head_math(h_T, w1, b1, w2, b2, act_bits=act_bits)


def _tick_ema_delta(raw, theta0, seed, active, ema: float):
    """EMA blend with first-tick seeding, then the relative coefficient delta
    (``inf`` for an inactive slot): raw, theta0 [S, Kc]; seed, active [S] bool."""
    theta = torch.where(seed[:, None], raw, ema * theta0 + (1.0 - ema) * raw)
    change = (theta - theta0).abs().amax(dim=-1)
    delta = change / (theta.abs().amax(dim=-1) + 1e-3)
    return theta, torch.where(active, delta, torch.full_like(delta, float("inf")))


def mr_tick_reference(
    buf_y: torch.Tensor,  # [S, L, n] pre-roll ring buffers
    new_y: torch.Tensor,  # [S, C, n]
    mean: torch.Tensor,  # [S, n]
    scale: torch.Tensor,  # [S, n]
    theta0: torch.Tensor,  # [S, Kc] previous readout, flattened
    seed: torch.Tensor,  # [S] bool
    active: torch.Tensor,  # [S] bool
    wx: torch.Tensor,  # [S, D, 3H] per-slot gate weights
    wh: torch.Tensor,  # [S, H, 3H]
    b: torch.Tensor,  # [S, 3H]
    time_scale: torch.Tensor,  # [S, H]
    w1: torch.Tensor,  # [S, H, Dh]
    b1: torch.Tensor,  # [S, Dh]
    w2: torch.Tensor,  # [S, Dh, Ko]
    b2: torch.Tensor,  # [S, Ko]
    buf_u: torch.Tensor | None = None,  # [S, L, m] when m > 0
    new_u: torch.Tensor | None = None,
    *,
    flow: bool,
    window: int,
    stride: int,
    ema: float,
) -> tuple:
    """Banked-tick plain version: (buf_y, theta [S, Kc], delta [S][, buf_u]),
    the kernel's output order. The GRU's flow gate sees dt = 1 at every step."""
    buf_y = roll_buffer(buf_y, new_y)
    has_u = buf_u is not None
    if has_u:
        buf_u = roll_buffer(buf_u, new_u)
    n_coef = theta0.shape[-1]
    hidden = wh.shape[1]
    dts = torch.ones(window, dtype=torch.float32, device=buf_y.device)
    raw = []
    for s in range(buf_y.shape[0]):
        xs = window_views((buf_y[s] - mean[s]) / scale[s], window, stride)
        if has_u:
            xs = torch.cat([xs, window_views(buf_u[s], window, stride)], dim=-1)
        h0 = torch.zeros(xs.shape[0], hidden, dtype=torch.float32, device=xs.device)
        out = mr_step_reference(
            xs, h0, wx[s], wh[s], b[s], time_scale[s], dts, w1[s], b1[s], w2[s], b2[s], flow=flow
        )
        raw.append(out[:, :n_coef].mean(dim=0))
    theta, delta = _tick_ema_delta(torch.stack(raw), theta0, seed, active, ema)
    return (buf_y, theta, delta, buf_u) if has_u else (buf_y, theta, delta)
