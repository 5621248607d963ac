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

The plain slot-axis version of each fused stage (the ``*_slots_cuda``
wrappers: S calls in one launch) is ``runtime.over_slots(reference, in_dims)``:
``torch.func.vmap`` of the plain version over a leading slot axis, an
operand shared by every slot unbatched.

The int8/PWL serving twins (``repro/kernels/mr_step/ref.py:110-220, 286``)
dequantize their int8 weights (``values * scale``, one rounding) and compute
in float32: ``mr_step_int8_reference`` (``csrc/mr_step_int8.cu``),
``mr_step_ltc_int8_reference`` (``csrc/mr_step_ltc_int8.cu``) and
``mr_tick_int8_reference`` (``csrc/mr_tick_int8.cu``). Their heads have no
activation step.
"""

from __future__ import annotations

import torch

from repro_torch.core.ltc import LTCParams, ltc_scan, ltc_sub_dt
from repro_torch.core.merinda import head_math
from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
from repro_torch.core.node_mr import NodeEncoderParams, node_scan
from repro_torch.core.quant import PWLTable, pwl_apply
from repro_torch.data.windows import roll_buffer, window_views
from repro_torch.kernels.gru_scan.ref import gru_scan_int8_reference
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


def ltc_scan_int8_reference(
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    w_inq: torch.Tensor,  # int8 [D, H]
    w_in_scale: torch.Tensor,  # [H] or [1, H]
    w_recq: torch.Tensor,  # int8 [H, H]
    w_rec_scale: torch.Tensor,
    bias: torch.Tensor,  # [H]
    a: torch.Tensor,  # [H]
    inv_tau: torch.Tensor,  # [H]
    sig_table: PWLTable,
    *,
    dt: float = 1.0,
    n_substeps: int = 6,
) -> torch.Tensor:
    """Int8-dequant and PWL-sigmoid LTC scan in float32. Returns h_T [B, H]."""
    pin_fp32_matmul()
    f32 = torch.float32
    w_in = w_inq.to(f32) * w_in_scale
    w_rec = w_recq.to(f32) * w_rec_scale
    sub_dt = ltc_sub_dt(dt, n_substeps)
    h = h0.to(f32)
    for t in range(xs.shape[1]):
        drive = xs[:, t].to(f32) @ w_in + bias
        for _ in range(n_substeps):
            f = pwl_apply(sig_table, drive + h @ w_rec)
            num = h + sub_dt * f * a
            den = 1.0 + sub_dt * (inv_tau + f)
            h = num / den
    return h


def _int8_head(h_T, w1q, w1_scale, b1, w2q, w2_scale, b2) -> torch.Tensor:
    f32 = torch.float32
    return head_math(h_T, w1q.to(f32) * w1_scale, b1, w2q.to(f32) * w2_scale, b2)


def mr_step_ltc_int8_reference(
    xs: torch.Tensor,
    h0: torch.Tensor,
    w_inq: torch.Tensor,  # int8 [D, H]
    w_in_scale: torch.Tensor,
    w_recq: torch.Tensor,  # int8 [H, H]
    w_rec_scale: torch.Tensor,
    bias: torch.Tensor,
    a: torch.Tensor,
    inv_tau: torch.Tensor,
    w1q: torch.Tensor,  # int8 [H, Dh]
    w1_scale: torch.Tensor,
    b1: torch.Tensor,
    w2q: torch.Tensor,  # int8 [Dh, K]
    w2_scale: torch.Tensor,
    b2: torch.Tensor,
    sig_table: PWLTable,
    *,
    dt: float = 1.0,
    n_substeps: int = 6,
) -> torch.Tensor:
    """Fixed-point fused LTC: int8 substep and head weights, PWL sigmoid.
    Returns the raw head output [B, K]."""
    h_T = ltc_scan_int8_reference(xs, h0, w_inq, w_in_scale, w_recq, w_rec_scale, bias, a,
                                  inv_tau, sig_table, dt=dt, n_substeps=n_substeps)  # fmt: skip
    return _int8_head(h_T, w1q, w1_scale, b1, w2q, w2_scale, b2)


def mr_step_int8_reference(
    xs: torch.Tensor,
    h0: torch.Tensor,
    wxq: torch.Tensor,  # int8 [D, 3H]
    whq: torch.Tensor,  # int8 [H, 3H]
    wx_scale: torch.Tensor,
    wh_scale: torch.Tensor,
    b: torch.Tensor,
    dts: torch.Tensor,
    w1q: torch.Tensor,  # int8 [H, Dh]
    w1_scale: torch.Tensor,
    b1: torch.Tensor,
    w2q: torch.Tensor,  # int8 [Dh, K]
    w2_scale: torch.Tensor,
    b2: torch.Tensor,
    sig_table: PWLTable,
    tanh_table: PWLTable,
) -> torch.Tensor:
    """Fixed-point fused standard GRU: int8 cell and head weights, PWL
    sigmoid and tanh. Returns the raw head output [B, K]."""
    hs = gru_scan_int8_reference(xs, h0, wxq, whq, wx_scale, wh_scale, b, dts, sig_table,
                                 tanh_table)  # fmt: skip
    return _int8_head(hs[:, -1], w1q, w1_scale, b1, w2q, w2_scale, b2)


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


def mr_tick_int8_reference(
    buf_y: torch.Tensor,  # [S, L, n]
    new_y: torch.Tensor,  # [S, C, n]
    mean: torch.Tensor,  # [S, n]
    scale: torch.Tensor,  # [S, n]
    theta0: torch.Tensor,  # [S, Kc]
    seed: torch.Tensor,  # [S] bool
    active: torch.Tensor,  # [S] bool
    wxq: torch.Tensor,  # int8 [S, D, 3H]
    whq: torch.Tensor,  # int8 [S, H, 3H]
    wx_scale: torch.Tensor,  # [S, 1, 3H] per slot, per channel
    wh_scale: torch.Tensor,  # [S, 1, 3H]
    b: torch.Tensor,  # [S, 3H]
    w1q: torch.Tensor,  # int8 [S, H, Dh]
    w1_scale: torch.Tensor,  # [S, 1, Dh]
    b1: torch.Tensor,  # [S, Dh]
    w2q: torch.Tensor,  # int8 [S, Dh, Ko]
    w2_scale: torch.Tensor,  # [S, 1, Ko]
    b2: torch.Tensor,  # [S, Ko]
    sig_table: PWLTable,
    tanh_table: PWLTable,
    buf_u: torch.Tensor | None = None,
    new_u: torch.Tensor | None = None,
    *,
    window: int,
    stride: int,
    ema: float,
) -> tuple:
    """Int8/PWL banked-tick plain version (the serving twin of
    ``mr_tick_reference``): (buf_y, theta [S, Kc], delta [S][, buf_u])."""
    buf_y = roll_buffer(buf_y, new_y)
    has_u = buf_u is not None
    if has_u:
        buf_u = roll_buffer(buf_u, new_u)
    n_coef = theta0.shape[-1]
    hidden = whq.shape[1]
    dts = torch.ones(window, dtype=torch.float32, device=buf_y.device)
    raw = []
    for s in range(buf_y.shape[0]):
        xs = window_views((buf_y[s] - mean[s]) / scale[s], window, stride)
        if has_u:
            xs = torch.cat([xs, window_views(buf_u[s], window, stride)], dim=-1)
        h0 = torch.zeros(xs.shape[0], hidden, dtype=torch.float32, device=xs.device)
        out = mr_step_int8_reference(
            xs, h0, wxq[s], whq[s], wx_scale[s], wh_scale[s], b[s], dts, w1q[s], w1_scale[s],
            b1[s], w2q[s], w2_scale[s], b2[s], sig_table, tanh_table,
        )  # fmt: skip
        raw.append(out[:, :n_coef].mean(dim=0))
    theta, delta = _tick_ema_delta(torch.stack(raw), theta0, seed, active, ema)
    return (buf_y, theta, delta, buf_u) if has_u else (buf_y, theta, delta)
