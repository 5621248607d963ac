"""Plain PyTorch versions of the fused MR step (``repro/kernels/mr_step/ref.py``).

One per kernel family. Each runs the encoder's own scan
(``core.neural_flow.gru_scan_ref``, ``core.ltc.ltc_scan``,
``core.node_mr.node_scan``) and then ``core.merinda.head_math``: the same
functions the unfused path runs, so each CUDA kernel (``csrc/mr_step*.cu``) is
held against the stage sequence itself.
"""

from __future__ import annotations

import torch

from repro_torch.core.ltc import LTCParams, ltc_scan
from repro_torch.core.merinda import head_math
from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
from repro_torch.core.node_mr import NodeEncoderParams, node_scan
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
