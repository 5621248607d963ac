"""Plain PyTorch version of the fused MR step (``repro/kernels/mr_step/ref.py``).

GRU branch only. The scan is ``core.neural_flow.gru_scan_ref`` and the head
is ``core.merinda.head_math``: the same functions the unfused path runs, so
the CUDA kernel (``csrc/mr_step.cu``) is held against the stage sequence
itself.
"""

from __future__ import annotations

import torch

from repro_torch.core.merinda import head_math
from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
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
) -> torch.Tensor:
    """Returns the raw head output [B, K]."""
    pin_fp32_matmul()
    params = GRUParams(w=torch.cat([wx, wh], dim=0), b=b, time_scale=time_scale)
    h_T, _ = gru_scan_ref(params, xs, h0, dts=dts, flow=flow)
    return head_math(h_T, w1, b1, w2, b2)
