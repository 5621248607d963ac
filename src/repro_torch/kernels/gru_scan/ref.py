"""Plain PyTorch version of the GRU scan kernel (``repro/kernels/gru_scan/ref.py``).

Delegates to ``core.neural_flow.gru_scan_ref``, the one source of the step
math; the CUDA kernel (``csrc/gru_scan.cu``) is held against this.
"""

from __future__ import annotations

import torch

from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
from repro_torch.kernels.runtime import pin_fp32_matmul


def gru_scan_reference(
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    wx: torch.Tensor,  # [D, 3H]
    wh: torch.Tensor,  # [H, 3H]
    b: torch.Tensor,  # [3H]
    time_scale: torch.Tensor,  # [H]
    dts: torch.Tensor,  # [T]
    flow: bool = True,
) -> torch.Tensor:
    """Returns hs [B, T, H]."""
    pin_fp32_matmul()
    params = GRUParams(w=torch.cat([wx, wh], dim=0), b=b, time_scale=time_scale)
    _, hs = gru_scan_ref(params, xs, h0, dts=dts, flow=flow)
    return hs
