"""Plain PyTorch versions of the GRU scan kernels (``repro/kernels/gru_scan/ref.py``).

``gru_scan_reference`` delegates to ``core.neural_flow.gru_scan_ref``, the one
source of the fp32 step math; the CUDA kernel (``csrc/gru_scan.cu``) is held
against it, and ``runtime.over_slots(gru_scan_reference, in_dims)``, its
``torch.func.vmap`` over a leading slot axis, is the plain slot-axis version
(``gru_scan_slots_cuda``). ``gru_q_step`` is the int8/PWL serving cell (the
standard GRU with dequantized int8 weights and PWL activations), shared by
every int8 plain version as ``_gru_q_step_math`` is shared in the JAX
package; ``gru_scan_int8_reference`` scans it (``csrc/gru_scan_int8.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.core.neural_flow import GRUParams, gru_scan_ref
from repro_torch.core.quant import PWLTable, pwl_apply
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


def gru_q_step(x, h, wx, wh, b, sig_table: PWLTable, tanh_table: PWLTable) -> torch.Tensor:
    """One standard-GRU step with the dequantized weights wx [D, 3H] and
    wh [H, 3H] and the PWL sigmoid and tanh: the new h [B, H]."""
    H = h.shape[-1]
    gx = x @ wx
    gh = h @ wh[:, : 2 * H]
    r = pwl_apply(sig_table, gx[:, :H] + gh[:, :H] + b[:H])
    z = pwl_apply(sig_table, gx[:, H : 2 * H] + gh[:, H:] + b[H : 2 * H])
    c = pwl_apply(tanh_table, gx[:, 2 * H :] + (r * h) @ wh[:, 2 * H :] + b[2 * H :])
    return (1.0 - z) * c + z * h


def gru_scan_int8_reference(
    xs: torch.Tensor,  # [B, T, D]
    h0: torch.Tensor,  # [B, H]
    wxq: torch.Tensor,  # int8 [D, 3H]
    whq: torch.Tensor,  # int8 [H, 3H]
    wx_scale: torch.Tensor,  # [3H] or [1, 3H]
    wh_scale: torch.Tensor,
    b: torch.Tensor,  # [3H]
    dts: torch.Tensor,  # [T], unread: the standard cell has no time gate
    sig_table: PWLTable,
    tanh_table: PWLTable,
) -> torch.Tensor:
    """Int8-dequant and PWL-activation scan in float32. Returns hs [B, T, H]."""
    pin_fp32_matmul()
    f32 = torch.float32
    wx = wxq.to(f32) * wx_scale
    wh = whq.to(f32) * wh_scale
    h, hs = h0.to(f32), []
    for t in range(xs.shape[1]):
        h = gru_q_step(xs[:, t].to(f32), h, wx, wh, b, sig_table, tanh_table)
        hs.append(h)
    return torch.stack(hs, dim=1)
