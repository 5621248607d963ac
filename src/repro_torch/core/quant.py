"""Fixed-point fake quantization for QAT (counterpart of ``repro/core/quant.py``).

The paper's FPGA design computes in ap_fixed arithmetic. Training emulates it
with a Qm.n grid and a straight-through estimator: the forward rounds, the
backward passes the gradient through unchanged. Only the QAT part is here;
int8 weight storage and the piecewise-linear activation tables belong to the
int8 serving kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def quantize_fixed(x: torch.Tensor, int_bits: int, frac_bits: int) -> torch.Tensor:
    """Round to the Q(int_bits).(frac_bits) two's-complement grid, saturating.

    ``torch.round`` rounds half to even, as ``jnp.round`` does (the CUDA
    head uses ``rintf`` for the same reason).
    """
    scale = 2.0**frac_bits
    lo = -(2.0 ** (int_bits + frac_bits - 1))
    hi = 2.0 ** (int_bits + frac_bits - 1) - 1
    return torch.clamp(torch.round(x * scale), lo, hi) / scale


def fake_quant_ste(x: torch.Tensor, int_bits: int, frac_bits: int) -> torch.Tensor:
    """Quantized forward, identity gradient."""
    return x + (quantize_fixed(x, int_bits, frac_bits) - x).detach()


class QuantConfig(NamedTuple):
    """Accuracy-budgeted widths (paper: 8-16 b activations, 12-16 b weights)."""

    act_int_bits: int = 3
    act_frac_bits: int = 13  # 16-bit activations
    weight_int_bits: int = 2
    weight_frac_bits: int = 12  # 14-bit weights
    pwl_segments: int = 64

    @property
    def act_bits(self) -> int:
        return self.act_int_bits + self.act_frac_bits

    @property
    def weight_bits(self) -> int:
        return self.weight_int_bits + self.weight_frac_bits


def qat_weight(w: torch.Tensor, quant: QuantConfig | None) -> torch.Tensor:
    """The one QAT weight treatment (merinda, encoders and mr_step share it)."""
    if quant is None:
        return w
    return fake_quant_ste(w, quant.weight_int_bits, quant.weight_frac_bits)


def qat_act(x: torch.Tensor, quant: QuantConfig | None) -> torch.Tensor:
    """The one QAT activation treatment (see ``qat_weight``)."""
    if quant is None:
        return x
    return fake_quant_ste(x, quant.act_int_bits, quant.act_frac_bits)


def act_bits(quant: QuantConfig | None) -> tuple[int, int] | None:
    """(int_bits, frac_bits) of the head's activation step, or None."""
    return None if quant is None else (quant.act_int_bits, quant.act_frac_bits)
