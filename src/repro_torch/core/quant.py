"""Fixed-point emulation and piecewise-linear activations (counterpart of
``repro/core/quant.py``).

The paper's FPGA design computes in ap_fixed arithmetic and evaluates sigmoid
and tanh from LUT/ROM tables. Two emulations live here:

- training (QAT): a Qm.n grid with a straight-through estimator, the forward
  rounds, the backward passes the gradient through unchanged;
- serving (``precision="int8_pwl"``): symmetric int8 weights with one float
  scale per output channel (``quantize_int8``), and piecewise-linear
  activation tables (``pwl_table``: per-segment slopes and intercepts, as the
  FPGA ROM would be filled). The int8 serving kernels
  (``kernels/csrc/pwl.cuh``, ``warp_cell.cuh``) read exactly these.

The tables are built in numpy float64 and cast to float32 once, as the JAX
package builds them, so knots and slopes agree bit for bit.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
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


class Int8Quantized(NamedTuple):
    values: torch.Tensor  # int8
    scale: torch.Tensor  # float32, per channel of ``axis``; the reduced dims kept as 1


def quantize_int8(w: torch.Tensor, axis: int = -1, batch_dims: int = 0) -> Int8Quantized:
    """Symmetric per-channel int8, the weight format of the serving kernels.

    The scale of a channel is ``max(amax, 1e-8) / 127`` over every dimension
    but ``axis`` and the ``batch_dims`` leading ones (``batch_dims=1`` is
    ``jax.vmap`` of the JAX function over a slot axis). ``torch.round``
    rounds half to even, as ``jnp.round`` does, so the codes are JAX's.
    """
    axis = axis % w.ndim
    dims = tuple(d for d in range(batch_dims, w.ndim) if d != axis)
    amax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return Int8Quantized(values=q, scale=scale.to(torch.float32))


def dequantize_int8(q: Int8Quantized, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.values.to(dtype) * q.scale.to(dtype)


class PWLTable(NamedTuple):
    x_min: float
    x_max: float
    slopes: torch.Tensor  # [n_segments] float32
    intercepts: torch.Tensor  # [n_segments] float32
    left: float  # the value below x_min: fn(x_min)
    right: float  # the value above x_max: fn(x_max)


def pwl_table(
    fn: Callable[[np.ndarray], np.ndarray], x_min: float, x_max: float, n_segments: int = 64
) -> PWLTable:
    """The PWL ROM contents of an elementwise function: uniform segments whose
    slope and intercept interpolate ``fn`` at the knots, computed in float64.
    ``np.linspace``, not a float32 ``torch.linspace``, places the knots."""
    knots = np.linspace(x_min, x_max, n_segments + 1)
    y = fn(knots)
    slopes = (y[1:] - y[:-1]) / (knots[1:] - knots[:-1])
    intercepts = y[:-1] - slopes * knots[:-1]
    return PWLTable(
        x_min=float(x_min),
        x_max=float(x_max),
        slopes=torch.from_numpy(slopes.astype(np.float32)),
        intercepts=torch.from_numpy(intercepts.astype(np.float32)),
        left=float(y[0]),
        right=float(y[-1]),
    )


def pwl_width(table: PWLTable) -> float:
    """The segment width, as the float32 the evaluation divides by."""
    return float(np.float32((table.x_max - table.x_min) / table.slopes.shape[0]))


def pwl_apply(table: PWLTable, x: torch.Tensor) -> torch.Tensor:
    """Branch-free PWL evaluation: the segment is the truncated quotient
    ``(x - x_min) / width`` clamped to the table, then one multiply and one
    add (rounded apart), and the table's end values outside [x_min, x_max]."""
    n = table.slopes.shape[0]
    slopes, intercepts = table.slopes.to(x.device), table.intercepts.to(x.device)
    idx = torch.clamp(((x - table.x_min) / pwl_width(table)).to(torch.int32), 0, n - 1).long()
    y = slopes[idx] * x + intercepts[idx]
    y = torch.where(x < table.x_min, torch.full_like(y, table.left), y)
    y = torch.where(x > table.x_max, torch.full_like(y, table.right), y)
    return y.to(x.dtype)


def pwl_floats(n_segments: int) -> int:
    """Length of a packed table (``pwl_pack``)."""
    return 2 * n_segments + 5


def pwl_pack(table: PWLTable) -> torch.Tensor:
    """A table as the int8 kernels read it (``csrc/pwl.cuh``): float32
    [2 n + 5] = slopes, intercepts, x_min, x_max, width, left, right."""
    meta = torch.tensor(
        [table.x_min, table.x_max, pwl_width(table), table.left, table.right], dtype=torch.float32
    )
    return torch.cat([table.slopes, table.intercepts, meta])


def _np_sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def make_sigmoid_table(n_segments: int = 64) -> PWLTable:
    return pwl_table(_np_sigmoid, -8.0, 8.0, n_segments)


def make_tanh_table(n_segments: int = 64) -> PWLTable:
    return pwl_table(np.tanh, -4.0, 4.0, n_segments)


N_SEG = 16  # segments of the int8 serving path's tables (the JAX wrappers' n_seg)
PWL_FLOATS = pwl_floats(N_SEG)  # one packed serving table, as the int8 kernels carve it


@functools.lru_cache(maxsize=None)
def serving_tables() -> tuple[PWLTable, PWLTable]:
    """(sigmoid, tanh) tables of the int8 serving path, built once."""
    return make_sigmoid_table(N_SEG), make_tanh_table(N_SEG)


@functools.lru_cache(maxsize=None)
def _serving_packs(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(pwl_pack(t).to(device) for t in serving_tables())


def serving_packs(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``serving_tables`` packed for the int8 kernels on ``device``, built
    once per device."""
    return _serving_packs(str(device))


def pwl_max_error(
    table: PWLTable, fn: Callable[[np.ndarray], np.ndarray], n_probe: int = 20001
) -> float:
    """Max |pwl_apply - fn| over ``n_probe`` points of [x_min, x_max]."""
    xs = np.linspace(table.x_min, table.x_max, n_probe)
    approx = pwl_apply(table, torch.from_numpy(xs.astype(np.float32))).numpy()
    return float(np.max(np.abs(approx - fn(xs))))


class QuantConfig(NamedTuple):
    """Accuracy-budgeted widths (paper: 8-16 b activations, 12-16 b weights)."""

    act_int_bits: int = 3
    act_frac_bits: int = 13  # 16-bit activations
    weight_int_bits: int = 2
    weight_frac_bits: int = 12  # 14-bit weights
    pwl_segments: int = 64  # unread: the int8 serving path uses N_SEG (16), as in JAX

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
