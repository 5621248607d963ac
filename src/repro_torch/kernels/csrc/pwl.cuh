// Piecewise-linear activation tables, the LUT/ROM of the paper's FPGA design,
// shared by the int8 serving kernels (gru_scan_int8, mr_step_int8,
// mr_step_ltc_int8, mr_tick_int8).
//
// Counterpart of repro/kernels/gru_scan/kernel.py:161 (_pwl_eval) and the
// CUDA twin of repro_torch/core/quant.py pwl_apply, which the plain versions
// evaluate. A table arrives packed as 2 * n + 5 floats (core/quant.py
// pwl_pack): n slopes, n intercepts, then x_min, x_max, the segment width,
// and the values below x_min and above x_max (the function at the ends).
// The kernels stage it in shared memory.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kPwlMeta = 5;

__host__ __device__ inline int pwl_floats(int n_seg) { return 2 * n_seg + kPwlMeta; }

// The segment is the truncated quotient (x - x_min) / width (a true
// division), clamped to the table; then slope * x + intercept rounded apart,
// as the plain version rounds them. NaN stays NaN.
__device__ __forceinline__ float pwl_eval(const float* tab, int n, float x) {
  const float x_min = tab[2 * n], x_max = tab[2 * n + 1], width = tab[2 * n + 2];
  int idx = __float2int_rz(__fdiv_rn(__fsub_rn(x, x_min), width));
  idx = min(max(idx, 0), n - 1);
  float y = __fadd_rn(__fmul_rn(tab[idx], x), tab[n + idx]);
  if (x < x_min) y = tab[2 * n + 3];
  if (x > x_max) y = tab[2 * n + 4];
  return y;
}

}  // namespace repro
