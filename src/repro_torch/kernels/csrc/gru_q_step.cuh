// Quantized standard-GRU step of the block-per-tile gru_scan_int8 kernel
// (mr_step_int8 and mr_tick_int8 run warp_cell.cuh's Int8Cell): int8 gate
// weights with one float scale per output channel, PWL sigmoid and tanh
// (pwl.cuh), float32 sums.
//
// Counterpart of repro/kernels/gru_scan/kernel.py:174 (_gru_q_step_math),
// which the TPU kernels share in the same way. One thread block owns a tile of `bb` windows and runs the
// whole time loop for them, one thread per (window, hidden unit). The gate
// weights stay int8 in shared memory, a quarter of the fp32 carve, beside
// their scales; each is dequantized on use as float(q) * scale[column], the
// one-rounding product the plain version's dequantized weight holds. A
// thread reads the same three columns every step, so its scales sit in
// registers.
//
// What bounds it on an H100: the chain of T dependent steps (two block
// barriers each); the dequantizing multiply adds one operation to
// each multiply-add of the chain and no device-memory traffic.
//
// Rounding: the plain version forms gx = x.Wx and gh = h.Wh separately and
// adds the bias last, and its update (1 - z) * c + z * h rounds each
// product; the step does the same (__fmul_rn/__fadd_rn), so only the order
// inside the dot products differs from it.
#pragma once

#include "common.cuh"
#include "pwl.cuh"

namespace repro {

// Shared-memory carve of the quantized scan: floats first, then the int8
// weights in whole floats (q_floats).
struct GruQShared {
  float* sx;   // [3H]     wx scales, columns [r | z | c]
  float* sh;   // [3H]     wh scales
  float* b;    // [3H]
  float* sig;  // [pwl_floats(n_seg)] PWL sigmoid on [-8, 8]
  float* tnh;  // [pwl_floats(n_seg)] PWL tanh on [-4, 4]
  float* h;    // [bb, H]  hidden state
  float* rh;   // [bb, H]  r * h, the candidate's recurrent input
  float* z;    // [bb, H]  update gate
  float* gc;   // [bb, H]  x.Wx_c
  int8_t* wx;  // [D, 3H]
  int8_t* wh;  // [H, 3H]
};

__host__ __device__ inline size_t gru_q_shared_floats(int D, int H, int bb, int n_seg) {
  return 9 * (size_t)H + 2 * (size_t)pwl_floats(n_seg) + 4 * (size_t)bb * H +
         q_floats((size_t)D * 3 * H) + q_floats((size_t)H * 3 * H);
}

// Carves the scan's buffers from `base`, stages the weights, scales, tables
// and h0 of the tile, and returns the first float past the carve.
__device__ inline float* gru_q_setup(GruQShared& s, float* base, const int8_t* __restrict__ wx,
                                     const int8_t* __restrict__ wh, const float* __restrict__ sx,
                                     const float* __restrict__ sh, const float* __restrict__ b,
                                     const float* __restrict__ sig, const float* __restrict__ tnh,
                                     const float* __restrict__ h0_tile, int D, int H, int bb,
                                     int n_seg) {
  const int H3 = 3 * H, nt = pwl_floats(n_seg);
  float* p = base;
  s.sx = p;   p += H3;
  s.sh = p;   p += H3;
  s.b = p;    p += H3;
  s.sig = p;  p += nt;
  s.tnh = p;  p += nt;
  s.h = p;    p += bb * H;
  s.rh = p;   p += bb * H;
  s.z = p;    p += bb * H;
  s.gc = p;   p += bb * H;
  s.wx = carve_q(p, (size_t)D * H3);
  s.wh = carve_q(p, (size_t)H * H3);
  stage(s.sx, sx, H3);
  stage(s.sh, sh, H3);
  stage(s.b, b, H3);
  stage(s.sig, sig, nt);
  stage(s.tnh, tnh, nt);
  stage(s.h, h0_tile, bb * H);
  stage_q(s.wx, wx, D * H3);
  stage_q(s.wh, wh, H * H3);
  __syncthreads();
  return p;
}

// Runs the T steps for the block's tile. xs_tile points at the tile's first
// window of xs [B, T, D]; hs_tile (WRITE_HS only) at its first window of
// hs [B, T, H]. On return s.h holds h_T and every thread has passed a barrier.
template <bool WRITE_HS>
__device__ void gru_q_scan_tile(const GruQShared& s, const float* __restrict__ xs_tile,
                                float* __restrict__ hs_tile, int T, int D, int H, int bb,
                                int n_seg) {
  const int H3 = 3 * H;
  const int n = bb * H;
  for (int t = 0; t < T; ++t) {
    // phase 1: reset and update gates, and the input half of the candidate
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int w = p / H, j = p - w * H;
      const float* x = xs_tile + ((size_t)w * T + t) * D;
      const float* h = s.h + w * H;
      const float sxr = s.sx[j], sxz = s.sx[H + j], sxc = s.sx[2 * H + j];
      const float shr = s.sh[j], shz = s.sh[H + j];
      float xr = 0.0f, xz = 0.0f, xc = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float xd = x[d];
        const int8_t* row = s.wx + d * H3;
        xr = fmaf(xd, __fmul_rn((float)row[j], sxr), xr);
        xz = fmaf(xd, __fmul_rn((float)row[H + j], sxz), xz);
        xc = fmaf(xd, __fmul_rn((float)row[2 * H + j], sxc), xc);
      }
      float hr = 0.0f, hz = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float hk = h[k];
        const int8_t* row = s.wh + k * H3;
        hr = fmaf(hk, __fmul_rn((float)row[j], shr), hr);
        hz = fmaf(hk, __fmul_rn((float)row[H + j], shz), hz);
      }
      const float r = pwl_eval(s.sig, n_seg, __fadd_rn(__fadd_rn(xr, hr), s.b[j]));
      s.z[p] = pwl_eval(s.sig, n_seg, __fadd_rn(__fadd_rn(xz, hz), s.b[H + j]));
      s.rh[p] = __fmul_rn(r, h[j]);
      s.gc[p] = xc;
    }
    __syncthreads();
    // phase 2: candidate from r*h, then the update
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int w = p / H, j = p - w * H;
      const float* rh = s.rh + w * H;
      const float shc = s.sh[2 * H + j];
      float ch = 0.0f;
      for (int k = 0; k < H; ++k)
        ch = fmaf(rh[k], __fmul_rn((float)s.wh[k * H3 + 2 * H + j], shc), ch);
      const float c = pwl_eval(s.tnh, n_seg, __fadd_rn(__fadd_rn(s.gc[p], ch), s.b[2 * H + j]));
      const float h = s.h[p], z = s.z[p];
      const float hn = __fadd_rn(__fmul_rn(1.0f - z, c), __fmul_rn(z, h));
      s.h[p] = hn;
      if (WRITE_HS) hs_tile[((size_t)w * T + t) * H + j] = hn;
    }
    __syncthreads();
  }
}

}  // namespace repro
