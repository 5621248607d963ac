// Int8 dense head of the block-per-tile int8 serving kernels (mr_step_int8,
// mr_step_ltc_int8; mr_tick_int8 runs warp_cell.cuh's Int8Head): RMS-norm -> ReLU MLP with int8 w1 [H, Dh]
// and w2 [Dh, K], one float scale per output channel, float biases. No
// activation step: the int8 TPU kernels call _head_math with act_bits=None.
//
// Counterpart of the head of repro/kernels/mr_step/kernel.py:240-244 (the
// int8 kernels dequantize w1 and w2 and call _head_math) and the int8 twin
// of head.cuh, whose RMS-norm it shares. Each weight is dequantized on use as
// float(q) * scale[column], the plain version's one-rounding product; the
// bias is added after the sum, as the plain version's h @ w1 + b1 adds it.
#pragma once

#include "head.cuh"

namespace repro {

struct HeadQShared {
  float* s1;   // [Dh] w1 scales
  float* b1;   // [Dh]
  float* s2;   // [K]  w2 scales
  float* b2;   // [K]
  float* hid;  // [bb, Dh] hidden layer of the tile
  int8_t* w1;  // [H, Dh]
  int8_t* w2;  // [Dh, K]
};

__host__ __device__ inline size_t head_q_shared_floats(int H, int Dh, int K, int bb) {
  return 2 * (size_t)Dh + 2 * (size_t)K + (size_t)bb * Dh + q_floats((size_t)H * Dh) +
         q_floats((size_t)Dh * K);
}

// Carves the head's buffers from `p` and stages its weights. No barrier: the
// caller's next __syncthreads publishes them. Returns the first float past
// the carve.
__device__ inline float* head_q_setup(HeadQShared& s, float* p, const int8_t* __restrict__ w1,
                                      const float* __restrict__ s1, const float* __restrict__ b1,
                                      const int8_t* __restrict__ w2, const float* __restrict__ s2,
                                      const float* __restrict__ b2, int H, int Dh, int K,
                                      int bb) {
  s.s1 = p;   p += Dh;
  s.b1 = p;   p += Dh;
  s.s2 = p;   p += K;
  s.b2 = p;   p += K;
  s.hid = p;  p += bb * Dh;
  s.w1 = carve_q(p, (size_t)H * Dh);
  s.w2 = carve_q(p, (size_t)Dh * K);
  stage(s.s1, s1, Dh);
  stage(s.b1, b1, Dh);
  stage(s.s2, s2, K);
  stage(s.b2, b2, K);
  stage_q(s.w1, w1, H * Dh);
  stage_q(s.w2, w2, Dh * K);
  return p;
}

// out_tile[w, :] = relu(norm(h[w]) . w1 + b1) . w2 + b2 for the tile's bb
// windows; h and hn are [bb, H] in shared memory, and hn may be h itself
// (head.cuh rms_norm_tile). Every thread of the block calls it, after
// a barrier that published h.
__device__ inline void head_q_tile(const HeadQShared& s, const float* h, float* hn,
                                   float* __restrict__ out_tile, int H, int Dh, int K, int bb) {
  rms_norm_tile(h, hn, H, bb, 0, -1);
  __syncthreads();

  // layer 1: relu(hn . w1 + b1)
  for (int q = threadIdx.x; q < bb * Dh; q += blockDim.x) {
    const int w = q / Dh, i = q - w * Dh;
    const float* x = hn + w * H;
    const float sc = s.s1[i];
    float a = 0.0f;
    for (int k = 0; k < H; ++k) a = fmaf(x[k], __fmul_rn((float)s.w1[k * Dh + i], sc), a);
    s.hid[q] = fmaxf(__fadd_rn(a, s.b1[i]), 0.0f);
  }
  __syncthreads();

  // layer 2: hid . w2 + b2 -> out_tile [bb, K]
  for (int q = threadIdx.x; q < bb * K; q += blockDim.x) {
    const int w = q / K, o = q - w * K;
    const float* z = s.hid + w * Dh;
    const float sc = s.s2[o];
    float a = 0.0f;
    for (int i = 0; i < Dh; ++i) a = fmaf(z[i], __fmul_rn((float)s.w2[i * K + o], sc), a);
    out_tile[q] = __fadd_rn(a, s.b2[o]);
  }
}

}  // namespace repro
