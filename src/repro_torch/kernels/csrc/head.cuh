// Dense head shared by the three fused kernels (mr_step, mr_step_ltc,
// mr_step_node): RMS-norm -> optional Qm.n activation step -> ReLU MLP.
//
// Counterpart of repro/kernels/mr_step/kernel.py:64-76 (_head_math), which
// the three fp32 TPU kernels share in the same way, and the CUDA twin of
// repro_torch/core/merinda.py head_math. It runs once per window after the
// scan, from the tile's h_T in shared memory, so it costs a few hundred FMAs
// per (window, output) and no device-memory traffic but the [bb, K] result.
//
// QAT is a training-time switch, so the activation step arrives as two ints,
// (act_int, act_frac), with act_frac < 0 meaning none, not as a template.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kRmsEps = 1e-6f;  // core/merinda.py RMS_EPS

// quantize_fixed: clip(rint(x * 2^f), -2^(i+f-1), 2^(i+f-1) - 1) / 2^f.
// rintf rounds half to even, as jnp.round and torch.round do.
__device__ __forceinline__ float quantize_fixed(float x, int int_bits, int frac_bits) {
  const float scale = ldexpf(1.0f, frac_bits);
  const float top = ldexpf(1.0f, int_bits + frac_bits - 1);
  return fminf(fmaxf(rintf(x * scale), -top), top - 1.0f) / scale;
}

struct HeadShared {
  float* w1;   // [H, Dh]
  float* b1;   // [Dh]
  float* w2;   // [Dh, K]
  float* b2;   // [K]
  float* hid;  // [bb, Dh] hidden layer of the tile
};

__host__ __device__ inline size_t head_shared_floats(int H, int Dh, int K, int bb) {
  return (size_t)H * Dh + Dh + (size_t)Dh * K + K + (size_t)bb * Dh;
}

// Carves the head's buffers from `p` and stages its weights. No barrier: the
// caller's next __syncthreads publishes them. Returns the first float past
// the carve.
__device__ inline float* head_setup(HeadShared& s, float* p, const float* __restrict__ w1,
                                    const float* __restrict__ b1, const float* __restrict__ w2,
                                    const float* __restrict__ b2, int H, int Dh, int K, int bb) {
  s.w1 = p;   p += H * Dh;
  s.b1 = p;   p += Dh;
  s.w2 = p;   p += Dh * K;
  s.b2 = p;   p += K;
  s.hid = p;  p += bb * Dh;
  stage(s.w1, w1, H * Dh);
  stage(s.b1, b1, Dh);
  stage(s.w2, w2, Dh * K);
  stage(s.b2, b2, K);
  return p;
}

// hn[w] = q(h[w] * rsqrt(mean(h[w]^2) + eps)) for the tile's bb windows, one
// warp a window with a shuffle reduction over H; q is the optional Qm.n step
// (act_frac < 0: none). h and hn are [bb, H] in shared memory; hn may be h
// itself, since each lane rewrites only the units it read after the warp's
// reduction. The caller publishes hn with a barrier.
__device__ inline void rms_norm_tile(const float* h, float* hn, int H, int bb, int act_int,
                                     int act_frac) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int w = warp; w < bb; w += n_warps) {
    const float* hw = h + w * H;
    float acc = 0.0f;
    for (int k = lane; k < H; k += 32) acc = fmaf(hw[k], hw[k], acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float inv = rsqrtf(acc / H + kRmsEps);
    for (int k = lane; k < H; k += 32) {
      const float v = hw[k] * inv;
      hn[w * H + k] = act_frac >= 0 ? quantize_fixed(v, act_int, act_frac) : v;
    }
  }
}

// out_tile[w, :] = relu(q(norm(h[w])) . w1 + b1) . w2 + b2 for the tile's bb
// windows. h and hn are [bb, H] in shared memory; hn receives the normalized
// (and quantized) state and may be h itself (rms_norm_tile). Every thread of
// the block calls it, after a barrier that published h.
__device__ inline void head_tile(const HeadShared& s, const float* h, float* hn,
                                 float* __restrict__ out_tile, int H, int Dh, int K, int bb,
                                 int act_int, int act_frac) {
  rms_norm_tile(h, hn, H, bb, act_int, act_frac);
  __syncthreads();

  // layer 1: relu(hn . w1 + b1)
  for (int q = threadIdx.x; q < bb * Dh; q += blockDim.x) {
    const int w = q / Dh, i = q - w * Dh;
    const float* x = hn + w * H;
    float a = s.b1[i];
    for (int k = 0; k < H; ++k) a = fmaf(x[k], s.w1[k * Dh + i], a);
    s.hid[q] = fmaxf(a, 0.0f);
  }
  __syncthreads();

  // layer 2: hid . w2 + b2 -> out_tile [bb, K]
  for (int q = threadIdx.x; q < bb * K; q += blockDim.x) {
    const int w = q / K, o = q - w * K;
    const float* z = s.hid + w * Dh;
    float a = s.b2[o];
    for (int i = 0; i < Dh; ++i) a = fmaf(z[i], s.w2[i * K + o], a);
    out_tile[q] = a;
  }
}

}  // namespace repro
