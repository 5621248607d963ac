// GRU(-flow) scan of the gru_scan kernel, and the flow gate's softplus and
// alpha, which the warp-cell kernels (warp_cell.cuh) share.
//
// Counterpart of repro/kernels/gru_scan/kernel.py:42-63 (_gru_step_math),
// which the TPU's gru_scan and mr_step share; on the H100 mr_step and the
// tick run the warp cell's step instead (warp_cell.cuh gru_steps, the same
// arithmetic in another summation order). One thread block owns a tile
// of `bb` windows and runs the whole time loop for them: the gate weights,
// the hidden state h [bb, H] and the step's intermediates live in shared
// memory, so nothing of the scan round-trips device memory.
//
// What bounds it on an H100: at the main path's shapes the work is a chain
// of T dependent steps of a few thousand FMAs each, far below one microsecond
// of the card's float32 rate and its memory rate alike; the time is the
// latency of that chain (shared-memory loads feeding FMAs, two block
// barriers per step). The design keeps every operand of the chain on the SM
// and gives each (window, hidden unit) pair its own thread, so a step costs
// one pass over D + H inputs per gate and no device-memory traffic.
//
// The candidate gate is tanh(x.Wx_c + (r*h).Wh_c + b_c), as in the JAX
// package, not torch.nn.GRU's r*(h.Wh_c).
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kInvLipschitzAlpha = 0.4f;  // core/neural_flow.py INV_LIPSCHITZ_ALPHA

// jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

// Shared-memory carve of the scan: weights first, then the tile's state.
struct GruShared {
  float* wx;  // [D, 3H]   columns [r | z | c]
  float* wh;  // [H, 3H]
  float* b;   // [3H]
  float* sp;  // [H]       softplus(time_scale), the flow gate's rate
  float* h;   // [bb, H]   hidden state
  float* rh;  // [bb, H]   r * h, the candidate's recurrent input
  float* z;   // [bb, H]   update gate
  float* gc;  // [bb, H]   x.Wx_c + b_c
};

__host__ __device__ inline size_t gru_shared_floats(int D, int H, int bb) {
  return (size_t)(D + H) * 3 * H + 3 * H + H + 4 * (size_t)bb * H;
}

// Carves the scan's buffers from `base`, stages the weights and h0 of the
// tile, and returns the first float past the carve.
__device__ inline float* gru_setup(GruShared& s, float* base, const float* __restrict__ wx,
                                   const float* __restrict__ wh, const float* __restrict__ b,
                                   const float* __restrict__ time_scale,
                                   const float* __restrict__ h0_tile, int D, int H, int bb) {
  const int H3 = 3 * H;
  float* p = base;
  s.wx = p;  p += D * H3;
  s.wh = p;  p += H * H3;
  s.b = p;   p += H3;
  s.sp = p;  p += H;
  s.h = p;   p += bb * H;
  s.rh = p;  p += bb * H;
  s.z = p;   p += bb * H;
  s.gc = p;  p += bb * H;
  stage(s.wx, wx, D * H3);
  stage(s.wh, wh, H * H3);
  stage(s.b, b, H3);
  for (int i = threadIdx.x; i < H; i += blockDim.x) s.sp[i] = softplus(time_scale[i]);
  stage(s.h, h0_tile, bb * H);
  __syncthreads();
  return p;
}

// Runs the T steps for the block's tile. xs_tile points at the tile's first
// window of xs [B, T, D]; hs_tile (WRITE_HS only) at its first window of
// hs [B, T, H]. On return s.h holds h_T and every thread has passed a barrier.
template <bool FLOW, bool WRITE_HS>
__device__ void gru_scan_tile(const GruShared& s, const float* __restrict__ xs_tile,
                              const float* __restrict__ dts, float* __restrict__ hs_tile,
                              int T, int D, int H, int bb) {
  const int H3 = 3 * H;
  const int n = bb * H;
  for (int t = 0; t < T; ++t) {
    // phase 1: reset and update gates, and the input half of the candidate
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int w = p / H, j = p - w * H;
      const float* x = xs_tile + ((size_t)w * T + t) * D;
      const float* h = s.h + w * H;
      float ar = s.b[j], az = s.b[H + j], ac = s.b[2 * H + j];
      for (int d = 0; d < D; ++d) {
        const float xd = x[d];
        const float* row = s.wx + d * H3;
        ar = fmaf(xd, row[j], ar);
        az = fmaf(xd, row[H + j], az);
        ac = fmaf(xd, row[2 * H + j], ac);
      }
      for (int k = 0; k < H; ++k) {
        const float hk = h[k];
        const float* row = s.wh + k * H3;
        ar = fmaf(hk, row[j], ar);
        az = fmaf(hk, row[H + j], az);
      }
      s.rh[p] = sigmoid(ar) * h[j];
      s.z[p] = sigmoid(az);
      s.gc[p] = ac;
    }
    __syncthreads();
    // phase 2: candidate from r*h, then the (flow) update
    const float dt = dts[t];
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int w = p / H, j = p - w * H;
      const float* rh = s.rh + w * H;
      float ac = s.gc[p];
      for (int k = 0; k < H; ++k) ac = fmaf(rh[k], s.wh[k * H3 + 2 * H + j], ac);
      const float c = tanhf(ac);
      const float h = s.h[p], z = s.z[p];
      float hn;
      if (FLOW) {
        const float phi = tanhf(s.sp[j] * dt);  // phi(0) = 0: F(0) is the identity
        hn = h + phi * kInvLipschitzAlpha * (1.0f - z) * (c - h);
      } else {
        hn = (1.0f - z) * c + z * h;
      }
      s.h[p] = hn;
      if (WRITE_HS) hs_tile[((size_t)w * T + t) * H + j] = hn;
    }
    __syncthreads();
  }
}

}  // namespace repro
