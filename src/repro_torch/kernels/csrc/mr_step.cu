// Stage-fused MR per-window step: GRU(-flow) scan -> RMS-norm -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:129 mr_step_pallas (body
// _mr_step_kernel, :79-125). One block per tile of `bb` windows: the gate
// weights, time-gate rates and head weights are staged once in dynamic
// shared memory, the scan runs inside the block (gru_step.cuh), and the head
// reads h_T straight from shared memory. Per window the only device-memory
// traffic is x in and the head output out; hs [B, T, H] is never written.
//
// What bounds it on an H100: the chain of T dependent steps (see
// gru_step.cuh). At the quickstart shapes the whole call is ~14 MFLOP and
// ~44 KB, under a microsecond of the card's float32 rate; the tiling
// (kernels/mr_step/tiling.py) keeps at least min(B, 132) blocks in the grid
// so the windows' chains run side by side on every SM instead of queueing
// on one.
#include "gru_step.cuh"

namespace repro {

inline size_t mr_step_shared_floats(int D, int H, int Dh, int K, int bb) {
  return gru_shared_floats(D, H, bb) + (size_t)H * Dh + Dh + (size_t)Dh * K + K +
         (size_t)bb * Dh;
}

template <bool FLOW>
__global__ void mr_step_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                               const float* __restrict__ wx, const float* __restrict__ wh,
                               const float* __restrict__ b, const float* __restrict__ time_scale,
                               const float* __restrict__ dts, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ w2,
                               const float* __restrict__ b2, float* __restrict__ out, int T,
                               int D, int H, int Dh, int K, int bb) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  GruShared s;
  float* p = gru_setup(s, smem, wx, wh, b, time_scale, h0 + (size_t)b0 * H, D, H, bb);
  float* w1s = p;  p += H * Dh;
  float* b1s = p;  p += Dh;
  float* w2s = p;  p += Dh * K;
  float* b2s = p;  p += K;
  float* hid = p;  // [bb, Dh] head hidden layer
  stage(w1s, w1, H * Dh);
  stage(b1s, b1, Dh);
  stage(w2s, w2, Dh * K);
  stage(b2s, b2, K);
  // the head weights are first read after the scan's barriers

  gru_scan_tile<FLOW, false>(s, xs + (size_t)b0 * T * D, dts, nullptr, T, D, H, bb);

  // RMS-norm of h_T: one warp per window, a shuffle reduction over H
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int w = warp; w < bb; w += n_warps) {
    const float* h = s.h + w * H;
    float acc = 0.0f;
    for (int k = lane; k < H; k += 32) acc = fmaf(h[k], h[k], acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float inv = rsqrtf(acc / H + kRmsEps);
    for (int k = lane; k < H; k += 32) s.rh[w * H + k] = h[k] * inv;  // rh now holds norm(h)
  }
  __syncthreads();

  // head layer 1: relu(norm(h) . w1 + b1)
  for (int q = threadIdx.x; q < bb * Dh; q += blockDim.x) {
    const int w = q / Dh, i = q - w * Dh;
    const float* hn = s.rh + w * H;
    float a = b1s[i];
    for (int k = 0; k < H; ++k) a = fmaf(hn[k], w1s[k * Dh + i], a);
    hid[q] = fmaxf(a, 0.0f);
  }
  __syncthreads();

  // head layer 2: hid . w2 + b2 -> out [B, K]
  for (int q = threadIdx.x; q < bb * K; q += blockDim.x) {
    const int w = q / K, o = q - w * K;
    const float* z = hid + w * Dh;
    float a = b2s[o];
    for (int i = 0; i < Dh; ++i) a = fmaf(z[i], w2s[i * K + o], a);
    out[(size_t)(b0 + w) * K + o] = a;
  }
}

}  // namespace repro

extern "C" int mr_step_launch(const float* xs, const float* h0, const float* wx, const float* wh,
                              const float* b, const float* time_scale, const float* dts,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              float* out, int B, int T, int D, int H, int Dh, int K, int bb,
                              int flow, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = repro::mr_step_shared_floats(D, H, Dh, K, bb) * sizeof(float);
  auto kernel = flow ? &repro::mr_step_kernel<true> : &repro::mr_step_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B / bb, repro::gru_threads(bb, H), smem, (cudaStream_t)stream>>>(
      xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, T, D, H, Dh, K, bb);
  return (int)cudaGetLastError();
}
