// Stage-fused MR per-window step: GRU(-flow) scan -> RMS-norm -> optional
// Qm.n activation step -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:129 mr_step_pallas (body
// _mr_step_kernel, :79-125). One block per tile of `bb` windows: the gate
// weights, time-gate rates and head weights are staged once in dynamic
// shared memory, the scan runs inside the block (gru_step.cuh), and the head
// (head.cuh) reads h_T straight from shared memory. Per window the only
// device-memory traffic is x in and the head output out; hs [B, T, H] is
// never written.
//
// What bounds it on an H100: the chain of T dependent steps (see
// gru_step.cuh). At the quickstart shapes the whole call is ~14 MFLOP and
// ~44 KB, under a microsecond of the card's float32 rate; the tiling
// (kernels/mr_step/tiling.py) keeps at least min(B, 132) blocks in the grid
// so the windows' chains run side by side on every SM instead of queueing
// on one.
#include "gru_step.cuh"
#include "head.cuh"

namespace repro {

inline size_t mr_step_shared_floats(int D, int H, int Dh, int K, int bb) {
  return gru_shared_floats(D, H, bb) + head_shared_floats(H, Dh, K, bb);
}

template <bool FLOW>
__global__ void mr_step_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                               const float* __restrict__ wx, const float* __restrict__ wh,
                               const float* __restrict__ b, const float* __restrict__ time_scale,
                               const float* __restrict__ dts, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ w2,
                               const float* __restrict__ b2, float* __restrict__ out, int T,
                               int D, int H, int Dh, int K, int bb, int act_int, int act_frac) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  GruShared s;
  float* p = gru_setup(s, smem, wx, wh, b, time_scale, h0 + (size_t)b0 * H, D, H, bb);
  HeadShared hd;
  head_setup(hd, p, w1, b1, w2, b2, H, Dh, K, bb);
  // the head weights are first read after the scan's barriers

  gru_scan_tile<FLOW, false>(s, xs + (size_t)b0 * T * D, dts, nullptr, T, D, H, bb);
  head_tile(hd, s.h, s.rh, out + (size_t)b0 * K, H, Dh, K, bb, act_int, act_frac);
}

}  // namespace repro

extern "C" int mr_step_launch(const float* xs, const float* h0, const float* wx, const float* wh,
                              const float* b, const float* time_scale, const float* dts,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              float* out, int B, int T, int D, int H, int Dh, int K, int bb,
                              int flow, int act_int, int act_frac, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = repro::mr_step_shared_floats(D, H, Dh, K, bb) * sizeof(float);
  auto kernel = flow ? &repro::mr_step_kernel<true> : &repro::mr_step_kernel<false>;
  cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B / bb, repro::tile_threads(bb, H), smem, (cudaStream_t)stream>>>(
      xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, T, D, H, Dh, K, bb, act_int,
      act_frac);
  return (int)cudaGetLastError();
}
