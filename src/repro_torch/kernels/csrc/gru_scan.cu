// GRU(-flow) sequence scan: xs [B, T, D] -> hs [B, T, H].
//
// Replaces repro/kernels/gru_scan/kernel.py:107 gru_scan_pallas (body
// _gru_scan_kernel, :66-103). One block per tile of `bb` windows runs the
// whole time loop with the gate weights and h in shared memory
// (gru_step.cuh) and writes each step's h.
//
// What bounds it on an H100: like mr_step, the chain of T dependent steps;
// the hs write (B*T*H floats, 256 KB at the quickstart shapes) is the only
// sizeable traffic and goes out one coalesced row of H per window and step.
#include "gru_step.cuh"

namespace repro {

template <bool FLOW>
__global__ void gru_scan_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                                const float* __restrict__ wx, const float* __restrict__ wh,
                                const float* __restrict__ b, const float* __restrict__ time_scale,
                                const float* __restrict__ dts, float* __restrict__ hs, int T,
                                int D, int H, int bb) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  GruShared s;
  gru_setup(s, smem, wx, wh, b, time_scale, h0 + (size_t)b0 * H, D, H, bb);
  gru_scan_tile<FLOW, true>(s, xs + (size_t)b0 * T * D, dts, hs + (size_t)b0 * T * H, T, D, H,
                            bb);
}

}  // namespace repro

extern "C" int gru_scan_launch(const float* xs, const float* h0, const float* wx,
                               const float* wh, const float* b, const float* time_scale,
                               const float* dts, float* hs, int B, int T, int D, int H, int bb,
                               int flow, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = repro::gru_shared_floats(D, H, bb) * sizeof(float);
  auto kernel = flow ? &repro::gru_scan_kernel<true> : &repro::gru_scan_kernel<false>;
  cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B / bb, repro::tile_threads(bb, H), smem, (cudaStream_t)stream>>>(
      xs, h0, wx, wh, b, time_scale, dts, hs, T, D, H, bb);
  return (int)cudaGetLastError();
}
