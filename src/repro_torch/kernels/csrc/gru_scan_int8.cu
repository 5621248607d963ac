// Int8/PWL standard-GRU sequence scan: xs [B, T, D] -> hs [B, T, H].
//
// Replaces repro/kernels/gru_scan/kernel.py:246 gru_scan_pallas_int8 (body
// _gru_scan_q_kernel, :207-243). One block per tile of `bb` windows runs the
// whole time loop with the int8 gate weights, their scales, the PWL tables
// and h in shared memory (gru_q_step.cuh) and writes each step's h.
//
// What bounds it on an H100: the chain of T dependent steps, two block
// barriers each; the hs write (B*T*H floats) is the only sizeable traffic.
#include "gru_q_step.cuh"

namespace repro {

__global__ void gru_scan_int8_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                                     const int8_t* __restrict__ wxq,
                                     const int8_t* __restrict__ whq,
                                     const float* __restrict__ sx, const float* __restrict__ sh,
                                     const float* __restrict__ b, const float* __restrict__ sig,
                                     const float* __restrict__ tnh, float* __restrict__ hs, int T,
                                     int D, int H, int bb, int n_seg) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  GruQShared s;
  gru_q_setup(s, smem, wxq, whq, sx, sh, b, sig, tnh, h0 + (size_t)b0 * H, D, H, bb, n_seg);
  gru_q_scan_tile<true>(s, xs + (size_t)b0 * T * D, hs + (size_t)b0 * T * H, T, D, H, bb, n_seg);
}

}  // namespace repro

extern "C" int gru_scan_int8_launch(const float* xs, const float* h0, const int8_t* wxq,
                                    const int8_t* whq, const float* sx, const float* sh,
                                    const float* b, const float* sig, const float* tnh, float* hs,
                                    int B, int T, int D, int H, int bb, int n_seg, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_seg < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = repro::gru_q_shared_floats(D, H, bb, n_seg) * sizeof(float);
  cudaError_t err = repro::allow_shared(repro::gru_scan_int8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  repro::gru_scan_int8_kernel<<<B / bb, repro::tile_threads(bb, H), smem, (cudaStream_t)stream>>>(
      xs, h0, wxq, whq, sx, sh, b, sig, tnh, hs, T, D, H, bb, n_seg);
  return (int)cudaGetLastError();
}
