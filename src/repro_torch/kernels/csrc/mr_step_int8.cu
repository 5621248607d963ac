// Stage-fused fixed-point MR step: int8/PWL standard-GRU scan -> RMS-norm ->
// ReLU MLP head with int8 weights. The serving readout of
// precision="int8_pwl" on the GRU rows.
//
// Replaces repro/kernels/mr_step/kernel.py:251 mr_step_pallas_int8 (body
// _mr_step_q_kernel, :196-248). One block per tile of `bb` windows: the int8
// gate and head weights, their per-channel scales, the biases and the two
// PWL tables are staged once in dynamic shared memory (about a quarter of
// mr_step's carve), the scan runs inside the block (gru_q_step.cuh) and the
// int8 head (head_q.cuh) reads h_T straight from shared memory. Per window
// the only device-memory traffic is x in and the head output out.
//
// What bounds it on an H100: the chain of T dependent steps, as mr_step; at
// the quickstart readout (B=193, T=32, D=2, H=32) ~45 MFLOP and ~28 KB, far
// under a microsecond of the card's float32 rate. The tiling
// (kernels/mr_step/tiling.py) keeps min(B, 132) blocks in the grid.
#include "gru_q_step.cuh"
#include "head_q.cuh"

namespace repro {

__global__ void mr_step_int8_kernel(
    const float* __restrict__ xs, const float* __restrict__ h0, const int8_t* __restrict__ wxq,
    const int8_t* __restrict__ whq, const float* __restrict__ sx, const float* __restrict__ sh,
    const float* __restrict__ b, const float* __restrict__ sig, const float* __restrict__ tnh,
    const int8_t* __restrict__ w1q, const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2q, const float* __restrict__ s2, const float* __restrict__ b2,
    float* __restrict__ out, int T, int D, int H, int Dh, int K, int bb, int n_seg) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  GruQShared s;
  float* p =
      gru_q_setup(s, smem, wxq, whq, sx, sh, b, sig, tnh, h0 + (size_t)b0 * H, D, H, bb, n_seg);
  HeadQShared hd;
  head_q_setup(hd, p, w1q, s1, b1, w2q, s2, b2, H, Dh, K, bb);
  // the head weights are first read after the scan's barriers
  gru_q_scan_tile<false>(s, xs + (size_t)b0 * T * D, nullptr, T, D, H, bb, n_seg);
  head_q_tile(hd, s.h, s.rh, out + (size_t)b0 * K, H, Dh, K, bb);
}

}  // namespace repro

extern "C" int mr_step_int8_launch(const float* xs, const float* h0, const int8_t* wxq,
                                   const int8_t* whq, const float* sx, const float* sh,
                                   const float* b, const float* sig, const float* tnh,
                                   const int8_t* w1q, const float* s1, const float* b1,
                                   const int8_t* w2q, const float* s2, const float* b2, float* out,
                                   int B, int T, int D, int H, int Dh, int K, int bb, int n_seg,
                                   void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_seg < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (repro::gru_q_shared_floats(D, H, bb, n_seg) +
                       repro::head_q_shared_floats(H, Dh, K, bb)) *
                      sizeof(float);
  cudaError_t err = repro::allow_shared(repro::mr_step_int8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  repro::mr_step_int8_kernel<<<B / bb, repro::tile_threads(bb, H), smem, (cudaStream_t)stream>>>(
      xs, h0, wxq, whq, sx, sh, b, sig, tnh, w1q, s1, b1, w2q, s2, b2, out, T, D, H, Dh, K, bb,
      n_seg);
  return (int)cudaGetLastError();
}
