// Stage-fused fixed-point MR step: int8/PWL standard-GRU scan -> RMS-norm ->
// ReLU MLP head with int8 weights. The serving readout of
// precision="int8_pwl" on the GRU rows.
//
// Replaces repro/kernels/mr_step/kernel.py:251 mr_step_pallas_int8 (body
// _mr_step_q_kernel, :196-248; step gru_scan/kernel.py:174 _gru_q_step_math).
// mr_step's warp-per-window recurrence on the warp cell's int8/PWL policy
// (warp_cell.cuh gru_windows with GruQArgs: Int8Cell, Int8Head): a block of
// `bb` windows stages the int8 gate and head weights, their per-column
// scales, the biases and the two PWL tables once by cp.async (GruQLayout),
// then each warp runs its window's T steps and the head with no block
// barrier. At H <= 32 a lane dequantizes its units' 96 recurrent weights
// once into registers, so no multiply is left on the chain; above, the block
// dequantizes the columns once at staging into a column-major float copy,
// read a float4 of a column a load as in mr_step (a dequantizing multiply and
// conversion beside every FMA of the chain made H = 64 slower than the
// block-per-tile kernel). x.Wx is computed a chunk of steps ahead; on the chain
// each gate is (x.Wx + h.Wh) + b, both adds rounded, then the PWL sigmoid or
// tanh with its IEEE division. The standard cell only: dts and time_scale are
// not read. Per window the only device-memory traffic is x in and the head
// output out.
//
// What bounds it on an H100: the chain of T dependent steps, as mr_step; at
// the quickstart readout (B=193, T=32, D=2, H=32) ~45 MFLOP and ~28 KB, far
// under a microsecond of the card's float32 rate. The tiling
// (kernels/mr_step/tiling.py) keeps min(B, 132) blocks in the grid.
#include "warp_cell.cuh"

namespace repro {

template <int N>
// minBlocksPerSM = 1, as mr_step: the cell's registers decide the schedule
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_int8_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                        const int8_t* __restrict__ wxq, const int8_t* __restrict__ whq,
                        const float* __restrict__ sx, const float* __restrict__ sh,
                        const float* __restrict__ b, const float* __restrict__ sig,
                        const float* __restrict__ tnh, const int8_t* __restrict__ w1q,
                        const float* __restrict__ s1, const float* __restrict__ b1,
                        const int8_t* __restrict__ w2q, const float* __restrict__ s2,
                        const float* __restrict__ b2, float* __restrict__ out, int T, int D,
                        int H_rt, int Dh, int K, int bb, int n_seg) {
  const wc::GruQArgs args{wxq, whq, sx, sh, b, sig, tnh, w1q, s1, b1, w2q, s2, b2, n_seg};
  wc::gru_windows<N, false, false>(xs, h0, args, out, T, D, H_rt, Dh, K, bb, 0, -1);
}

// The dynamic shared memory a launch requests, in bytes: GruQLayout's carve
// (exported as mr_step_int8_smem_bytes).
static size_t mr_step_int8_smem(int D, int H, int Dh, int K, int bb, int n_seg) {
  return wc::GruQLayout(D, H, Dh, K, bb, pwl_floats(n_seg)).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N>
static cudaError_t launch_mr_step_int8(const float* xs, const float* h0, const int8_t* wxq,
                                       const int8_t* whq, const float* sx, const float* sh,
                                       const float* b, const float* sig, const float* tnh,
                                       const int8_t* w1q, const float* s1, const float* b1,
                                       const int8_t* w2q, const float* s2, const float* b2,
                                       float* out, int B, int T, int D, int H, int Dh, int K,
                                       int bb, int n_seg, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = mr_step_int8_smem(D, H, Dh, K, bb, n_seg);
  auto kernel = &mr_step_int8_kernel<N>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<B / bb, 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, wxq, whq, sx, sh, b, sig, tnh, w1q, s1, b1, w2q, s2, b2, out, T, D, H, Dh, K, bb,
      n_seg);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" long long mr_step_int8_smem_bytes(int D, int H, int Dh, int K, int bb, int n_seg) {
  return (long long)repro::mr_step_int8_smem(D, H, Dh, K, bb, n_seg);
}

extern "C" int mr_step_int8_launch(const float* xs, const float* h0, const int8_t* wxq,
                                   const int8_t* whq, const float* sx, const float* sh,
                                   const float* b, const float* sig, const float* tnh,
                                   const int8_t* w1q, const float* s1, const float* b1,
                                   const int8_t* w2q, const float* s2, const float* b2, float* out,
                                   int B, int T, int D, int H, int Dh, int K, int bb, int n_seg,
                                   void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_seg < 1 || H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
#define REPRO_MR_STEP_INT8(N)                                                                      \
  repro::launch_mr_step_int8<N>(xs, h0, wxq, whq, sx, sh, b, sig, tnh, w1q, s1, b1, w2q, s2, b2,  \
                                out, B, T, D, H, Dh, K, bb, n_seg, (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_MR_STEP_INT8(8);
    case 32: return (int)REPRO_MR_STEP_INT8(32);
    case 64: return (int)REPRO_MR_STEP_INT8(64);
    default: return (int)REPRO_MR_STEP_INT8(0);
  }
#undef REPRO_MR_STEP_INT8
}
