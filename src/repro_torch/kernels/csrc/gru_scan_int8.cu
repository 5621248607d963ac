// Int8/PWL standard-GRU sequence scan: xs [B, T, D] -> hs [B, T, H].
//
// Replaces repro/kernels/gru_scan/kernel.py:246 gru_scan_pallas_int8 (body
// _gru_scan_q_kernel, :204; step :174 _gru_q_step_math). gru_scan's
// warp-per-window recurrence on the warp cell's int8/PWL policy
// (warp_cell.cuh gru_windows, HS, with GruQArgs: Int8Cell): a block of `bb`
// windows stages the int8 gate weights, their per-column scales, the bias and
// the two PWL tables once by cp.async (GruQLayout with Dh = K = 0), then each
// warp runs its window's T steps with no block barrier. At H <= 32 a lane
// dequantizes its units' 96 recurrent weights once into registers; above, the
// block dequantizes the columns once at staging into a column-major float
// copy, so no multiply is left on the chain. x.Wx is computed a chunk of steps
// ahead; on the chain each gate is (x.Wx + h.Wh) + b, both adds rounded, then
// the PWL sigmoid or tanh with its IEEE division, and the update's two products
// are rounded apart, as the plain version rounds them. The standard cell only:
// dts is not read. h0 is the caller's (it may be non-zero).
//
// What bounds it on an H100: the chain of T dependent steps, as gru_scan; at
// the quickstart (B=64, T=32, D=2, H=32) the call is ~16 MFLOP and ~0.3 MB,
// under a microsecond of the card's float32 and memory rates. The hs write
// (B*T*H floats) is the only sizeable traffic: each step the lanes store their
// own units of h, one coalesced 128-byte row a unit, off the chain.
#include "warp_cell.cuh"

namespace repro {

template <int N>
// minBlocksPerSM = 1, as mr_step: the cell's registers decide the schedule
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    gru_scan_int8_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                         const int8_t* __restrict__ wxq, const int8_t* __restrict__ whq,
                         const float* __restrict__ sx, const float* __restrict__ sh,
                         const float* __restrict__ b, const float* __restrict__ sig,
                         const float* __restrict__ tnh, float* __restrict__ hs, int T, int D,
                         int H_rt, int bb, int n_seg) {
  const wc::GruQArgs args{wxq, whq, sx, sh, b, sig, tnh, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, n_seg};  // no head
  wc::gru_windows<N, false, true>(xs, h0, args, hs, T, D, H_rt, 0, 0, bb, 0, -1);
}

// The dynamic shared memory a launch requests, in bytes: GruQLayout with no head's carve
// (exported as gru_scan_int8_smem_bytes).
static size_t gru_scan_int8_smem(int D, int H, int bb, int n_seg) {
  return wc::GruQLayout(D, H, 0, 0, bb, pwl_floats(n_seg)).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N>
static cudaError_t launch_gru_scan_int8(const float* xs, const float* h0, const int8_t* wxq,
                                        const int8_t* whq, const float* sx, const float* sh,
                                        const float* b, const float* sig, const float* tnh,
                                        float* hs, int B, int T, int D, int H, int bb, int n_seg,
                                        cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = gru_scan_int8_smem(D, H, bb, n_seg);
  auto kernel = &gru_scan_int8_kernel<N>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<B / bb, 32 * wc::warps_for(bb), smem, stream>>>(xs, h0, wxq, whq, sx, sh, b, sig, tnh,
                                                           hs, T, D, H, bb, n_seg);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" long long gru_scan_int8_smem_bytes(int D, int H, int bb, int n_seg) {
  return (long long)repro::gru_scan_int8_smem(D, H, bb, n_seg);
}

extern "C" int gru_scan_int8_launch(const float* xs, const float* h0, const int8_t* wxq,
                                    const int8_t* whq, const float* sx, const float* sh,
                                    const float* b, const float* sig, const float* tnh, float* hs,
                                    int B, int T, int D, int H, int bb, int n_seg, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_seg < 1 || H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
#define REPRO_GRU_SCAN_INT8(N)                                                                    \
  repro::launch_gru_scan_int8<N>(xs, h0, wxq, whq, sx, sh, b, sig, tnh, hs, B, T, D, H, bb, n_seg, \
                                 (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_GRU_SCAN_INT8(8);
    case 32: return (int)REPRO_GRU_SCAN_INT8(32);
    case 64: return (int)REPRO_GRU_SCAN_INT8(64);
    default: return (int)REPRO_GRU_SCAN_INT8(0);
  }
#undef REPRO_GRU_SCAN_INT8
}
