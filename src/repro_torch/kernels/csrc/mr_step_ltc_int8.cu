// Stage-fused fixed-point LTC step: K semi-implicit substeps per input step
// with int8 w_in and w_rec and the PWL sigmoid -> RMS-norm -> int8 ReLU MLP
// head. The serving readout of precision="int8_pwl" on the ltc row.
//
// Replaces repro/kernels/mr_step/kernel.py:695 mr_step_ltc_pallas_int8 (body
// _mr_step_ltc_q_kernel, :635-680; step _ltc_q_step_math, :614-632). Per
// input step t and window:
//
//   drive = x_t . W_in + bias                      (once per input step)
//   K times: f = pwl_sigmoid(drive + h . W_rec)
//            h = (h + sub_dt * f * a) / (1 + sub_dt * (inv_tau + f))
//
// with W = float(q) * scale[column], sub_dt = dt / K in float32 (the
// wrapper hands in core/ltc.py ltc_sub_dt), then the int8 head on h_T.
//
// mr_step_ltc's warp-per-window recurrence (warp_cell.cuh ltc_windows) on
// the int8/PWL substep (Int8Ltc) and head (Int8Head): a block of `bb`
// windows stages the int8 w_rec and w_in, their scales, bias, a, inv_tau, the
// PWL table and the int8 head once by cp.async (LtcQLayout); each warp runs
// its window's T * K substeps and the head with no block barrier, so a tile
// takes any number of windows of any H. At H <= 32 a lane dequantizes its
// units' W_rec columns once into registers; above, the block dequantizes them
// once at staging into a column-major float copy, read as mr_step_ltc reads
// its own. The drive is computed a chunk of steps ahead; the substep's
// arithmetic is rounded op by op (__fmul_rn, __fadd_rn, __fdiv_rn) in the
// plain version's order.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each an H x H matvec per window, the PWL evaluation and
// the IEEE division; at the quickstart readout ~75 MFLOP, about a
// microsecond of the card's float32 rate. The time is the latency of that
// chain.
#include "warp_cell.cuh"

namespace repro {

template <int N>
// minBlocksPerSM = 1, as mr_step_ltc: the cell's registers decide the schedule
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_ltc_int8_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                            const int8_t* __restrict__ w_inq, const float* __restrict__ s_in,
                            const int8_t* __restrict__ w_recq, const float* __restrict__ s_rec,
                            const float* __restrict__ bias, const float* __restrict__ a,
                            const float* __restrict__ inv_tau, const float* __restrict__ sig,
                            const int8_t* __restrict__ w1q, const float* __restrict__ s1,
                            const float* __restrict__ b1, const int8_t* __restrict__ w2q,
                            const float* __restrict__ s2, const float* __restrict__ b2,
                            float* __restrict__ out, int T, int D, int H_rt, int Dh, int K, int bb,
                            int n_substeps, int n_seg, float sub_dt) {
  const wc::LtcQArgs args{w_inq, s_in, w_recq, s_rec, bias, a, inv_tau, sig,
                          w1q,   s1,   b1,     w2q,   s2,   b2, n_seg};
  wc::ltc_windows<N, 1>(xs, h0, args, out, T, D, H_rt, Dh, K, bb, n_substeps, sub_dt, 0, -1);
}

// The dynamic shared memory a launch requests, in bytes: LtcQLayout's carve
// (exported as mr_step_ltc_int8_smem_bytes).
static size_t ltc_int8_smem(int D, int H, int Dh, int K, int bb, int n_seg) {
  return wc::LtcQLayout(D, H, Dh, K, bb, pwl_floats(n_seg)).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N>
static cudaError_t launch_ltc_int8(const float* xs, const float* h0, const int8_t* w_inq,
                                   const float* s_in, const int8_t* w_recq, const float* s_rec,
                                   const float* bias, const float* a, const float* inv_tau,
                                   const float* sig, const int8_t* w1q, const float* s1,
                                   const float* b1, const int8_t* w2q, const float* s2,
                                   const float* b2, float* out, int B, int T, int D, int H, int Dh,
                                   int K, int bb, int n_substeps, int n_seg, float sub_dt,
                                   cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = ltc_int8_smem(D, H, Dh, K, bb, n_seg);
  auto kernel = &mr_step_ltc_int8_kernel<N>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<B / bb, 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, w_inq, s_in, w_recq, s_rec, bias, a, inv_tau, sig, w1q, s1, b1, w2q, s2, b2, out, T,
      D, H, Dh, K, bb, n_substeps, n_seg, sub_dt);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" long long mr_step_ltc_int8_smem_bytes(int D, int H, int Dh, int K, int bb, int n_seg) {
  return (long long)repro::ltc_int8_smem(D, H, Dh, K, bb, n_seg);
}

extern "C" int mr_step_ltc_int8_launch(
    const float* xs, const float* h0, const int8_t* w_inq, const float* s_in,
    const int8_t* w_recq, const float* s_rec, const float* bias, const float* a,
    const float* inv_tau, const float* sig, const int8_t* w1q, const float* s1, const float* b1,
    const int8_t* w2q, const float* s2, const float* b2, float* out, int B, int T, int D, int H,
    int Dh, int K, int bb, int n_substeps, int n_seg, float sub_dt, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1 || n_seg < 1 || H < 1 ||
      H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
#define REPRO_LTC_INT8(N)                                                                         \
  repro::launch_ltc_int8<N>(xs, h0, w_inq, s_in, w_recq, s_rec, bias, a, inv_tau, sig, w1q, s1,  \
                            b1, w2q, s2, b2, out, B, T, D, H, Dh, K, bb, n_substeps, n_seg,      \
                            sub_dt, (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_LTC_INT8(8);
    case 32: return (int)REPRO_LTC_INT8(32);
    case 64: return (int)REPRO_LTC_INT8(64);
    default: return (int)REPRO_LTC_INT8(0);
  }
#undef REPRO_LTC_INT8
}
