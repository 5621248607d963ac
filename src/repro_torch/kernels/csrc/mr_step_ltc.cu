// Stage-fused LTC recovery step: K semi-implicit solver substeps per input
// step -> RMS-norm -> optional Qm.n activation step -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:404 mr_step_ltc_pallas (body
// _mr_step_ltc_kernel, :354-398; step _ltc_step_math, :330-351). Per input
// step t and window:
//
//   drive = x_t . W_in + bias                      (once per input step)
//   K times: f = sigmoid(drive + h . W_rec)
//            h = (h + sub_dt * f * a) / (1 + sub_dt * (inv_tau + f))
//
// with sub_dt = dt / K in float32, handed in by the wrapper, and K a runtime
// int. Then the head on h_T. The substep loop takes a compile-time unroll
// factor UNROLL (wc::substeps; any K runs at each factor, and no factor changes
// a bit of the result); only UNROLL = 1 is instantiated, since 2 and 6 measured
// no faster on an H100.
//
// A warp-per-window recurrence (warp_cell.cuh ltc_windows, shared with
// mr_step_ltc_int8.cu, on the F32Ltc substep): a block of `bb` windows stages
// w_rec, w_in, bias, a, inv_tau and the head weights once; each warp runs its
// window's T * K substeps and the head with no block barrier. A substep's
// chain is h.W_rec (four partial sums an output, from registers at H <= 32),
// the add of the drive, the sigmoid, the numerator and denominator and their
// IEEE division; the drive x_t.W_in + bias was computed before the chunk of
// steps. The update forms (sub_dt * f) * a and sub_dt * (inv_tau + f) as the
// plain version does, each with its add fused into one FMA (what nvcc makes of
// a * b + c by default), and divides num / den exactly.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each an H x H matvec a window: ~31 MFLOP at B=64, T=32,
// H=32, K=6, about half a microsecond of the card's float32 rate. The only
// device-memory traffic is x in and the head output out.
//
// One launch runs S stages (the batching rule jax.vmap gives
// mr_step_ltc_pallas), each on its own windows and weights, grid (B / bb, S);
// a single call is S = 1. Every operand has a slot stride, 0 for one shared by
// all slots (h0); block (x, s) offsets the pointers by slot s (wc::slot_at)
// and runs the body above unchanged.
#include "warp_cell.cuh"

namespace repro {

template <int N, int UNROLL>
// minBlocksPerSM = 1: without it ptxas holds the H=64 instantiations to
// 64-128 registers and issues each shared load just ahead of its FMAs
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_ltc_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                       const float* __restrict__ w_in, const float* __restrict__ w_rec,
                       const float* __restrict__ bias, const float* __restrict__ a,
                       const float* __restrict__ inv_tau, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ out,
                       wc::SlotStrides<12> st, int T, int D, int H_rt, int Dh, int K, int bb,
                       int n_substeps, float sub_dt, int act_int, int act_frac) {
  const wc::LtcArgs args{wc::slot_at(w_in, st.v[2]),    wc::slot_at(w_rec, st.v[3]),
                         wc::slot_at(bias, st.v[4]),    wc::slot_at(a, st.v[5]),
                         wc::slot_at(inv_tau, st.v[6]), wc::slot_at(w1, st.v[7]),
                         wc::slot_at(b1, st.v[8]),      wc::slot_at(w2, st.v[9]),
                         wc::slot_at(b2, st.v[10])};
  wc::ltc_windows<N, UNROLL>(wc::slot_at(xs, st.v[0]), wc::slot_at(h0, st.v[1]), args,
                     wc::slot_at(out, st.v[11]), T, D, H_rt, Dh, K, bb, n_substeps, sub_dt,
                     act_int, act_frac);
}

// The dynamic shared memory a launch requests, in bytes: LtcLayout's carve
// (exported as mr_step_ltc_smem_bytes).
static size_t ltc_smem(int D, int H, int Dh, int K, int bb) {
  return wc::LtcLayout(D, H, Dh, K, bb).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N, int UNROLL>
static cudaError_t launch_ltc(const float* xs, const float* h0, const float* w_in,
                              const float* w_rec, const float* bias, const float* a,
                              const float* inv_tau, const float* w1, const float* b1,
                              const float* w2, const float* b2, float* out,
                              const wc::SlotStrides<12>& st, int S, int B, int T, int D, int H,
                              int Dh, int K, int bb, int n_substeps, float sub_dt, int act_int,
                              int act_frac, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = ltc_smem(D, H, Dh, K, bb);
  auto kernel = &mr_step_ltc_kernel<N, UNROLL>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B / bb, S), 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out, st, T, D, H, Dh, K, bb,
      n_substeps, sub_dt, act_int, act_frac);
  return cudaGetLastError();
}

// The launch at width N with the substep loop unrolled `unroll` times: one of
// the instantiated factors (kernels/mr_step/tiling.py SUBSTEP_UNROLLS), else
// cudaErrorInvalidValue. Another factor is one more case here.
template <int N, class... Args>
static cudaError_t launch_ltc_unrolled(int unroll, Args... args) {
  switch (unroll) {
    case 1: return launch_ltc<N, 1>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

extern "C" long long mr_step_ltc_smem_bytes(int D, int H, int Dh, int K, int bb) {
  return (long long)repro::ltc_smem(D, H, Dh, K, bb);
}

// Operand i of slot s at its pointer + s * its slot stride (elements; 0 =
// shared by every slot), out [S, B, K].
extern "C" int mr_step_ltc_launch(const float* xs, const float* h0, const float* w_in,
                                  const float* w_rec, const float* bias, const float* a,
                                  const float* inv_tau, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out, long long s_xs,
                                  long long s_h0, long long s_w_in, long long s_w_rec,
                                  long long s_bias, long long s_a, long long s_inv_tau,
                                  long long s_w1, long long s_b1, long long s_w2, long long s_b2,
                                  int S, int B, int T, int D, int H, int Dh, int K, int bb,
                                  int n_substeps, int unroll, int act_int, int act_frac,
                                  float sub_dt, void* stream) {
  if (S < 1 || S > repro::wc::kMaxSlots || bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1 ||
      H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
  const repro::wc::SlotStrides<12> st{{s_xs, s_h0, s_w_in, s_w_rec, s_bias, s_a, s_inv_tau, s_w1,
                                       s_b1, s_w2, s_b2, (long long)B * K}};
#define REPRO_LTC(N)                                                                         \
  repro::launch_ltc_unrolled<N>(unroll, xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, \
                                out, st, S, B, T, D, H, Dh, K, bb, n_substeps, sub_dt,         \
                                act_int, act_frac, (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_LTC(8);
    case 32: return (int)REPRO_LTC(32);
    case 64: return (int)REPRO_LTC(64);
    default: return (int)REPRO_LTC(0);
  }
#undef REPRO_LTC
}
