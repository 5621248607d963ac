// Stage-fused MR per-window step: GRU(-flow) scan -> RMS-norm -> optional
// Qm.n activation step -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:129 mr_step_pallas (body
// _mr_step_kernel, :79-125; step gru_scan/kernel.py:42-63 _gru_step_math;
// head kernel.py:64-76 _head_math). A warp-per-window recurrence
// (warp_cell.cuh gru_windows, shared with gru_scan.cu): a block of `bb`
// windows stages the gate weights and the head weights once, then each warp
// runs its window's T steps and the head with no block barrier. Per step the chain is h.Wh_{r,z} (four partial sums
// an output, from registers at H <= 32), the two sigmoids, (r*h).Wh_c, the
// candidate's tanh and the (flow) update; x.Wx + b and the flow gate's
// phi(t) * alpha were computed before the chunk of steps. Per window the only
// device-memory traffic is x in and the head output out; hs [B, T, H] is
// never written.
//
// What bounds it on an H100: the chain of T dependent steps, each a few
// hundred FMAs a window; at the quickstart the whole call is ~15 MFLOP and
// ~53 KB, under a microsecond of the card's float32 and memory rates. The
// tiling (kernels/mr_step/tiling.py) keeps at least min(B, 132) blocks.
//
// The candidate gate is tanh(x.Wx_c + (r*h).Wh_c + b_c), as in the JAX
// package, not torch.nn.GRU's r*(h.Wh_c).
//
// One launch runs S stages (the batching rule jax.vmap gives mr_step_pallas: a
// leading slot axis of its grid), each on its own windows and weights, grid
// (B / bb, S); a single call is S = 1. Every operand has a slot stride, 0 for
// one shared by all slots (h0, dts); block (x, s) offsets the pointers by slot
// s (wc::slot_at) and runs the body above unchanged.
#include "warp_cell.cuh"

namespace repro {

template <int N, bool FLOW>
// minBlocksPerSM = 1: without it ptxas holds the H=64 instantiations to
// 64-128 registers and issues each shared load just ahead of its FMAs
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                   const float* __restrict__ wx, const float* __restrict__ wh,
                   const float* __restrict__ b, const float* __restrict__ time_scale,
                   const float* __restrict__ dts, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, wc::SlotStrides<12> st,
                   int T, int D, int H_rt, int Dh, int K, int bb, int act_int, int act_frac) {
  const wc::GruArgs args{wc::slot_at(wx, st.v[2]),  wc::slot_at(wh, st.v[3]),
                         wc::slot_at(b, st.v[4]),   wc::slot_at(time_scale, st.v[5]),
                         wc::slot_at(dts, st.v[6]), wc::slot_at(w1, st.v[7]),
                         wc::slot_at(b1, st.v[8]),  wc::slot_at(w2, st.v[9]),
                         wc::slot_at(b2, st.v[10])};
  wc::gru_windows<N, FLOW, false>(wc::slot_at(xs, st.v[0]), wc::slot_at(h0, st.v[1]), args,
                                  wc::slot_at(out, st.v[11]), T, D, H_rt, Dh, K, bb, act_int,
                                  act_frac);
}

// The dynamic shared memory a launch requests, in bytes: GruLayout's carve
// (exported as mr_step_smem_bytes).
static size_t mr_step_smem(int D, int H, int Dh, int K, int bb) {
  return wc::GruLayout(D, H, Dh, K, bb).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N, bool FLOW>
static cudaError_t launch_mr_step(const float* xs, const float* h0, const float* wx,
                                  const float* wh, const float* b, const float* time_scale,
                                  const float* dts, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out,
                                  const wc::SlotStrides<12>& st, int S, int B, int T, int D, int H,
                                  int Dh, int K, int bb, int act_int, int act_frac,
                                  cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = mr_step_smem(D, H, Dh, K, bb);
  auto kernel = &mr_step_kernel<N, FLOW>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B / bb, S), 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, st, T, D, H, Dh, K, bb, act_int,
      act_frac);
  return cudaGetLastError();
}

template <bool FLOW>
static cudaError_t launch_mr_step_width(const float* xs, const float* h0, const float* wx,
                                        const float* wh, const float* b,
                                        const float* time_scale, const float* dts,
                                        const float* w1, const float* b1, const float* w2,
                                        const float* b2, float* out,
                                        const wc::SlotStrides<12>& st, int S, int B, int T, int D,
                                        int H, int Dh, int K, int bb, int act_int, int act_frac,
                                        cudaStream_t stream) {
#define REPRO_MR_STEP(N)                                                                        \
  launch_mr_step<N, FLOW>(xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, st, S, B, T, \
                          D, H, Dh, K, bb, act_int, act_frac, stream)
  switch (H) {
    case 8: return REPRO_MR_STEP(8);
    case 32: return REPRO_MR_STEP(32);
    case 64: return REPRO_MR_STEP(64);
    default: return REPRO_MR_STEP(0);
  }
#undef REPRO_MR_STEP
}

}  // namespace repro

extern "C" long long mr_step_smem_bytes(int D, int H, int Dh, int K, int bb) {
  return (long long)repro::mr_step_smem(D, H, Dh, K, bb);
}

// Operand i of slot s at its pointer + s * its slot stride (elements; 0 =
// shared by every slot), out [S, B, K].
extern "C" int mr_step_launch(const float* xs, const float* h0, const float* wx, const float* wh,
                              const float* b, const float* time_scale, const float* dts,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              float* out, long long s_xs, long long s_h0, long long s_wx,
                              long long s_wh, long long s_b, long long s_time_scale,
                              long long s_dts, long long s_w1, long long s_b1, long long s_w2,
                              long long s_b2, int S, int B, int T, int D, int H, int Dh, int K,
                              int bb, int flow, int act_int, int act_frac, void* stream) {
  if (S < 1 || S > repro::wc::kMaxSlots || bb < 1 || B % bb != 0 || T < 1 || H < 1 ||
      H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
  const repro::wc::SlotStrides<12> st{{s_xs, s_h0, s_wx, s_wh, s_b, s_time_scale, s_dts, s_w1,
                                       s_b1, s_w2, s_b2, (long long)B * K}};
  auto launch = flow ? &repro::launch_mr_step_width<true> : &repro::launch_mr_step_width<false>;
  return (int)launch(xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, st, S, B, T, D, H,
                     Dh, K, bb, act_int, act_frac, (cudaStream_t)stream);
}
