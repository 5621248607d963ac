// GRU(-flow) sequence scan: xs [B, T, D] -> hs [B, T, H].
//
// Replaces repro/kernels/gru_scan/kernel.py:107 gru_scan_pallas (body
// _gru_scan_kernel, :66-103; step :42-63 _gru_step_math). A warp-per-window
// recurrence, mr_step's body without the head (warp_cell.cuh gru_windows,
// HS): a block of `bb` windows stages the gate weights once (GruLayout with
// Dh = K = 0), then each warp runs its window's T steps with no block
// barrier. Per step the chain is h.Wh_{r,z} (four partial sums an output,
// from registers at H <= 32), the two sigmoids, (r*h).Wh_c, the candidate's
// tanh and the (flow) update; x.Wx + b and the flow gate's phi(t) * alpha at
// the step's dt were computed before the chunk of steps, from an x and dts
// chunk that cp.async staged a chunk ahead. h0 is the caller's (it may be
// non-zero).
//
// What bounds it on an H100: the chain of T dependent steps, as in mr_step;
// at the quickstart (B=64, T=32, D=2, H=32) the call is ~14 MFLOP and
// ~0.3 MB, under a microsecond of the card's float32 and memory rates. The
// hs write (B*T*H floats, 256 KB there) is the only sizeable traffic: each
// step the lanes store their own units of h, one coalesced 128-byte row a
// unit, and the store does not hold up the chain.
//
// One launch runs S scans (the batching rule jax.vmap gives gru_scan_pallas),
// each on its own windows and weights, grid (B / bb, S), hs [S, B, T, H]; a
// single call is S = 1. Every operand has a slot stride, 0 for one shared by
// all slots (h0, dts); block (x, s) offsets the pointers by slot s
// (wc::slot_at) and runs the body above unchanged.
#include "warp_cell.cuh"

namespace repro {

template <int N, bool FLOW>
// minBlocksPerSM = 1, as mr_step: the cell's registers decide the schedule
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    gru_scan_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                    const float* __restrict__ wx, const float* __restrict__ wh,
                    const float* __restrict__ b, const float* __restrict__ time_scale,
                    const float* __restrict__ dts, float* __restrict__ hs, wc::SlotStrides<8> st,
                    int T, int D, int H_rt, int bb) {
  const wc::GruArgs args{wc::slot_at(wx, st.v[2]),
                         wc::slot_at(wh, st.v[3]),
                         wc::slot_at(b, st.v[4]),
                         wc::slot_at(time_scale, st.v[5]),
                         wc::slot_at(dts, st.v[6]),
                         nullptr,
                         nullptr,
                         nullptr,
                         nullptr};
  wc::gru_windows<N, FLOW, true>(wc::slot_at(xs, st.v[0]), wc::slot_at(h0, st.v[1]), args,
                                 wc::slot_at(hs, st.v[7]), T, D, H_rt, 0, 0, bb, 0, -1);
}

// The dynamic shared memory a launch requests, in bytes: GruLayout with no head's carve
// (exported as gru_scan_smem_bytes).
static size_t gru_scan_smem(int D, int H, int bb) {
  return wc::GruLayout(D, H, 0, 0, bb).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N, bool FLOW>
static cudaError_t launch_gru_scan(const float* xs, const float* h0, const float* wx,
                                   const float* wh, const float* b, const float* time_scale,
                                   const float* dts, float* hs, const wc::SlotStrides<8>& st,
                                   int S, int B, int T, int D, int H, int bb,
                                   cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = gru_scan_smem(D, H, bb);
  auto kernel = &gru_scan_kernel<N, FLOW>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B / bb, S), 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, wx, wh, b, time_scale, dts, hs, st, T, D, H, bb);
  return cudaGetLastError();
}

template <bool FLOW>
static cudaError_t launch_gru_scan_width(const float* xs, const float* h0, const float* wx,
                                         const float* wh, const float* b,
                                         const float* time_scale, const float* dts, float* hs,
                                         const wc::SlotStrides<8>& st, int S, int B, int T, int D,
                                         int H, int bb, cudaStream_t stream) {
#define REPRO_GRU_SCAN(N)                                                                        \
  launch_gru_scan<N, FLOW>(xs, h0, wx, wh, b, time_scale, dts, hs, st, S, B, T, D, H, bb, stream)
  switch (H) {
    case 8: return REPRO_GRU_SCAN(8);
    case 32: return REPRO_GRU_SCAN(32);
    case 64: return REPRO_GRU_SCAN(64);
    default: return REPRO_GRU_SCAN(0);
  }
#undef REPRO_GRU_SCAN
}

}  // namespace repro

extern "C" long long gru_scan_smem_bytes(int D, int H, int bb) {
  return (long long)repro::gru_scan_smem(D, H, bb);
}

// Operand i of slot s at its pointer + s * its slot stride (elements; 0 =
// shared by every slot), hs [S, B, T, H].
extern "C" int gru_scan_launch(const float* xs, const float* h0, const float* wx,
                               const float* wh, const float* b, const float* time_scale,
                               const float* dts, float* hs, long long s_xs, long long s_h0,
                               long long s_wx, long long s_wh, long long s_b,
                               long long s_time_scale, long long s_dts, int S, int B, int T, int D,
                               int H, int bb, int flow, void* stream) {
  if (S < 1 || S > repro::wc::kMaxSlots || bb < 1 || B % bb != 0 || T < 1 || H < 1 ||
      H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
  const repro::wc::SlotStrides<8> st{
      {s_xs, s_h0, s_wx, s_wh, s_b, s_time_scale, s_dts, (long long)B * T * H}};
  auto launch = flow ? &repro::launch_gru_scan_width<true> : &repro::launch_gru_scan_width<false>;
  return (int)launch(xs, h0, wx, wh, b, time_scale, dts, hs, st, S, B, T, D, H, bb,
                     (cudaStream_t)stream);
}
