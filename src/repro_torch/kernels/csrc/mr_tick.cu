// Banked service tick: the serving segment of one streaming-recovery tick,
// for every slot, in one launch.
//
// Replaces repro/kernels/mr_step/tick.py:148 mr_tick_pallas (body
// _mr_tick_kernel, :86-142). Per slot it
//   1. rolls the ring buffers (drop the oldest C rows, append the tick's
//      chunk) and writes them out: y, and u when m > 0;
//   2. normalizes y with the mean and scale frozen at admission;
//   3. cuts the N windows of length T at stride `stride`;
//   4. runs the GRU(-flow) scan over all N windows at once, the flow gate at
//      dt = 1 (tick.py:131);
//   5. runs the dense head with no activation step;
//   6. takes the mean over windows of the first Kc outputs;
//   7. blends it into the previous readout (EMA), or seeds it on a slot's
//      first tick;
//   8. writes delta = max|theta - theta0| / (max|theta| + 1e-3), inf for an
//      inactive slot.
//
// Design: one block per bank of `bank` slots, taking the bank's slots in
// turn. For each slot the block stages its weights (the gate weights and the
// head, per slot) in dynamic shared memory, builds the normalized window set
// [N, T, D] there straight from the pre-roll buffer and the chunk, and runs
// the same scan and head as mr_step (gru_step.cuh with the N windows as the
// tile, head.cuh into a shared [N, Ko] tile); warp 0 then reduces the mean,
// the EMA and the delta. The ingest and that readout are tick.cuh's, shared
// with mr_tick_int8.cu. Device memory sees the buffers, the chunk and the
// weights read once, and the rolled buffers, theta [Kc] and delta written
// once. The TPU kernel banked every slot into one grid step; here a bank of
// one slot per block spreads the slots over the SMs (tiling.py
// auto_slots_per_bank). Results do not depend on the bank size.
//
// What bounds it on an H100: as in mr_step, the chain of T dependent GRU
// steps (two block barriers each) on one SM per slot. At the serve shape
// (S=4, N=17, T=32, D=4, H=32, Dh=64, Ko=45) the whole call is ~16 MFLOP and
// ~0.1 MB, a fraction of a microsecond of the card's float32 rate and its
// memory rate alike; the time is the latency of the chain.
#include "gru_step.cuh"
#include "head.cuh"
#include "tick.cuh"

namespace repro {

inline size_t mr_tick_shared_floats(int N, int T, int D, int H, int Dh, int Ko) {
  return gru_shared_floats(D, H, N) + head_shared_floats(H, Dh, Ko, N) + (size_t)N * T * D + T +
         (size_t)N * Ko;
}

template <bool FLOW>
__global__ void mr_tick_kernel(
    const float* __restrict__ buf_y, const float* __restrict__ new_y,
    const float* __restrict__ mean, const float* __restrict__ scale,
    const float* __restrict__ theta0, const float* __restrict__ seed,
    const float* __restrict__ active, const float* __restrict__ wx, const float* __restrict__ wh,
    const float* __restrict__ b, const float* __restrict__ time_scale,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ h0, const float* __restrict__ buf_u,
    const float* __restrict__ new_u, float* __restrict__ buf_y_out,
    float* __restrict__ theta_out, float* __restrict__ delta_out, float* __restrict__ buf_u_out,
    int L, int n, int m, int C, int T, int stride, int N, int H, int Dh, int Ko, int Kc, int bank,
    float ema, float one_minus_ema) {
  extern __shared__ float smem[];
  const int D = n + m, H3 = 3 * H;
  float* xs = smem + gru_shared_floats(D, H, N) + head_shared_floats(H, Dh, Ko, N);  // [N, T, D]
  float* dts = xs + N * T * D;                                                       // [T]
  float* out = dts + T;                                                              // [N, Ko]

  for (int k = 0; k < bank; ++k) {
    const int s = blockIdx.x * bank + k;
    __syncthreads();  // the previous slot is done with shared memory

    // 1-3. the rolled buffers, written out, and the normalized window set
    tick_ingest(buf_y, new_y, buf_u, new_u, mean, scale, buf_y_out, buf_u_out, xs, s, L, n, m, C,
                T, stride, N);
    for (int t = threadIdx.x; t < T; t += blockDim.x) dts[t] = 1.0f;

    // 4-5. the scan over the N windows, then the head (gru_setup's barrier
    // publishes xs and dts; the scan's barriers publish the head weights)
    GruShared g;
    float* p = gru_setup(g, smem, wx + (size_t)s * D * H3, wh + (size_t)s * H * H3,
                         b + (size_t)s * H3, time_scale + (size_t)s * H, h0, D, H, N);
    HeadShared hd;
    head_setup(hd, p, w1 + (size_t)s * H * Dh, b1 + (size_t)s * Dh, w2 + (size_t)s * Dh * Ko,
               b2 + (size_t)s * Ko, H, Dh, Ko, N);
    gru_scan_tile<FLOW, false>(g, xs, dts, nullptr, T, D, H, N);
    head_tile(hd, g.h, g.rh, out, H, Dh, Ko, N, 0, -1);
    __syncthreads();

    // 6-8. mean over windows, EMA, delta: warp 0
    if (threadIdx.x < 32)
      tick_readout(out, theta0, seed, active, theta_out, delta_out, s, N, Ko, Kc, ema,
                   one_minus_ema);
  }
}

}  // namespace repro

extern "C" int mr_tick_launch(
    const float* buf_y, const float* new_y, const float* mean, const float* scale,
    const float* theta0, const float* seed, const float* active, const float* wx, const float* wh,
    const float* b, const float* time_scale, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* h0, const float* buf_u, const float* new_u, float* buf_y_out,
    float* theta_out, float* delta_out, float* buf_u_out, int S, int L, int n, int m, int C,
    int T, int stride, int H, int Dh, int Ko, int Kc, int bank, int flow, float ema,
    float one_minus_ema, void* stream) {
  if (repro::tick_geometry_bad(S, L, n, m, C, T, stride, Ko, Kc, bank, buf_u, new_u, buf_u_out))
    return (int)cudaErrorInvalidValue;
  const int N = (L - T) / stride + 1;
  const size_t smem = repro::mr_tick_shared_floats(N, T, n + m, H, Dh, Ko) * sizeof(float);
  auto kernel = flow ? &repro::mr_tick_kernel<true> : &repro::mr_tick_kernel<false>;
  cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<S / bank, repro::tile_threads(N, H), smem, (cudaStream_t)stream>>>(
      buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b, time_scale, w1, b1, w2, b2, h0,
      buf_u, new_u, buf_y_out, theta_out, delta_out, buf_u_out, L, n, m, C, T, stride, N, H, Dh,
      Ko, Kc, bank, ema, one_minus_ema);
  return (int)cudaGetLastError();
}
