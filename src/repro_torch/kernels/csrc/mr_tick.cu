// Banked service tick: the serving segment of one streaming-recovery tick,
// for every slot, in one launch.
//
// Replaces repro/kernels/mr_step/tick.py:148 mr_tick_pallas (body
// _mr_tick_kernel, :86-142). Per slot it
//   1. rolls the ring buffers (drop the oldest C rows, append the tick's
//      chunk) and writes them out: y, and u when m > 0;
//   2. normalizes y with the mean and scale frozen at admission;
//   3. cuts the N windows of length T at stride `stride`;
//   4. runs the GRU(-flow) scan over all N windows, the flow gate at dt = 1
//      (tick.py:131);
//   5. runs the dense head with no activation step;
//   6. takes the mean over windows of the first Kc outputs;
//   7. blends it into the previous readout (EMA), or seeds it on a slot's
//      first tick;
//   8. writes delta = max|theta - theta0| / (max|theta| + 1e-3), inf for an
//      inactive slot.
//
// Design: a slot's N windows are independent GRU scans, so each runs in a
// warp of its own with mr_step's step and head (warp_cell.cuh gru_steps,
// warp_head; FLOW at dt = 1 makes phi * alpha one constant a unit). A slot's
// windows are spread over a thread-block cluster of ceil(N / kWarps) blocks
// (3 at the serve shape, at most the portable 8; past that the cluster's
// warps take the windows in turn), tick_warps(N) warps a block. Every block
// stages the slot's weights; each warp builds its own window's normalized x
// from the pre-roll buffer and the chunk (tick.cuh tick_x) and writes its
// window's [Ko] head outputs into the cluster leader's [N, Ko] tile through
// distributed shared memory. After a cluster barrier the leader's warp 0
// reduces the mean, the EMA and the delta over the windows in their order
// (tick.cuh tick_readout); the leader alone writes the rolled buffers. A
// cluster takes its bank of `bank` slots in turn, so a window's result and
// the slot's readout do not depend on the bank or the cluster size.
//
// What bounds it on an H100: as in mr_step, the chain of T dependent GRU
// steps of a window. At the serve shape (S=4, N=17, T=32, D=4, H=32, Dh=64,
// Ko=45) the whole call is ~17 MFLOP and ~0.16 MB, a fraction of a
// microsecond of the card's float32 rate and its memory rate alike; the time
// is the latency of the chain, now on 12 SMs at once instead of 4.
#include <cooperative_groups.h>

#include "tick.cuh"
#include "warp_cell.cuh"

namespace repro {

namespace cg = cooperative_groups;

template <int N, bool FLOW>
// minBlocksPerSM = 1, as mr_step: the cell's registers decide the schedule
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_tick_kernel(const float* __restrict__ buf_y, const float* __restrict__ new_y,
                   const float* __restrict__ mean, const float* __restrict__ scale,
                   const float* __restrict__ theta0, const float* __restrict__ seed,
                   const float* __restrict__ active, const float* __restrict__ wx,
                   const float* __restrict__ wh, const float* __restrict__ b,
                   const float* __restrict__ time_scale, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ h0,
                   const float* __restrict__ buf_u, const float* __restrict__ new_u,
                   float* __restrict__ buf_y_out, float* __restrict__ theta_out,
                   float* __restrict__ delta_out, float* __restrict__ buf_u_out, int L, int n,
                   int m, int C, int T, int stride, int Nw, int H_rt, int Dh, int Ko, int Kc,
                   int bank, float ema, float one_minus_ema) {
  constexpr int U = N > 0 ? (N + 31) / 32 : wc::kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // the recurrent columns fit in registers
  constexpr int kC = wc::kChunk;
  const int D = n + m, H = wc::width<N>(H_rt), H3 = 3 * H, S = wc::col_stride(H);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wc::TickLayout lay(D, H, Dh, Ko, T, Nw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  float* area = smem + lay.warps + warp * lay.per_warp;
  float* row_h = area + lay.row_h;
  float* row_r = area + lay.row_r;
  float* xw = area + lay.x;
  float* gxs = area + lay.gx;
  float* out_tile = cluster.map_shared_rank(smem + lay.out, 0);  // the leader's [N, Ko]
  const wc::Units<U> un(H);
  const float4* wh4 = reinterpret_cast<const float4*>(smem + lay.wh);

  for (int k = 0; k < bank; ++k) {
    const int s = blockIdx.x / cs * bank + k;
    // the previous slot: every warp is done with the weights, and the
    // leader's readout with its tile
    if (k > 0) cluster.sync();

    // staging: the slot's weights by every thread; the leader rolls the buffers
    if constexpr (REG)  // read once into registers: row-major, 16-byte copies
      wc::copy_async(smem + lay.wh, wh + (size_t)s * H * H3, H * H3, threadIdx.x, blockDim.x);
    else  // read every step: column-major, a float4 of a column per load
      wc::copy_columns_async(smem + lay.wh, wh + (size_t)s * H * H3, H, H3, S, threadIdx.x,
                             blockDim.x);
    wc::copy_async(smem + lay.wx, wx + (size_t)s * D * H3, D * H3, threadIdx.x, blockDim.x);
    wc::copy_async(smem + lay.b, b + (size_t)s * H3, H3, threadIdx.x, blockDim.x);
    wc::copy_async(smem + lay.ts, time_scale + (size_t)s * H, H, threadIdx.x, blockDim.x);
    wc::copy_async(smem + lay.head.w1, w1 + (size_t)s * H * Dh, H * Dh, threadIdx.x, blockDim.x);
    wc::copy_async(smem + lay.head.b1, b1 + (size_t)s * Dh, Dh, threadIdx.x, blockDim.x);
    wc::copy_async(smem + lay.head.w2, w2 + (size_t)s * Dh * Ko, Dh * Ko, threadIdx.x,
                   blockDim.x);
    wc::copy_async(smem + lay.head.b2, b2 + (size_t)s * Ko, Ko, threadIdx.x, blockDim.x);
    cp_async_commit();
    if (rank == 0)
      tick_roll(buf_y, new_y, buf_u, new_u, buf_y_out, buf_u_out, s, L, n, m, C, threadIdx.x,
                blockDim.x);
    cp_async_wait<0>();
    __syncthreads();

    // the lane's constants: biases, the flow gate's phi * alpha at dt = 1,
    // and at H <= 32 its recurrent columns
    wc::F32Cell<U> cell;
    cell.wx = smem + lay.wx;
    cell.H = H;
    float pa_u[U];
    float4 wr[REG ? 3 : 1][U][REG ? N / 4 : 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < 3; ++g) cell.bias[g][u] = smem[lay.b + g * H + un.col[u]];
      pa_u[u] = tanhf(softplus(smem[lay.ts + un.col[u]])) * kInvLipschitzAlpha;
      if constexpr (REG) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int q = 0; q < N / 4; ++q) {
            const float* w = smem + lay.wh + un.col[u] + g * H + 4 * q * H3;  // row-major
            wr[g][u][q] = make_float4(w[0], w[H3], w[2 * H3], w[3 * H3]);
          }
      }
    }
    auto w_rz = [&](int q, int g, int u) {
      if constexpr (REG) return wr[g][u][q];
      else return wh4[(g * H + un.col[u]) * (S / 4) + q];
    };
    auto w_c = [&](int q, int, int u) {
      if constexpr (REG) return wr[2][u][q];
      else return wh4[(2 * H + un.col[u]) * (S / 4) + q];
    };
    auto pa = [&](int, int u) { return pa_u[u]; };
    const wc::F32Head hd{smem + lay.head.w1, smem + lay.head.b1, smem + lay.head.w2,
                         smem + lay.head.b2, Dh, Ko};

    for (int w = rank * n_warps + warp; w < Nw; w += cs * n_warps) {
      float h[U];
      wc::load_h0(un, h, h0 + (size_t)w * H);
      __syncwarp();  // the previous window's head has read the warp's rows
      for (int i = lane; i < T * D; i += 32) {
        const int t = i / D, d = i - t * D;
        xw[i] = tick_x(buf_y, new_y, buf_u, new_u, mean, scale, s, w, t, d, L, n, m, C, stride);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (un.own[u]) row_h[un.col[u]] = h[u];
      __syncwarp();  // the window's x and h are published
      for (int t0 = 0; t0 < T; t0 += kC) {
        // x of steps past T lies in the chunk's padding: their slots are never read
        wc::gru_terms_ahead<U>(un, cell, xw + t0 * D, D, gxs, [](int, int) {});
        wc::gru_steps<N, FLOW, U>(un, cell, h, H, min(kC, T - t0), w_rz, w_c, gxs, pa, row_h,
                                  row_r, [](int, int, float) {});
      }
      wc::warp_head<N, U>(un, h, H, hd, row_h, row_r, out_tile + (size_t)w * Ko, 0, -1);
    }
    cluster.sync();  // every window's outputs are in the leader's tile

    // 6-8. mean over windows, EMA, delta: the leader's warp 0
    if (rank == 0 && threadIdx.x < 32)
      tick_readout(smem + lay.out, theta0, seed, active, theta_out, delta_out, s, Nw, Ko, Kc, ema,
                   one_minus_ema);
  }
}

// The dynamic shared memory a launch requests, in bytes: TickLayout's carve, one
// block of a slot's cluster (exported as mr_tick_smem_bytes).
static size_t tick_smem(int D, int H, int Dh, int Ko, int T, int N) {
  return wc::TickLayout(D, H, Dh, Ko, T, N).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own records
template <int N, bool FLOW>
static cudaError_t launch_tick(const float* buf_y, const float* new_y, const float* mean,
                               const float* scale, const float* theta0, const float* seed,
                               const float* active, const float* wx, const float* wh,
                               const float* b, const float* time_scale, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               const float* h0, const float* buf_u, const float* new_u,
                               float* buf_y_out, float* theta_out, float* delta_out,
                               float* buf_u_out, int S, int L, int n, int m, int C, int T,
                               int stride, int H, int Dh, int Ko, int Kc, int bank, float ema,
                               float one_minus_ema, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  static ClusterFit fit;
  const int Nw = (L - T) / stride + 1;
  const unsigned cs = wc::tick_cluster(Nw);
  const size_t smem = tick_smem(n + m, H, Dh, Ko, T, Nw);
  auto kernel = &mr_tick_kernel<N, FLOW>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, cs, (unsigned)(S / bank), 32 * wc::tick_warps(Nw), smem, stream,
                         fit, buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b,
                         time_scale, w1, b1, w2, b2, h0, buf_u, new_u, buf_y_out, theta_out,
                         delta_out, buf_u_out, L, n, m, C, T, stride, Nw, H, Dh, Ko, Kc, bank, ema,
                         one_minus_ema);
}

template <bool FLOW>
static cudaError_t launch_tick_width(const float* buf_y, const float* new_y, const float* mean,
                                     const float* scale, const float* theta0, const float* seed,
                                     const float* active, const float* wx, const float* wh,
                                     const float* b, const float* time_scale, const float* w1,
                                     const float* b1, const float* w2, const float* b2,
                                     const float* h0, const float* buf_u, const float* new_u,
                                     float* buf_y_out, float* theta_out, float* delta_out,
                                     float* buf_u_out, int S, int L, int n, int m, int C, int T,
                                     int stride, int H, int Dh, int Ko, int Kc, int bank,
                                     float ema, float one_minus_ema, cudaStream_t stream) {
#define REPRO_TICK(N)                                                                          \
  launch_tick<N, FLOW>(buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b, time_scale, \
                       w1, b1, w2, b2, h0, buf_u, new_u, buf_y_out, theta_out, delta_out,      \
                       buf_u_out, S, L, n, m, C, T, stride, H, Dh, Ko, Kc, bank, ema,          \
                       one_minus_ema, stream)
  switch (H) {
    case 8: return REPRO_TICK(8);
    case 32: return REPRO_TICK(32);
    case 64: return REPRO_TICK(64);
    default: return REPRO_TICK(0);
  }
#undef REPRO_TICK
}

}  // namespace repro

extern "C" long long mr_tick_smem_bytes(int D, int H, int Dh, int Ko, int T, int N) {
  return (long long)repro::tick_smem(D, H, Dh, Ko, T, N);
}

extern "C" int mr_tick_launch(
    const float* buf_y, const float* new_y, const float* mean, const float* scale,
    const float* theta0, const float* seed, const float* active, const float* wx, const float* wh,
    const float* b, const float* time_scale, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* h0, const float* buf_u, const float* new_u, float* buf_y_out,
    float* theta_out, float* delta_out, float* buf_u_out, int S, int L, int n, int m, int C,
    int T, int stride, int H, int Dh, int Ko, int Kc, int bank, int flow, float ema,
    float one_minus_ema, void* stream) {
  if (repro::tick_geometry_bad(S, L, n, m, C, T, stride, Ko, Kc, bank, buf_u, new_u, buf_u_out) ||
      H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
  auto launch = flow ? &repro::launch_tick_width<true> : &repro::launch_tick_width<false>;
  return (int)launch(buf_y, new_y, mean, scale, theta0, seed, active, wx, wh, b, time_scale, w1,
                     b1, w2, b2, h0, buf_u, new_u, buf_y_out, theta_out, delta_out, buf_u_out, S,
                     L, n, m, C, T, stride, H, Dh, Ko, Kc, bank, ema, one_minus_ema,
                     (cudaStream_t)stream);
}
