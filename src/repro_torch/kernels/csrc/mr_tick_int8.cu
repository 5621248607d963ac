// Int8/PWL banked service tick: the serving segment of one pure-serve
// (monitor) tick of precision="int8_pwl", for every slot, in one launch.
//
// Replaces repro/kernels/mr_step/tick.py:313 mr_tick_pallas_int8 (body
// _mr_tick_q_kernel, :249-310). It is mr_tick.cu with the standard GRU cell
// quantized: per slot it rolls the ring buffers and writes them out,
// normalizes y with the frozen mean and scale and cuts the N windows
// (tick.cuh), runs the int8/PWL GRU scan and the int8 head of every window,
// and reads the slot out: the mean over windows of the first Kc outputs, the
// EMA (or the first tick's seed) and delta = max|theta - theta0| /
// (max|theta| + 1e-3), inf for an inactive slot (tick.cuh tick_readout).
//
// Design: mr_tick.cu's, on the warp cell's int8 policy (warp_cell.cuh
// Int8Cell, Int8Head; the arithmetic of repro/kernels/gru_scan/kernel.py:174
// _gru_q_step_math). A slot's N windows are spread over a thread-block
// cluster of tick_cluster(N) blocks (3 at the serve shape; past 64 windows
// the cluster's warps take them in turn), tick_warps(N) warps a block, one
// warp a window. Every block stages the slot's int8 weights, their scales
// and biases and the two PWL tables; at H <= 32 each lane dequantizes its
// units' recurrent columns once into registers (no multiply is left on the
// chain), at larger H the columns stay int8 in shared memory, column-major,
// and are dequantized on use. Each warp builds its window's normalized x
// (tick_x), runs the scan and the head, and writes its [Ko] outputs into the
// cluster leader's [N, Ko] tile through distributed shared memory; after a
// cluster barrier the leader's warp 0 reads the slot out, and the leader
// alone writes the rolled buffers (copies, so they match the plain version
// bit for bit). A cluster takes its bank of `bank` slots in turn, so a
// window's result and the slot's readout do not depend on the bank or the
// cluster size.
//
// The weights are int8 per slot, with scales per slot and per output
// channel ([S, 3H], [S, Dh], [S, Ko]); the two PWL tables are shared by all
// slots.
//
// What bounds it on an H100: as mr_tick, the chain of T dependent GRU steps
// of a window, each with three PWL evaluations (a true division, a truncated
// index, two shared loads) in place of the accurate sigmoid and tanh. At the
// serve shape (S=4, N=17, T=32, D=4, H=32, Dh=64, Ko=45) ~18 MFLOP and
// ~65 KB, a fraction of a microsecond of the card's float32 rate and its
// memory rate alike; the time is the chain's latency, on 12 SMs at once.
#include <cooperative_groups.h>

#include "tick.cuh"
#include "warp_cell.cuh"

namespace repro {

namespace cg = cooperative_groups;

template <int N>
// minBlocksPerSM = 1, as mr_tick: the cell's registers decide the schedule
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_tick_int8_kernel(const float* __restrict__ buf_y, const float* __restrict__ new_y,
                        const float* __restrict__ mean, const float* __restrict__ scale,
                        const float* __restrict__ theta0, const float* __restrict__ seed,
                        const float* __restrict__ active, const int8_t* __restrict__ wxq,
                        const int8_t* __restrict__ whq, const float* __restrict__ sx,
                        const float* __restrict__ sh, const float* __restrict__ b,
                        const float* __restrict__ sig, const float* __restrict__ tnh,
                        const int8_t* __restrict__ w1q, const float* __restrict__ s1,
                        const float* __restrict__ b1, const int8_t* __restrict__ w2q,
                        const float* __restrict__ s2, const float* __restrict__ b2,
                        const float* __restrict__ h0, const float* __restrict__ buf_u,
                        const float* __restrict__ new_u, float* __restrict__ buf_y_out,
                        float* __restrict__ theta_out, float* __restrict__ delta_out,
                        float* __restrict__ buf_u_out, int L, int n, int m, int C, int T,
                        int stride, int Nw, int H_rt, int Dh, int Ko, int Kc, int bank, int n_seg,
                        float ema, float one_minus_ema) {
  constexpr int U = N > 0 ? (N + 31) / 32 : wc::kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // the recurrent columns fit in registers
  constexpr int kC = wc::kChunk;
  const int D = n + m, H = wc::width<N>(H_rt), H3 = 3 * H, S = wc::col_stride(H);
  const int P = pwl_floats(n_seg);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wc::TickQLayout lay(D, H, Dh, Ko, T, Nw, P);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  float* area = smem + lay.warps + warp * lay.per_warp;
  float* row_h = area + lay.row_h;
  float* row_r = area + lay.row_r;
  float* xw = area + lay.x;
  float* gxs = area + lay.gx;
  float* out_tile = cluster.map_shared_rank(smem + lay.out, 0);  // the leader's [N, Ko]
  int8_t* wxs = reinterpret_cast<int8_t*>(smem + lay.wx);
  int8_t* whs = reinterpret_cast<int8_t*>(smem + lay.wh);
  int8_t* w1s = reinterpret_cast<int8_t*>(smem + lay.head.w1);
  int8_t* w2s = reinterpret_cast<int8_t*>(smem + lay.head.w2);
  const wc::Units<U> un(H);
  // wh's column g * H + j, k = 4q .. 4q + 3: four int8 of the column-major copy
  const char4* wh4 = reinterpret_cast<const char4*>(whs);
  const wc::Int8Head hd{w1s, smem + lay.head.s1, smem + lay.head.b1,
                        w2s, smem + lay.head.s2, smem + lay.head.b2, Dh, Ko};

  for (int k = 0; k < bank; ++k) {
    const int s = blockIdx.x / cs * bank + k;
    // the previous slot: every warp is done with the weights, and the
    // leader's readout with its tile
    if (k > 0) cluster.sync();

    // staging: the slot's weights by every thread; the leader rolls the buffers
    const int t = threadIdx.x, nt = blockDim.x;
    if constexpr (REG)  // read once into registers: row-major, 16-byte copies
      wc::copy_bytes_async(whs, whq + (size_t)s * H * H3, H * H3, t, nt);
    else  // read every step: column-major, four k's of a column per load
      wc::copy_columns_q(whs, whq + (size_t)s * H * H3, H, H3, S, t, nt);
    wc::copy_bytes_async(wxs, wxq + (size_t)s * D * H3, D * H3, t, nt);
    wc::copy_async(smem + lay.sx, sx + (size_t)s * H3, H3, t, nt);
    wc::copy_async(smem + lay.sh, sh + (size_t)s * H3, H3, t, nt);
    wc::copy_async(smem + lay.b, b + (size_t)s * H3, H3, t, nt);
    wc::copy_async(smem + lay.sig, sig, P, t, nt);
    wc::copy_async(smem + lay.tnh, tnh, P, t, nt);
    wc::copy_bytes_async(w1s, w1q + (size_t)s * H * Dh, H * Dh, t, nt);
    wc::copy_async(smem + lay.head.s1, s1 + (size_t)s * Dh, Dh, t, nt);
    wc::copy_async(smem + lay.head.b1, b1 + (size_t)s * Dh, Dh, t, nt);
    wc::copy_bytes_async(w2s, w2q + (size_t)s * Dh * Ko, Dh * Ko, t, nt);
    wc::copy_async(smem + lay.head.s2, s2 + (size_t)s * Ko, Ko, t, nt);
    wc::copy_async(smem + lay.head.b2, b2 + (size_t)s * Ko, Ko, t, nt);
    cp_async_commit();
    if (rank == 0)
      tick_roll(buf_y, new_y, buf_u, new_u, buf_y_out, buf_u_out, s, L, n, m, C, t, nt);
    cp_async_wait<0>();
    __syncthreads();

    // the lane's constants: its units' scales and biases, and at H <= 32 its
    // recurrent columns dequantized once
    wc::Int8Cell<U> cell;
    cell.wx = wxs;
    cell.sig_tab = smem + lay.sig;
    cell.tanh_tab = smem + lay.tnh;
    cell.H = H;
    cell.n_seg = n_seg;
    float shr[3][U];
    float4 wr[REG ? 3 : 1][U][REG ? N / 4 : 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int j = g * H + un.col[u];
        cell.sx[g][u] = smem[lay.sx + j];
        cell.bias[g][u] = smem[lay.b + j];
        shr[g][u] = smem[lay.sh + j];
      }
      if constexpr (REG) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int q = 0; q < N / 4; ++q)  // row-major: k = 4q .. 4q + 3
            wr[g][u][q] = wc::dequant4(wc::rows4(whs + un.col[u] + g * H + 4 * q * H3, H3),
                                       shr[g][u]);
      }
    }
    auto col_at = [&](int q, int g, int u) {
      return wc::dequant4(wh4[(g * H + un.col[u]) * (S / 4) + q], shr[g][u]);
    };
    auto w_rz = [&](int q, int g, int u) {
      if constexpr (REG) return wr[g][u][q];
      else return col_at(q, g, u);
    };
    auto w_c = [&](int q, int, int u) {
      if constexpr (REG) return wr[2][u][q];
      else return col_at(q, 2, u);
    };
    auto pa = [](int, int) { return 0.0f; };  // the standard cell has no flow gate

    for (int w = rank * n_warps + warp; w < Nw; w += cs * n_warps) {
      float h[U];
      wc::load_h0(un, h, h0 + (size_t)w * H);
      __syncwarp();  // the previous window's head has read the warp's rows
      for (int i = lane; i < T * D; i += 32) {
        const int tt = i / D, d = i - tt * D;
        xw[i] = tick_x(buf_y, new_y, buf_u, new_u, mean, scale, s, w, tt, d, L, n, m, C, stride);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (un.own[u]) row_h[un.col[u]] = h[u];
      __syncwarp();  // the window's x and h are published
      for (int t0 = 0; t0 < T; t0 += kC) {
        // x of steps past T lies in the chunk's padding: their slots are never read
        wc::gru_terms_ahead<U>(un, cell, xw + t0 * D, D, gxs, [](int, int) {});
        wc::gru_steps<N, false, U>(un, cell, h, H, min(kC, T - t0), w_rz, w_c, gxs, pa, row_h,
                                   row_r, [](int, int, float) {});
      }
      wc::warp_head<N, U>(un, h, H, hd, row_h, row_r, out_tile + (size_t)w * Ko, 0, -1);
    }
    cluster.sync();  // every window's outputs are in the leader's tile

    // mean over windows, EMA, delta: the leader's warp 0
    if (rank == 0 && threadIdx.x < 32)
      tick_readout(smem + lay.out, theta0, seed, active, theta_out, delta_out, s, Nw, Ko, Kc, ema,
                   one_minus_ema);
  }
}

// The dynamic shared memory a launch requests, in bytes: TickQLayout's carve, one
// block of a slot's cluster (exported as mr_tick_int8_smem_bytes).
static size_t tick_int8_smem(int D, int H, int Dh, int Ko, int T, int N, int n_seg) {
  return wc::TickQLayout(D, H, Dh, Ko, T, N, pwl_floats(n_seg)).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own records
template <int N>
static cudaError_t launch_tick_int8(
    const float* buf_y, const float* new_y, const float* mean, const float* scale,
    const float* theta0, const float* seed, const float* active, const int8_t* wxq,
    const int8_t* whq, const float* sx, const float* sh, const float* b, const float* sig,
    const float* tnh, const int8_t* w1q, const float* s1, const float* b1, const int8_t* w2q,
    const float* s2, const float* b2, const float* h0, const float* buf_u, const float* new_u,
    float* buf_y_out, float* theta_out, float* delta_out, float* buf_u_out, int S, int L, int n,
    int m, int C, int T, int stride, int H, int Dh, int Ko, int Kc, int bank, int n_seg,
    float ema, float one_minus_ema, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  static ClusterFit fit;
  const int Nw = (L - T) / stride + 1;
  const unsigned cs = wc::tick_cluster(Nw);
  const size_t smem = tick_int8_smem(n + m, H, Dh, Ko, T, Nw, n_seg);
  auto kernel = &mr_tick_int8_kernel<N>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, cs, (unsigned)(S / bank), 32 * wc::tick_warps(Nw), smem, stream,
                         fit, buf_y, new_y, mean, scale, theta0, seed, active, wxq, whq, sx, sh,
                         b, sig, tnh, w1q, s1, b1, w2q, s2, b2, h0, buf_u, new_u, buf_y_out,
                         theta_out, delta_out, buf_u_out, L, n, m, C, T, stride, Nw, H, Dh, Ko,
                         Kc, bank, n_seg, ema, one_minus_ema);
}

}  // namespace repro

extern "C" long long mr_tick_int8_smem_bytes(int D, int H, int Dh, int Ko, int T, int N,
                                             int n_seg) {
  return (long long)repro::tick_int8_smem(D, H, Dh, Ko, T, N, n_seg);
}

extern "C" int mr_tick_int8_launch(
    const float* buf_y, const float* new_y, const float* mean, const float* scale,
    const float* theta0, const float* seed, const float* active, const int8_t* wxq,
    const int8_t* whq, const float* sx, const float* sh, const float* b, const float* sig,
    const float* tnh, const int8_t* w1q, const float* s1, const float* b1, const int8_t* w2q,
    const float* s2, const float* b2, const float* h0, const float* buf_u, const float* new_u,
    float* buf_y_out, float* theta_out, float* delta_out, float* buf_u_out, int S, int L, int n,
    int m, int C, int T, int stride, int H, int Dh, int Ko, int Kc, int bank, int n_seg,
    float ema, float one_minus_ema, void* stream) {
  if (n_seg < 1 ||
      repro::tick_geometry_bad(S, L, n, m, C, T, stride, Ko, Kc, bank, buf_u, new_u, buf_u_out) ||
      H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
#define REPRO_TICK_INT8(N)                                                                         \
  repro::launch_tick_int8<N>(buf_y, new_y, mean, scale, theta0, seed, active, wxq, whq, sx, sh, b, \
                             sig, tnh, w1q, s1, b1, w2q, s2, b2, h0, buf_u, new_u, buf_y_out,      \
                             theta_out, delta_out, buf_u_out, S, L, n, m, C, T, stride, H, Dh, Ko, \
                             Kc, bank, n_seg, ema, one_minus_ema, (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_TICK_INT8(8);
    case 32: return (int)REPRO_TICK_INT8(32);
    case 64: return (int)REPRO_TICK_INT8(64);
    default: return (int)REPRO_TICK_INT8(0);
  }
#undef REPRO_TICK_INT8
}
