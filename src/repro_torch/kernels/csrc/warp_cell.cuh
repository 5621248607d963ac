// Warp-per-window recurrences shared by the fused kernels mr_step.cu (GRU /
// GRU-flow), mr_step_ltc.cu (LTC, semi-implicit substeps), mr_step_node.cu
// (NODE, Euler substeps) and the banked service tick mr_tick.cu (the GRU
// step and head of mr_step over a slot's windows).
//
// What bounds them on an H100: a window's scan is a chain of T dependent
// steps (T * n_substeps for LTC and NODE) whose work is a few thousand FMAs
// each, far below a microsecond of the card's float32 rate and memory rate
// alike; the time is the chain's latency. The design shortens each link:
//
// - One warp owns one window for the whole scan. Lane l owns hidden units
//   j = l + 32u (u < ceil(H/32)), keeps their h in registers, and publishes
//   them in a per-warp row of shared memory, read back as float4 after
//   __syncwarp(). Only the warp synchronises inside the time loop; the block
//   has one barrier, after staging.
// - H is a template parameter (8, 32, 64; 0 is the generic instantiation
//   with runtime loops), so the matvec loops unroll, the float4 loads of the
//   broadcast row run ahead of the FMAs and each output sums in four
//   independent partial accumulators (k mod 4), combined as
//   (p0 + p1) + (p2 + p3). At H <= 32 the recurrent weight columns of a
//   lane's unit live in registers; at larger H they are read column-wise
//   from shared memory, lanes on consecutive addresses (no bank conflict).
// - What does not depend on h leaves the chain: before every chunk of
//   kChunk steps the warp computes its own units' x_t.W + b (GRU: all three
//   gates; LTC: the drive x_t.W_in + bias; NODE: the injection
//   x_t.W_in + b_in) and the flow gate's phi(t) * alpha into per-lane slots
//   of its shared area, from an x chunk that cp.async staged a chunk ahead
//   (the tick builds its windows' x itself). Each lane reads back only what
//   it wrote, so the slots need no synchronisation.
// - The head runs in the same warp: RMS-norm by a shuffle reduction, the
//   optional Qm.n step (head.cuh quantize_fixed), layer 1 with the Dh outputs
//   on the lanes, layer 2 with each of the K outputs reduced by shuffles.
//
// Precision: float32 throughout with the accurate expf, tanhf, log1pf and
// the IEEE division (no fast-math, no approximate intrinsics); the partial
// sums only reorder the products' sums (tests/test_torch_warp_cells.py
// emulates the order on the CPU against the JAX package).
//
// Shared memory: the block's weights (staged once, cp.async by every thread),
// then one area a warp (two broadcast rows, the x chunks, the precomputed
// slots). The layouts below are the carves; kernels/mr_step/tiling.py
// mr_step_smem_bytes, ltc_smem_bytes, node_smem_bytes and tick_smem_bytes
// count the same regions.
#pragma once

#include "common.cuh"
#include "gru_step.cuh"  // softplus, kInvLipschitzAlpha
#include "head.cuh"      // quantize_fixed, kRmsEps
#include "mma.cuh"       // smem_u32, cp_async16, cp_async_commit, cp_async_wait, aligned16

namespace repro {
namespace wc {

constexpr int kWarps = 8;      // warps a block at most: a larger tile takes its windows in turn
constexpr int kMaxUnits = 8;   // hidden units a lane at most: H <= 256
constexpr int kChunk = 16;     // steps whose h-independent terms a warp computes at once
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~size_t(3); }
__host__ __device__ inline int warps_for(int bb) { return bb < kWarps ? bb : kWarps; }
__host__ __device__ inline int units_for(int H) { return (H + 31) / 32; }
// Floats between two columns of a recurrent weight matrix stored column-major
// (column c's k-th weight at c * S + k): a multiple of 4 that is 4 mod 8, so a
// lane reads four k's of its column as one float4 and the 8 lanes of each
// quarter-warp hit distinct bank groups.
__host__ __device__ inline int col_stride(int H) { return (H + 7) / 8 * 8 + 4; }

// A bump allocator of float offsets; every region starts 16-byte aligned.
struct Carve {
  size_t n = 0;
  __host__ __device__ size_t take(size_t floats) {
    const size_t at = n;
    n += pad4(floats);
    return at;
  }
};

// The head's weights, at the end of the block's weights in both kernels.
struct HeadLayout {
  size_t w1, b1, w2, b2;
  __host__ __device__ void carve(Carve& c, int H, int Dh, int K) {
    w1 = c.take((size_t)H * Dh);
    b1 = c.take(Dh);
    w2 = c.take((size_t)Dh * K);
    b2 = c.take(K);
  }
};

// mr_step: wx [D, 3H], wh's 3H columns [3H, S], b [3H], time_scale [H], the head; a warp:
// rows h and r*h (or the head's hidden layer), two chunks of x [kChunk, D] and
// dts [kChunk], the gates' x.Wx + b [kChunk, 3, nu, 32] and phi*alpha
// [kChunk, nu, 32].
struct GruLayout {
  size_t wx, wh, b, ts, warps, row_h, row_r, xbuf[2], dbuf[2], gx, phi, per_warp, total;
  HeadLayout head;
  __host__ __device__ GruLayout(int D, int H, int Dh, int K, int bb) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    Carve c;
    wx = c.take((size_t)D * 3 * H);
    wh = c.take((size_t)3 * H * S);
    b = c.take(3 * H);
    ts = c.take(H);
    head.carve(c, H, Dh, K);
    warps = c.n;
    Carve w;
    row_h = w.take(R);
    row_r = w.take(R);
    xbuf[0] = w.take(kChunk * D);
    dbuf[0] = w.take(kChunk);
    xbuf[1] = w.take(kChunk * D);
    dbuf[1] = w.take(kChunk);
    gx = w.take(kChunk * 3 * 32 * nu);
    phi = w.take(kChunk * 32 * nu);
    per_warp = w.n;
    total = warps + warps_for(bb) * per_warp;
  }
};

// mr_step_node: w_f1's and w_f2's columns [H, S], w_in [D, H], b_f1, b_f2, b_in [H],
// the head; a warp: rows h and z (or the head's hidden layer), two chunks of
// x [kChunk, D], the injection x.W_in + b_in [kChunk, nu, 32].
struct NodeLayout {
  size_t wf1, wf2, win, bf1, bf2, bin, warps, row_h, row_z, xbuf[2], xb, per_warp, total;
  HeadLayout head;
  __host__ __device__ NodeLayout(int D, int H, int Dh, int K, int bb) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    Carve c;
    wf1 = c.take((size_t)H * S);
    wf2 = c.take((size_t)H * S);
    win = c.take((size_t)D * H);
    bf1 = c.take(H);
    bf2 = c.take(H);
    bin = c.take(H);
    head.carve(c, H, Dh, K);
    warps = c.n;
    Carve w;
    row_h = w.take(R);
    row_z = w.take(R);
    xbuf[0] = w.take(kChunk * D);
    xbuf[1] = w.take(kChunk * D);
    xb = w.take(kChunk * 32 * nu);
    per_warp = w.n;
    total = warps + warps_for(bb) * per_warp;
  }
};

// mr_step_ltc: w_rec's columns [H, S], w_in [D, H], bias, a, inv_tau [H], the
// head; a warp: rows h and the head's hidden layer, two chunks of x
// [kChunk, D], the drive x.W_in + bias [kChunk, nu, 32].
struct LtcLayout {
  size_t wrec, win, bias, a, itau, warps, row_h, row_r, xbuf[2], drv, per_warp, total;
  HeadLayout head;
  __host__ __device__ LtcLayout(int D, int H, int Dh, int K, int bb) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    Carve c;
    wrec = c.take((size_t)H * S);
    win = c.take((size_t)D * H);
    bias = c.take(H);
    a = c.take(H);
    itau = c.take(H);
    head.carve(c, H, Dh, K);
    warps = c.n;
    Carve w;
    row_h = w.take(R);
    row_r = w.take(R);
    xbuf[0] = w.take(kChunk * D);
    xbuf[1] = w.take(kChunk * D);
    drv = w.take(kChunk * 32 * nu);
    per_warp = w.n;
    total = warps + warps_for(bb) * per_warp;
  }
};

// The banked tick spreads one slot's N windows over a thread-block cluster of
// ceil(N / kWarps) blocks, at most kMaxCluster (the portable cluster size;
// past it the cluster's warps take the windows in turn), with the windows
// spread evenly over the blocks: tick_warps(N) warps a block.
constexpr int kMaxCluster = 8;
__host__ __device__ inline int tick_cluster(int N) {
  const int c = (N + kWarps - 1) / kWarps;
  return c < kMaxCluster ? c : kMaxCluster;
}
__host__ __device__ inline int tick_warps(int N) {
  const int cs = tick_cluster(N), w = (N + cs - 1) / cs;
  return w < kWarps ? w : kWarps;
}

// mr_tick, one block of a slot's cluster: wx [D, 3H], wh's 3H columns [3H, S],
// b [3H], time_scale [H], the head, the slot's head outputs [N, K] (read in
// the cluster's leader only); a warp: rows h and r*h (or the head's hidden
// layer), its window's normalized x [Tc, D] (T rounded up to whole chunks) and
// the gates' x.Wx + b [kChunk, 3, nu, 32].
struct TickLayout {
  size_t wx, wh, b, ts, out, warps, row_h, row_r, x, gx, per_warp, total;
  HeadLayout head;
  __host__ __device__ TickLayout(int D, int H, int Dh, int K, int T, int N) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    const int Tc = (T + kChunk - 1) / kChunk * kChunk;
    Carve c;
    wx = c.take((size_t)D * 3 * H);
    wh = c.take((size_t)3 * H * S);
    b = c.take(3 * H);
    ts = c.take(H);
    head.carve(c, H, Dh, K);
    out = c.take((size_t)N * K);
    warps = c.n;
    Carve w;
    row_h = w.take(R);
    row_r = w.take(R);
    x = w.take((size_t)Tc * D);
    gx = w.take(kChunk * 3 * 32 * nu);
    per_warp = w.n;
    total = warps + tick_warps(N) * per_warp;
  }
};

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// n floats from device memory into shared memory by threads t, t + nt, ...:
// 16-byte cp.async where both ends are 16-byte aligned, 4-byte ones else.
// The caller commits and waits.
__device__ inline void copy_async(float* dst, const float* __restrict__ src, int n, int t, int nt) {
  int done = 0;
  if (aligned16(src) && aligned16(dst)) {
    const int n4 = n / 4;
    for (int i = t; i < n4; i += nt) cp_async16(dst + 4 * i, src + 4 * i, true);
    done = 4 * n4;
  }
  for (int i = done + t; i < n; i += nt) cp_async4(dst + i, src + i);
}

// The [rows, cols] row-major matrix src into shared memory column-major with
// column stride S (dst[c * S + k] = src[k * cols + c]), by threads t, t + nt,
// ...: 4-byte cp.async, consecutive threads on consecutive columns (coalesced
// device reads). The caller commits and waits.
__device__ inline void copy_columns_async(float* dst, const float* __restrict__ src, int rows,
                                          int cols, int S, int t, int nt) {
  for (int k = 0; k < rows; ++k)
    for (int c = t; c < cols; c += nt)
      cp_async4(dst + (size_t)c * S + k, src + (size_t)k * cols + c);
}

// ---------------------------------------------------------------------------
// warp arithmetic
// ---------------------------------------------------------------------------
template <int N>
__device__ __forceinline__ int width(int n) {
  return N > 0 ? N : n;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// out[g][u] = sum_{k < n} v[k] * W_g(k, u) for the G columns of each of the
// lane's first nu units (U of them at most); wq(q, g, u) gives the weights of
// k = 4q .. 4q + 3 as a float4. v is a 16-byte aligned row of shared memory
// that every lane reads whole; four partial sums an output (k mod 4).
template <int N, int G, int U, class Wq>
__device__ __forceinline__ void matvec(const float* v, int n_rt, int nu, const Wq& wq,
                                       float (&out)[G][U]) {
  float p[G][U][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[g][u][i] = 0.0f;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int n = width<N>(n_rt), full = n >> 2;
#pragma unroll
  for (int q = 0; q < full; ++q) {
    const float4 x = v4[q];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nu) continue;
        const float4 w = wq(q, g, u);
        p[g][u][0] = fmaf(x.x, w.x, p[g][u][0]);
        p[g][u][1] = fmaf(x.y, w.y, p[g][u][1]);
        p[g][u][2] = fmaf(x.z, w.z, p[g][u][2]);
        p[g][u][3] = fmaf(x.w, w.w, p[g][u][3]);
      }
  }
  if (N == 0 || N % 4 != 0) {  // a width that is not a multiple of 4: its tail
    const int rem = n - 4 * full;
    if (rem > 0) {  // the row and the columns are padded to whole float4s
      const float4 x = v4[full];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u >= nu) continue;
          const float4 w = wq(full, g, u);
          p[g][u][0] = fmaf(x.x, w.x, p[g][u][0]);
          if (rem > 1) p[g][u][1] = fmaf(x.y, w.y, p[g][u][1]);
          if (rem > 2) p[g][u][2] = fmaf(x.z, w.z, p[g][u][2]);
        }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < U; ++u) out[g][u] = (p[g][u][0] + p[g][u][1]) + (p[g][u][2] + p[g][u][3]);
}

// The lane's units: column j = lane + 32u, clamped into [0, H) so that a
// lane without a unit reads valid memory; own[u] says whether it is real.
template <int U>
struct Units {
  int col[U];
  bool own[U];
  int nu;
  __device__ Units(int H) {
    const int lane = threadIdx.x & 31;
    nu = U == 1 ? 1 : units_for(H);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
      own[u] = u < nu && j < H;
      col[u] = j < H ? j : H - 1;
    }
  }
};

// h[u] = the lane's units of a window's h0 row (0 where it owns none).
template <int U>
__device__ __forceinline__ void load_h0(const Units<U>& un, float (&h)[U],
                                        const float* __restrict__ h0_row) {
#pragma unroll
  for (int u = 0; u < U; ++u) h[u] = un.own[u] ? h0_row[un.col[u]] : 0.0f;
}

// The GRU step's h-independent terms for a chunk of kChunk steps, each lane
// for its own units: x.Wx over d for all the chunk's steps at once (kChunk
// independent sums a gate), then b, into the warp's slots
// gxs [kChunk, 3, nu, 32]; also(c, u) runs beside each step's write (mr_step:
// the flow gate's phi(t) * alpha). xc is the chunk's x [kChunk, D] and wxs
// wx [D, 3H]; steps past the chunk's end compute slots that are never read.
template <int U, class Also>
__device__ __forceinline__ void gru_terms_ahead(const Units<U>& un, const float* xc,
                                                const float* wxs, int D, int H,
                                                const float (&bias)[3][U], float* gxs,
                                                const Also& also) {
  const int lane = threadIdx.x & 31, H3 = 3 * H, nu = un.nu;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u >= nu) continue;
    float a[kChunk][3];
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
#pragma unroll
      for (int g = 0; g < 3; ++g) a[c][g] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float w[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) w[g] = wxs[d * H3 + g * H + un.col[u]];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float xd = xc[c * D + d];
#pragma unroll
        for (int g = 0; g < 3; ++g) a[c][g] = fmaf(xd, w[g], a[c][g]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int g = 0; g < 3; ++g) gxs[((c * 3 + g) * nu + u) * 32 + lane] = a[c][g] + bias[g][u];
      also(c, u);
    }
  }
}

// The GRU(-flow) chain over the first nc steps of a chunk, for one window: h
// the lane's units (published in row_h on entry, and on return), w_rz(q, g, u)
// the reset and update gates' recurrent columns, w_c(q, 0, u) the candidate's,
// gxs the chunk's terms ahead, pa(c, u) the flow gate's phi * alpha at step c.
// The candidate gate is tanh(x.Wx_c + (r*h).Wh_c + b_c), as in the JAX
// package, not torch.nn.GRU's r*(h.Wh_c).
template <int N, bool FLOW, int U, class Wrz, class Wc, class Pa>
__device__ __forceinline__ void gru_steps(const Units<U>& un, float (&h)[U], int H, int nc,
                                          const Wrz& w_rz, const Wc& w_c, const float* gxs,
                                          const Pa& pa, float* row_h, float* row_r) {
  const int lane = threadIdx.x & 31, nu = un.nu;
  for (int c = 0; c < nc; ++c) {
    float a[2][U];
    matvec<N, 2, U>(row_h, H, nu, w_rz, a);
    float z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) continue;
      const float r = sigmoid(gxs[((c * 3 + 0) * nu + u) * 32 + lane] + a[0][u]);
      z[u] = sigmoid(gxs[((c * 3 + 1) * nu + u) * 32 + lane] + a[1][u]);
      if (un.own[u]) row_r[un.col[u]] = r * h[u];
    }
    __syncwarp();
    float ac[1][U];
    matvec<N, 1, U>(row_r, H, nu, w_c, ac);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) continue;
      const float cand = tanhf(gxs[((c * 3 + 2) * nu + u) * 32 + lane] + ac[0][u]);
      if (FLOW) {
        const float p = pa(c, u);  // phi(0) = 0: the identity
        h[u] = h[u] + p * (1.0f - z[u]) * (cand - h[u]);
      } else {  // both products rounded, as the plain version: no FMA to pick
        h[u] = __fadd_rn(__fmul_rn(1.0f - z[u], cand), __fmul_rn(z[u], h[u]));
      }
      if (un.own[u]) row_h[un.col[u]] = h[u];
    }
    __syncwarp();
  }
}

// The dense head of one window, run by its warp after the scan: h[u] the
// lane's units of h_T; row_h and row_r the warp's two rows (row_h is free, as
// every lane has passed the last step's __syncwarp); out_w the window's [K]
// outputs.
template <int N, int U>
__device__ __forceinline__ void warp_head(const Units<U>& un, const float (&h)[U], int H, int Dh,
                                          int K, const float* w1, const float* b1,
                                          const float* w2, const float* b2, float* row_h,
                                          float* row_r, float* __restrict__ out_w, int act_int,
                                          int act_frac) {
  const int lane = threadIdx.x & 31;
  float ss = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (un.own[u]) ss = fmaf(h[u], h[u], ss);
  const float inv = rsqrtf(warp_sum(ss) / H + kRmsEps);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!un.own[u]) continue;
    const float v = h[u] * inv;
    row_h[un.col[u]] = act_frac >= 0 ? quantize_fixed(v, act_int, act_frac) : v;
  }
  __syncwarp();
  // layer 1: relu(hn . w1 + b1), output i on lane i % 32, into row_r
  for (int i = lane; i < Dh; i += 32) {
    auto w1q = [&](int q, int, int) {
      const float* c = w1 + 4 * q * Dh + i;  // k = 4q .. 4q + 3 of column i
      const int last = H - 1 - 4 * q;        // a tail block reads no row past H
      return make_float4(c[0], c[last < 1 ? 0 : Dh], c[last < 2 ? 0 : 2 * Dh],
                         c[last < 3 ? 0 : 3 * Dh]);
    };
    float a[1][1];
    matvec<N, 1, 1>(row_h, H, 1, w1q, a);
    row_r[i] = fmaxf(a[0][0] + b1[i], 0.0f);
  }
  // layer 2: hid . w2 + b2, each output's lanes' partial sums reduced by
  // shuffles; a lane reads back only the hidden units it wrote
#pragma unroll 4
  for (int o = 0; o < K; ++o) {
    float s = 0.0f;
    for (int i = lane; i < Dh; i += 32) s = fmaf(row_r[i], w2[i * K + o], s);
    s = warp_sum(s);
    if (lane == 0) out_w[o] = s + b2[o];
  }
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` the first time a
// launch on the current device needs more than it was allowed; `allowed` is
// the instantiation's own record, so a steady caller sets nothing.
template <typename Kernel>
inline cudaError_t allow_shared_once(Kernel kernel, size_t bytes, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = allow_shared(kernel, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace wc
}  // namespace repro
