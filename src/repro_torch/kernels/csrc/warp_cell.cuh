// Warp-per-window recurrences shared by the fused kernels mr_step.cu (GRU /
// GRU-flow), mr_step_ltc.cu (LTC, semi-implicit substeps), mr_step_node.cu
// (NODE, Euler substeps), the bare scan gru_scan.cu (mr_step's step without
// the head, writing each step's h), the banked service ticks mr_tick.cu
// (mr_step's step and head over a slot's windows) and mr_tick_int8.cu (the
// same with the int8/PWL standard GRU cell and int8 head), and the int8/PWL
// serving kernels mr_step_int8.cu (mr_step's body on the int8 cell and head),
// gru_scan_int8.cu (gru_scan's body on the int8 cell) and mr_step_ltc_int8.cu
// (mr_step_ltc's body on the int8 substep and head).
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
//   (the ticks build their windows' x themselves). Each lane reads back only
//   what it wrote, so the slots need no synchronisation.
// - The head runs in the same warp: RMS-norm by a shuffle reduction, the
//   optional Qm.n step (head.cuh quantize_fixed), layer 1 with the Dh outputs
//   on the lanes, layer 2 with each of the K outputs reduced by shuffles.
//
// The GRU's gate arithmetic is a policy of one set of loops (gru_terms_ahead,
// gru_steps, warp_head, gru_windows), not a second copy of them: F32Cell and
// F32Head (float weights, x.Wx + b ahead of the chain, the accurate sigmoid
// and tanh) and Int8Cell and Int8Head, the int8/PWL serving cell of
// repro/kernels/gru_scan/kernel.py:174 (_gru_q_step_math): each int8 weight
// dequantized as __fmul_rn(float(q), scale[column]), the value the plain
// version's dequantized weight holds; the slots ahead hold x.Wx alone and the
// bias is added on the chain after the matvec, (x.Wx + h.Wh) + b with both
// adds rounded; PWL sigmoid and tanh (pwl.cuh) on tables in shared memory;
// each head layer's bias added after its sum and no activation step. The LTC
// substep is a policy of ltc_windows the same way: F32Ltc and Int8Ltc, the
// int8/PWL substep of repro/kernels/mr_step/kernel.py:614 (_ltc_q_step_math),
// every operation rounded apart as the plain version rounds it. A kernel's
// operands (GruArgs, GruQArgs, LtcArgs, LtcQArgs) select the policy, the
// carve and the staging.
//
// Precision: float32 throughout with the accurate expf, tanhf, log1pf and
// the IEEE division (no fast-math, no approximate intrinsics); the partial
// sums only reorder the products' sums (tests/test_torch_warp_cells.py
// emulates the order on the CPU against the JAX package).
//
// Shared memory: the block's weights (staged once, cp.async by every thread),
// then one area a warp (two broadcast rows, the x chunks, the precomputed
// slots). The layouts below are the carves; kernels/mr_step/tiling.py
// mr_step_smem_bytes, gru_scan_smem_bytes, ltc_smem_bytes, node_smem_bytes,
// int8_smem_bytes, ltc_int8_smem_bytes and tick_smem_bytes count the same
// regions.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "head.cuh"  // quantize_fixed, kRmsEps
#include "mma.cuh"   // smem_u32, cp_async16, cp_async_commit, cp_async_wait, aligned16
#include "pwl.cuh"   // pwl_eval

namespace repro {

constexpr float kInvLipschitzAlpha = 0.4f;  // core/neural_flow.py INV_LIPSCHITZ_ALPHA

// jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0); the flow gate's rate
__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

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

// The int8 head's weights (mr_tick_int8, mr_step_int8, mr_step_ltc_int8): int8
// w1 [H, Dh] and w2 [Dh, K] in whole floats (q_floats), each beside its
// scales and bias.
struct HeadQLayout {
  size_t w1, s1, b1, w2, s2, b2;
  __host__ __device__ void carve(Carve& c, int H, int Dh, int K) {
    w1 = c.take(q_floats((size_t)H * Dh));
    s1 = c.take(Dh);
    b1 = c.take(Dh);
    w2 = c.take(q_floats((size_t)Dh * K));
    s2 = c.take(K);
    b2 = c.take(K);
  }
};

// mr_step: wx [D, 3H], wh's 3H columns [3H, S], b [3H], time_scale [H], the head; a warp:
// rows h and r*h (or the head's hidden layer), two chunks of x [kChunk, D] and
// dts [kChunk], the gates' x.Wx + b [kChunk, 3, nu, 32] and phi*alpha
// [kChunk, nu, 32]. gru_scan carves the same with no head (Dh = K = 0).
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

// mr_step_int8: int8 wx [D, 3H], wh's 3H columns [3H, S] dequantized at
// staging (at H <= 32 the region holds int8 wh row-major [H, 3H] instead, read
// once into registers), the scales of wx and wh and b [3H], the PWL sigmoid and
// tanh tables (P floats each), the int8 head; a warp: rows h and r*h (or the
// head's hidden layer), two chunks of x [kChunk, D], the gates' x.Wx
// [kChunk, 3, nu, 32]. gru_scan_int8 carves the same with no head (Dh = K = 0).
struct GruQLayout {
  size_t wx, wh, sx, sh, b, sig, tnh, warps, row_h, row_r, xbuf[2], gx, per_warp, total;
  HeadQLayout head;
  __host__ __device__ GruQLayout(int D, int H, int Dh, int K, int bb, int P) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    Carve c;
    wx = c.take(q_floats((size_t)D * 3 * H));
    wh = c.take((size_t)3 * H * S);
    sx = c.take(3 * H);
    sh = c.take(3 * H);
    b = c.take(3 * H);
    sig = c.take(P);
    tnh = c.take(P);
    head.carve(c, H, Dh, K);
    warps = c.n;
    Carve w;
    row_h = w.take(R);
    row_r = w.take(R);
    xbuf[0] = w.take(kChunk * D);
    xbuf[1] = w.take(kChunk * D);
    gx = w.take(kChunk * 3 * 32 * nu);
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

// mr_step_ltc_int8: w_rec's columns [H, S] dequantized at staging (at H <= 32
// the region holds int8 w_rec row-major [H, H] instead, read once into
// registers), int8 w_in [D, H], the scales of w_in and w_rec, bias, a, inv_tau
// [H], the PWL sigmoid table (P floats), the int8 head; a warp: as LtcLayout.
struct LtcQLayout {
  size_t wrec, win, s_in, s_rec, bias, a, itau, sig, warps, row_h, row_r, xbuf[2], drv, per_warp,
      total;
  HeadQLayout head;
  __host__ __device__ LtcQLayout(int D, int H, int Dh, int K, int bb, int P) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    Carve c;
    wrec = c.take((size_t)H * S);
    win = c.take(q_floats((size_t)D * H));
    s_in = c.take(H);
    s_rec = c.take(H);
    bias = c.take(H);
    a = c.take(H);
    itau = c.take(H);
    sig = c.take(P);
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

// mr_tick_int8, one block of a slot's cluster: int8 wx [D, 3H], int8 wh's 3H
// columns [3H, S] (bytes; row-major [H, 3H] at H <= 32, read once into
// registers), the scales of wx and wh and b [3H], the PWL sigmoid and tanh
// tables (P floats each), the int8 head, the slot's head outputs [N, K]; a
// warp: as TickLayout (the slots hold x.Wx alone).
struct TickQLayout {
  size_t wx, wh, sx, sh, b, sig, tnh, out, warps, row_h, row_r, x, gx, per_warp, total;
  HeadQLayout head;
  __host__ __device__ TickQLayout(int D, int H, int Dh, int K, int T, int N, int P) {
    const int nu = units_for(H), R = H > Dh ? H : Dh, S = col_stride(H);
    const int Tc = (T + kChunk - 1) / kChunk * kChunk;
    Carve c;
    wx = c.take(q_floats((size_t)D * 3 * H));
    wh = c.take(q_floats((size_t)3 * H * S));
    sx = c.take(3 * H);
    sh = c.take(3 * H);
    b = c.take(3 * H);
    sig = c.take(P);
    tnh = c.take(P);
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

// n int8 values from device memory into shared memory by threads t, t + nt,
// ...: 16-byte cp.async where both ends are 16-byte aligned, plain byte
// copies for the rest. The caller commits, waits and publishes with a barrier.
__device__ inline void copy_bytes_async(int8_t* dst, const int8_t* __restrict__ src, int n, int t,
                                        int nt) {
  int done = 0;
  if (aligned16(src) && aligned16(dst)) {
    const int n16 = n / 16;
    for (int i = t; i < n16; i += nt) cp_async16(dst + 16 * i, src + 16 * i, true);
    done = 16 * n16;
  }
  for (int i = done + t; i < n; i += nt) dst[i] = src[i];
}

// The [rows, cols] row-major int8 matrix src into shared memory column-major
// with a column stride of S bytes (dst[c * S + k] = src[k * cols + c]), by
// threads t, t + nt, ...: plain byte copies, consecutive threads on
// consecutive columns. The caller publishes with a barrier.
__device__ inline void copy_columns_q(int8_t* dst, const int8_t* __restrict__ src, int rows,
                                      int cols, int S, int t, int nt) {
  for (int k = 0; k < rows; ++k)
#pragma unroll 4
    for (int c = t; c < cols; c += nt) dst[(size_t)c * S + k] = src[(size_t)k * cols + c];
}

// The [rows, cols] row-major int8 matrix src dequantized into shared memory
// column-major with a column stride of S floats, dst[c * S + k] =
// __fmul_rn(float(src[k * cols + c]), scale[c]) (the value the plain version's
// dequantized weight holds), by threads t, t + nt, ...: plain loads,
// consecutive threads on consecutive columns. The caller publishes with a
// barrier.
__device__ inline void copy_columns_dequant(float* dst, const int8_t* __restrict__ src,
                                            const float* __restrict__ scale, int rows, int cols,
                                            int S, int t, int nt) {
  for (int c = t; c < cols; c += nt) {
    const float sc = scale[c];
#pragma unroll 4
    for (int k = 0; k < rows; ++k)
      dst[(size_t)c * S + k] = __fmul_rn((float)src[(size_t)k * cols + c], sc);
  }
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

// The weights of k = 0 .. 3 of a column of a row-major matrix with n columns.
__device__ __forceinline__ float4 rows4(const float* w, int n) {
  return make_float4(w[0], w[n], w[2 * n], w[3 * n]);
}
__device__ __forceinline__ char4 rows4(const int8_t* w, int n) {
  return make_char4(w[0], w[n], w[2 * n], w[3 * n]);
}

// Four int8 weights of one column dequantized with its scale, each
// __fmul_rn(float(q), sc): the value the plain version's dequantized weight holds.
__device__ __forceinline__ float4 dequant4(char4 w, float sc) {
  return make_float4(__fmul_rn((float)w.x, sc), __fmul_rn((float)w.y, sc),
                     __fmul_rn((float)w.z, sc), __fmul_rn((float)w.w, sc));
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

// The GRU cell's gate arithmetic, a policy of gru_terms_ahead and gru_steps:
// wx_at the input weight of (d, gate g, the lane's unit u in column col),
// ahead what a slot ahead of the chain holds of x.Wx, pre a gate's
// pre-activation from its slot and its recurrent sum, sig and tanh_ the
// activations. F32Cell: float wx [D, 3H] in shared memory, x.Wx + b ahead, the
// accurate sigmoid and tanh (mr_step, gru_scan, mr_tick).
template <int U>
struct F32Cell {
  const float* wx;
  int H;
  float bias[3][U];  // the lane's units' b
  __device__ __forceinline__ float wx_at(int d, int g, int, int col) const {
    return wx[d * 3 * H + g * H + col];
  }
  __device__ __forceinline__ float ahead(float xw, int g, int u) const { return xw + bias[g][u]; }
  __device__ __forceinline__ float pre(float gx, float hw, int, int) const { return gx + hw; }
  __device__ __forceinline__ float sig(float v) const { return sigmoid(v); }
  __device__ __forceinline__ float tanh_(float v) const { return tanhf(v); }
};

// The int8/PWL standard GRU cell (mr_tick_int8, mr_step_int8, gru_scan_int8):
// int8 wx [D, 3H] in shared memory, dequantized on use with the lane's column
// scales (one rounding); the slots ahead hold x.Wx alone and the bias comes
// last, (x.Wx + h.Wh) + b, both adds rounded; the PWL tables in shared memory.
template <int U>
struct Int8Cell {
  const int8_t* wx;
  const float* sig_tab;
  const float* tanh_tab;
  int H, n_seg;
  float sx[3][U];    // the lane's units' scales of wx
  float bias[3][U];  // the lane's units' b
  __device__ __forceinline__ float wx_at(int d, int g, int u, int col) const {
    return __fmul_rn((float)wx[d * 3 * H + g * H + col], sx[g][u]);
  }
  __device__ __forceinline__ float ahead(float xw, int, int) const { return xw; }
  __device__ __forceinline__ float pre(float gx, float hw, int g, int u) const {
    return __fadd_rn(__fadd_rn(gx, hw), bias[g][u]);
  }
  __device__ __forceinline__ float sig(float v) const { return pwl_eval(sig_tab, n_seg, v); }
  __device__ __forceinline__ float tanh_(float v) const { return pwl_eval(tanh_tab, n_seg, v); }
};

// The head's weights, a policy of warp_head: w1_at(k, i) of w1 [H, Dh],
// w2_at(i, o) of w2 [Dh, K], the biases b1 [Dh] and b2 [K], each added after
// its layer's sum. F32Head: float weights; Int8Head: int8 weights dequantized
// on use with their column's scale.
struct F32Head {
  const float *w1, *b1, *w2, *b2;
  int Dh, K;
  __device__ __forceinline__ float w1_at(int k, int i) const { return w1[k * Dh + i]; }
  __device__ __forceinline__ float w2_at(int i, int o) const { return w2[i * K + o]; }
};

struct Int8Head {
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  int Dh, K;
  __device__ __forceinline__ float w1_at(int k, int i) const {
    return __fmul_rn((float)w1[k * Dh + i], s1[i]);
  }
  __device__ __forceinline__ float w2_at(int i, int o) const {
    return __fmul_rn((float)w2[i * K + o], s2[o]);
  }
};

// The head's policy on the weights a block staged at L (HeadLayout, HeadQLayout).
__device__ __forceinline__ F32Head head_at(const float* smem, const HeadLayout& L, int Dh, int K) {
  return {smem + L.w1, smem + L.b1, smem + L.w2, smem + L.b2, Dh, K};
}
__device__ __forceinline__ Int8Head head_at(const float* smem, const HeadQLayout& L, int Dh,
                                            int K) {
  return {reinterpret_cast<const int8_t*>(smem + L.w1), smem + L.s1, smem + L.b1,
          reinterpret_cast<const int8_t*>(smem + L.w2), smem + L.s2, smem + L.b2, Dh, K};
}

// The LTC substep's arithmetic, a policy of ltc_windows: win_at the input
// weight of (d, the lane's unit u in column col), drive the drive from its sum
// x.W_in, step the new h from h, the drive and the recurrent sum h.W_rec.
// F32Ltc (mr_step_ltc): float w_in, the accurate sigmoid, the update's
// (sub_dt * f) * a and sub_dt * (inv_tau + f) as the plain version forms them,
// each with its add fused into one FMA (what nvcc makes of a * b + c), and
// the IEEE num / den.
template <int U>
struct F32Ltc {
  const float* win;
  int H;
  float sub_dt;
  float bias[U], a[U], itau[U];  // the lane's units'
  __device__ __forceinline__ float win_at(int d, int, int col) const { return win[d * H + col]; }
  __device__ __forceinline__ float drive(float xw, int u) const { return xw + bias[u]; }
  __device__ __forceinline__ float step(float h, float drive, float rec, int u) const {
    const float f = sigmoid(drive + rec);
    const float num = fmaf(sub_dt * f, a[u], h);        // h + (sub_dt * f) * a
    const float den = fmaf(sub_dt, itau[u] + f, 1.0f);  // 1 + sub_dt * (inv_tau + f)
    return num / den;
  }
};

// The int8/PWL substep (mr_step_ltc_int8): int8 w_in dequantized on use with
// the lane's column scales, the PWL sigmoid on its table in shared memory, and
// every operation rounded apart as the plain version (ltc_scan_int8_reference)
// rounds it, so ptxas has no product and add to contract:
// drive = x.W_in + bias; f = pwl(drive + h.W_rec);
// h = (h + (sub_dt * f) * a) / (1 + sub_dt * (inv_tau + f)).
template <int U>
struct Int8Ltc {
  const int8_t* win;
  const float* sig_tab;
  int H, n_seg;
  float sub_dt;
  float s_in[U], bias[U], a[U], itau[U];  // the lane's units'
  __device__ __forceinline__ float win_at(int d, int u, int col) const {
    return __fmul_rn((float)win[d * H + col], s_in[u]);
  }
  __device__ __forceinline__ float drive(float xw, int u) const { return __fadd_rn(xw, bias[u]); }
  __device__ __forceinline__ float step(float h, float drive, float rec, int u) const {
    const float f = pwl_eval(sig_tab, n_seg, __fadd_rn(drive, rec));
    const float num = __fadd_rn(h, __fmul_rn(__fmul_rn(sub_dt, f), a[u]));
    const float den = __fadd_rn(1.0f, __fmul_rn(sub_dt, __fadd_rn(itau[u], f)));
    return __fdiv_rn(num, den);
  }
};

// A kernel's operands in device memory; their type selects the policy, the
// carve and the staging of gru_windows and ltc_windows. GruArgs (mr_step,
// gru_scan): float weights, the flow gate's rates and dts, the float head;
// GruQArgs (mr_step_int8, gru_scan_int8): int8 weights beside their column
// scales, the PWL sigmoid and tanh tables of n_seg segments, the int8 head;
// LtcArgs (mr_step_ltc) and LtcQArgs (mr_step_ltc_int8) the same for the LTC.
struct GruArgs {
  const float *wx, *wh, *b, *time_scale, *dts, *w1, *b1, *w2, *b2;
};
struct GruQArgs {
  const int8_t *wx, *wh;
  const float *sx, *sh, *b, *sig, *tnh;
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  int n_seg;
};
struct LtcArgs {
  const float *w_in, *w_rec, *bias, *a, *inv_tau, *w1, *b1, *w2, *b2;
};
struct LtcQArgs {
  const int8_t* w_in;
  const float* s_in;
  const int8_t* w_rec;
  const float *s_rec, *bias, *a, *inv_tau, *sig;
  const int8_t* w1;
  const float *s1, *b1;
  const int8_t* w2;
  const float *s2, *b2;
  int n_seg;
};

// The head's weights into the block's carve at L by threads t, t + nt, ...;
// the caller commits, waits and publishes.
template <class A>
__device__ __forceinline__ void stage_head(float* smem, const HeadLayout& L, const A& a, int H,
                                           int Dh, int K, int t, int nt) {
  copy_async(smem + L.w1, a.w1, H * Dh, t, nt);
  copy_async(smem + L.b1, a.b1, Dh, t, nt);
  copy_async(smem + L.w2, a.w2, Dh * K, t, nt);
  copy_async(smem + L.b2, a.b2, K, t, nt);
}
template <class A>
__device__ __forceinline__ void stage_head(float* smem, const HeadQLayout& L, const A& a, int H,
                                           int Dh, int K, int t, int nt) {
  copy_bytes_async(reinterpret_cast<int8_t*>(smem + L.w1), a.w1, H * Dh, t, nt);
  copy_async(smem + L.s1, a.s1, Dh, t, nt);
  copy_async(smem + L.b1, a.b1, Dh, t, nt);
  copy_bytes_async(reinterpret_cast<int8_t*>(smem + L.w2), a.w2, Dh * K, t, nt);
  copy_async(smem + L.s2, a.s2, K, t, nt);
  copy_async(smem + L.b2, a.b2, K, t, nt);
}

// The GRU step's h-independent terms for a chunk of kChunk steps, each lane
// for its own units: x.Wx over d for all the chunk's steps at once (kChunk
// independent sums a gate), then the cell's ahead (b, for F32Cell), into the
// warp's slots gxs [kChunk, 3, nu, 32]; also(c, u) runs beside each step's
// write (mr_step, gru_scan: the flow gate's phi(t) * alpha). xc is the
// chunk's x [kChunk, D]; steps past the chunk's end compute slots that are
// never read.
template <int U, class Cell, class Also>
__device__ __forceinline__ void gru_terms_ahead(const Units<U>& un, const Cell& cell,
                                                const float* xc, int D, float* gxs,
                                                const Also& also) {
  const int lane = threadIdx.x & 31, nu = un.nu;
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
      for (int g = 0; g < 3; ++g) w[g] = cell.wx_at(d, g, u, un.col[u]);
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
      for (int g = 0; g < 3; ++g) gxs[((c * 3 + g) * nu + u) * 32 + lane] = cell.ahead(a[c][g], g, u);
      also(c, u);
    }
  }
}

// The GRU(-flow) chain over the first nc steps of a chunk, for one window: h
// the lane's units (published in row_h on entry, and on return), w_rz(q, g, u)
// the reset and update gates' recurrent columns, w_c(q, 0, u) the candidate's,
// gxs the chunk's terms ahead, pa(c, u) the flow gate's phi * alpha at step c,
// put(c, u, h) called with each of the lane's own units' new h (gru_scan
// writes it out). The candidate gate is tanh(x.Wx_c + (r*h).Wh_c + b_c), as in
// the JAX package, not torch.nn.GRU's r*(h.Wh_c).
template <int N, bool FLOW, int U, class Cell, class Wrz, class Wc, class Pa, class Put>
__device__ __forceinline__ void gru_steps(const Units<U>& un, const Cell& cell, float (&h)[U],
                                          int H, int nc, const Wrz& w_rz, const Wc& w_c,
                                          const float* gxs, const Pa& pa, float* row_h,
                                          float* row_r, const Put& put) {
  const int lane = threadIdx.x & 31, nu = un.nu;
  for (int c = 0; c < nc; ++c) {
    float a[2][U];
    matvec<N, 2, U>(row_h, H, nu, w_rz, a);
    float z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) continue;
      const float r = cell.sig(cell.pre(gxs[((c * 3 + 0) * nu + u) * 32 + lane], a[0][u], 0, u));
      z[u] = cell.sig(cell.pre(gxs[((c * 3 + 1) * nu + u) * 32 + lane], a[1][u], 1, u));
      if (un.own[u]) row_r[un.col[u]] = r * h[u];
    }
    __syncwarp();
    float ac[1][U];
    matvec<N, 1, U>(row_r, H, nu, w_c, ac);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= nu) continue;
      const float cand = cell.tanh_(cell.pre(gxs[((c * 3 + 2) * nu + u) * 32 + lane], ac[0][u], 2, u));
      if (FLOW) {
        const float p = pa(c, u);  // phi(0) = 0: the identity
        h[u] = h[u] + p * (1.0f - z[u]) * (cand - h[u]);
      } else {  // both products rounded, as the plain version: no FMA to pick
        h[u] = __fadd_rn(__fmul_rn(1.0f - z[u], cand), __fmul_rn(z[u], h[u]));
      }
      if (un.own[u]) {
        row_h[un.col[u]] = h[u];
        put(c, u, h[u]);
      }
    }
    __syncwarp();
  }
}

// The dense head of one window, run by its warp after the scan: h[u] the
// lane's units of h_T; hd the head's weights (F32Head, Int8Head); row_h and
// row_r the warp's two rows (row_h is free, as every lane has passed the last
// step's __syncwarp); out_w the window's [K] outputs.
template <int N, int U, class Head>
__device__ __forceinline__ void warp_head(const Units<U>& un, const float (&h)[U], int H,
                                          const Head& hd, float* row_h, float* row_r,
                                          float* __restrict__ out_w, int act_int, int act_frac) {
  const int lane = threadIdx.x & 31, Dh = hd.Dh, K = hd.K;
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
      const int k = 4 * q, last = H - 1 - k;  // a tail block reads no row past H
      return make_float4(hd.w1_at(k, i), hd.w1_at(last < 1 ? k : k + 1, i),
                         hd.w1_at(last < 2 ? k : k + 2, i), hd.w1_at(last < 3 ? k : k + 3, i));
    };
    float a[1][1];
    matvec<N, 1, 1>(row_h, H, 1, w1q, a);
    row_r[i] = fmaxf(a[0][0] + hd.b1[i], 0.0f);
  }
  // layer 2: hid . w2 + b2, each output's lanes' partial sums reduced by
  // shuffles; a lane reads back only the hidden units it wrote
#pragma unroll 4
  for (int o = 0; o < K; ++o) {
    float s = 0.0f;
    for (int i = lane; i < Dh; i += 32) s = fmaf(row_r[i], hd.w2_at(i, o), s);
    s = warp_sum(s);
    if (lane == 0) out_w[o] = s + hd.b2[o];
  }
}

// The body of the GRU kernels that read their windows from device memory,
// mr_step.cu, gru_scan.cu, mr_step_int8.cu and gru_scan_int8.cu: a block of
// `bb` windows stages the gate weights and, for the fused stages, the head's
// once (GruLayout, or GruQLayout for the int8 operands GruQArgs), meets its one
// barrier, and each warp runs its windows' T steps, the x chunk (and the flow
// gate's dts) staged by cp.async a chunk ahead and the cell's terms ahead
// (x.Wx + b, or x.Wx alone on the int8 cell) and the flow gate's phi(t) * alpha
// computed ahead of each chunk. HS (the scans): each step's h goes to
// out = hs [B, T, H], the lanes on consecutive columns, and there is no head
// (Dh = K = 0); else the head's K outputs go to out [B, K].
template <int N, bool FLOW, bool HS, class A>
__device__ __forceinline__ void gru_windows(const float* __restrict__ xs,
                                            const float* __restrict__ h0, const A& args,
                                            float* __restrict__ out, int T, int D, int H_rt,
                                            int Dh, int K, int bb, int act_int, int act_frac) {
  constexpr bool Q = std::is_same_v<A, GruQArgs>;
  static_assert(!(Q && FLOW), "the int8/PWL cell is the standard GRU");
  constexpr int U = N > 0 ? (N + 31) / 32 : kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // the recurrent columns fit in registers
  const int H = width<N>(H_rt), H3 = 3 * H, S = col_stride(H);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const auto L = [&] {
    if constexpr (Q) return GruQLayout(D, H, Dh, K, bb, pwl_floats(args.n_seg));
    else return GruLayout(D, H, Dh, K, bb);
  }();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * bb;
  float* area = smem + L.warps + warp * L.per_warp;

  // a window's x chunk [t0, t0 + kChunk) (and its dts) into slot s of the warp's area
  auto stage_chunk = [&](int s, int window, int t0) {
    const int nc = min(kChunk, T - t0);
    float* dst = area + (s ? L.xbuf[1] : L.xbuf[0]);
    copy_async(dst, xs + ((size_t)window * T + t0) * D, nc * D, lane, 32);
    if constexpr (!Q) copy_async(area + (s ? L.dbuf[1] : L.dbuf[0]), args.dts + t0, nc, lane, 32);
  };

  // staging: the weights by every thread, each warp's first x chunk by the warp
  if constexpr (Q) {
    if constexpr (REG)  // dequantized once into registers: int8 row-major, 16-byte copies
      copy_bytes_async(reinterpret_cast<int8_t*>(smem + L.wh), args.wh, H * H3, threadIdx.x,
                       blockDim.x);
    else  // read every step: dequantized once, column-major, a float4 of a column per load
      copy_columns_dequant(smem + L.wh, args.wh, args.sh, H, H3, S, threadIdx.x, blockDim.x);
    copy_bytes_async(reinterpret_cast<int8_t*>(smem + L.wx), args.wx, D * H3, threadIdx.x,
                     blockDim.x);
    copy_async(smem + L.sx, args.sx, H3, threadIdx.x, blockDim.x);
    copy_async(smem + L.sh, args.sh, H3, threadIdx.x, blockDim.x);
    copy_async(smem + L.b, args.b, H3, threadIdx.x, blockDim.x);
    copy_async(smem + L.sig, args.sig, pwl_floats(args.n_seg), threadIdx.x, blockDim.x);
    copy_async(smem + L.tnh, args.tnh, pwl_floats(args.n_seg), threadIdx.x, blockDim.x);
  } else {
    copy_async(smem + L.wx, args.wx, D * H3, threadIdx.x, blockDim.x);
    if constexpr (REG)  // read once into registers: row-major, 16-byte copies
      copy_async(smem + L.wh, args.wh, H * H3, threadIdx.x, blockDim.x);
    else  // read every step: column-major, a float4 of a column per load
      copy_columns_async(smem + L.wh, args.wh, H, H3, S, threadIdx.x, blockDim.x);
    copy_async(smem + L.b, args.b, H3, threadIdx.x, blockDim.x);
    copy_async(smem + L.ts, args.time_scale, H, threadIdx.x, blockDim.x);
  }
  if constexpr (!HS) stage_head(smem, L.head, args, H, Dh, K, threadIdx.x, blockDim.x);
  stage_chunk(0, b0 + warp, 0);
  cp_async_commit();
  const Units<U> un(H);
  float h_next[U];  // the warp's next window's h0, loaded ahead of its use
  load_h0(un, h_next, h0 + (size_t)(b0 + warp) * H);
  cp_async_wait<0>();
  __syncthreads();  // the block's only barrier

  // the lane's constants: its units' biases (the int8 cell: and wx's scales),
  // the flow gate's rates, and at H <= 32 its recurrent columns (the int8
  // cell: dequantized here, so no multiply is left on the chain)
  std::conditional_t<Q, Int8Cell<U>, F32Cell<U>> cell;
  cell.H = H;
  if constexpr (Q) {
    cell.wx = reinterpret_cast<const int8_t*>(smem + L.wx);
    cell.sig_tab = smem + L.sig;
    cell.tanh_tab = smem + L.tnh;
    cell.n_seg = args.n_seg;
  } else {
    cell.wx = smem + L.wx;
  }
  float sp[U];
  float4 wr[REG ? 3 : 1][U][REG ? N / 4 : 1];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int j = g * H + un.col[u];
      cell.bias[g][u] = smem[L.b + j];
      if constexpr (Q) cell.sx[g][u] = smem[L.sx + j];
    }
    if constexpr (!Q) sp[u] = softplus(smem[L.ts + un.col[u]]);
    if constexpr (REG) {
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const int at = un.col[u] + g * H + 4 * q * H3;  // row-major: k = 4q .. 4q + 3
          if constexpr (Q)
            wr[g][u][q] = dequant4(rows4(reinterpret_cast<const int8_t*>(smem + L.wh) + at, H3),
                                   smem[L.sh + g * H + un.col[u]]);
          else
            wr[g][u][q] = rows4(smem + L.wh + at, H3);
        }
    }
  }
  // wh's column g * H + j, k = 4q .. 4q + 3: a float4 of the column-major copy
  const float4* wh4 = reinterpret_cast<const float4*>(smem + L.wh);
  auto wh_at = [&](int q, int g, int u) { return wh4[(g * H + un.col[u]) * (S / 4) + q]; };
  auto w_rz = [&](int q, int g, int u) {
    if constexpr (REG) return wr[g][u][q];
    else return wh_at(q, g, u);
  };
  auto w_c = [&](int q, int, int u) {
    if constexpr (REG) return wr[2][u][q];
    else return wh_at(q, 2, u);
  };

  float* row_h = area + L.row_h;
  float* row_r = area + L.row_r;
  float* gxs = area + L.gx;
  float* phis = nullptr;  // the flow gate's phi * alpha
  if constexpr (!Q) phis = area + L.phi;
  const int nu = un.nu;
  int slot = 0;
  for (int w = warp; w < bb; w += n_warps) {
    const int window = b0 + w;
    __syncwarp();  // the previous window's head (or last step) has read row_h
    float h[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h[u] = h_next[u];
      if (un.own[u]) row_h[un.col[u]] = h[u];
    }
    for (int t0 = 0; t0 < T; t0 += kChunk) {
      const int nc = min(kChunk, T - t0);
      cp_async_wait<0>();
      __syncwarp();  // this chunk's x and dts have arrived; row_h holds h
      // the chunk's h-independent terms: the cell's x.Wx (+ b), and the flow gate's phi * alpha
      const float* xc = area + (slot ? L.xbuf[1] : L.xbuf[0]);
      const float* dc = nullptr;
      if constexpr (!Q) dc = area + (slot ? L.dbuf[1] : L.dbuf[0]);
      gru_terms_ahead<U>(un, cell, xc, D, gxs, [&](int c, int u) {
        if (FLOW) phis[(c * nu + u) * 32 + lane] = tanhf(sp[u] * dc[c]) * kInvLipschitzAlpha;
      });
      // the next chunk's x (or the next window's first) while this one runs
      if (t0 + kChunk < T) stage_chunk(slot ^ 1, window, t0 + kChunk);
      else if (w + n_warps < bb) {
        stage_chunk(slot ^ 1, window + n_warps, 0);
        load_h0(un, h_next, h0 + (size_t)(window + n_warps) * H);
      }
      cp_async_commit();
      slot ^= 1;

      auto pa = [&](int c, int u) { return phis[(c * nu + u) * 32 + lane]; };
      float* hs_c = out + ((size_t)window * T + t0) * H;  // HS: this chunk's rows of hs
      gru_steps<N, FLOW, U>(un, cell, h, H, nc, w_rz, w_c, gxs, pa, row_h, row_r,
                            [&](int c, int u, float v) {
                              if constexpr (HS) hs_c[c * H + un.col[u]] = v;
                            });
    }
    if constexpr (!HS) {
      const auto hd = head_at(smem, L.head, Dh, K);
      warp_head<N, U>(un, h, H, hd, row_h, row_r, out + (size_t)window * K, act_int, act_frac);
    }
  }
}

// The substep loop of the LTC and NODE kernels: substep(s) for s < n, unrolled
// UNROLL times, a compile-time factor (the remainder of n / UNROLL runs one at
// a time, so any n runs). Unrolling repeats the same code and reorders no
// operation: every factor gives the same bits. mr_step_ltc and mr_step_node
// are instantiated for 1 only (kernels/mr_step/tiling.py SUBSTEP_UNROLLS:
// 2 and 6 gave the same bits and no faster kernel on an H100); their launchers
// refuse any other factor.
template <int UNROLL, class F>
__device__ __forceinline__ void substeps(int n, F&& substep) {
  if constexpr (UNROLL == 1) {
    for (int s = 0; s < n; ++s) substep(s);
  } else {
    int s = 0;
    for (; s + UNROLL <= n; s += UNROLL) {
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) substep(s + i);
    }
    for (; s < n; ++s) substep(s);
  }
}

// The body of the LTC kernels, mr_step_ltc.cu and mr_step_ltc_int8.cu: a block
// of `bb` windows (LtcLayout, or LtcQLayout for the int8 operands LtcQArgs)
// stages w_rec, w_in, bias, a, inv_tau and the head weights once, meets its one
// barrier, and each warp runs its windows' T * n_substeps substeps and the
// head. A substep's chain is h.W_rec (four partial sums an output, from
// registers at H <= 32, reading h from one of the warp's two rows and
// publishing the new h in the other), the add of the drive, the activation,
// the numerator and denominator and their IEEE division (the policy's step);
// the drive x_t.W_in + bias was computed before the chunk of steps from an x
// chunk that cp.async staged a chunk ahead. UNROLL unrolls the substep loop
// (substeps); the int8 kernel runs it at 1.
template <int N, int UNROLL, class A>
__device__ __forceinline__ void ltc_windows(const float* __restrict__ xs,
                                            const float* __restrict__ h0, const A& args,
                                            float* __restrict__ out, int T, int D, int H_rt,
                                            int Dh, int K, int bb, int n_substeps, float sub_dt,
                                            int act_int, int act_frac) {
  constexpr bool Q = std::is_same_v<A, LtcQArgs>;
  constexpr int U = N > 0 ? (N + 31) / 32 : kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // w_rec's columns fit in registers
  const int H = width<N>(H_rt), S = col_stride(H);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const auto L = [&] {
    if constexpr (Q) return LtcQLayout(D, H, Dh, K, bb, pwl_floats(args.n_seg));
    else return LtcLayout(D, H, Dh, K, bb);
  }();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * bb;
  float* area = smem + L.warps + warp * L.per_warp;

  // a window's x chunk [t0, t0 + kChunk) into slot s of the warp's area
  auto stage_chunk = [&](int s, int window, int t0) {
    const int nc = min(kChunk, T - t0);
    float* dst = area + (s ? L.xbuf[1] : L.xbuf[0]);
    copy_async(dst, xs + ((size_t)window * T + t0) * D, nc * D, lane, 32);
  };

  // staging: the weights by every thread, each warp's first x chunk by the warp
  if constexpr (Q) {
    if constexpr (REG)  // dequantized once into registers: int8 row-major, 16-byte copies
      copy_bytes_async(reinterpret_cast<int8_t*>(smem + L.wrec), args.w_rec, H * H, threadIdx.x,
                       blockDim.x);
    else  // read every substep: dequantized once, column-major, a float4 of a column per load
      copy_columns_dequant(smem + L.wrec, args.w_rec, args.s_rec, H, H, S, threadIdx.x,
                           blockDim.x);
    copy_bytes_async(reinterpret_cast<int8_t*>(smem + L.win), args.w_in, D * H, threadIdx.x,
                     blockDim.x);
    copy_async(smem + L.s_in, args.s_in, H, threadIdx.x, blockDim.x);
    copy_async(smem + L.s_rec, args.s_rec, H, threadIdx.x, blockDim.x);
    copy_async(smem + L.sig, args.sig, pwl_floats(args.n_seg), threadIdx.x, blockDim.x);
  } else {
    if constexpr (REG)  // read once into registers: row-major, 16-byte copies
      copy_async(smem + L.wrec, args.w_rec, H * H, threadIdx.x, blockDim.x);
    else  // read every substep: column-major, a float4 of a column per load
      copy_columns_async(smem + L.wrec, args.w_rec, H, H, S, threadIdx.x, blockDim.x);
    copy_async(smem + L.win, args.w_in, D * H, threadIdx.x, blockDim.x);
  }
  copy_async(smem + L.bias, args.bias, H, threadIdx.x, blockDim.x);
  copy_async(smem + L.a, args.a, H, threadIdx.x, blockDim.x);
  copy_async(smem + L.itau, args.inv_tau, H, threadIdx.x, blockDim.x);
  stage_head(smem, L.head, args, H, Dh, K, threadIdx.x, blockDim.x);
  stage_chunk(0, b0 + warp, 0);
  cp_async_commit();
  const Units<U> un(H);
  float h_next[U];  // the warp's next window's h0, loaded ahead of its use
  load_h0(un, h_next, h0 + (size_t)(b0 + warp) * H);
  cp_async_wait<0>();
  __syncthreads();  // the block's only barrier

  // the lane's constants: its units' bias, a and inv_tau (the int8 substep:
  // and w_in's scales), and at H <= 32 its w_rec columns (the int8 substep:
  // dequantized here, so no multiply is left on the chain)
  std::conditional_t<Q, Int8Ltc<U>, F32Ltc<U>> cell;
  cell.H = H;
  cell.sub_dt = sub_dt;
  if constexpr (Q) {
    cell.win = reinterpret_cast<const int8_t*>(smem + L.win);
    cell.sig_tab = smem + L.sig;
    cell.n_seg = args.n_seg;
  } else {
    cell.win = smem + L.win;
  }
  float4 wr[U][REG ? N / 4 : 1];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    cell.bias[u] = smem[L.bias + un.col[u]];
    cell.a[u] = smem[L.a + un.col[u]];
    cell.itau[u] = smem[L.itau + un.col[u]];
    if constexpr (Q) cell.s_in[u] = smem[L.s_in + un.col[u]];
    if constexpr (REG) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int at = 4 * q * H + un.col[u];  // row-major: k = 4q .. 4q + 3
        if constexpr (Q)
          wr[u][q] = dequant4(rows4(reinterpret_cast<const int8_t*>(smem + L.wrec) + at, H),
                              smem[L.s_rec + un.col[u]]);
        else
          wr[u][q] = rows4(smem + L.wrec + at, H);
      }
    }
  }
  // column j of w_rec, k = 4q .. 4q + 3, from the column-major copy
  const float4* wrec4 = reinterpret_cast<const float4*>(smem + L.wrec);
  auto w_recc = [&](int q, int, int u) {
    if constexpr (REG) return wr[u][q];
    else return wrec4[un.col[u] * (S / 4) + q];
  };

  float* row_h = area + L.row_h;
  float* row_r = area + L.row_r;
  float* drvs = area + L.drv;
  const int nu = un.nu;
  int slot = 0;
  for (int w = warp; w < bb; w += n_warps) {
    const int window = b0 + w;
    __syncwarp();  // the previous window's head has read row_h
    float h[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h[u] = h_next[u];
      if (un.own[u]) row_h[un.col[u]] = h[u];
    }
    // the substeps ping-pong h between the warp's two rows: each reads one and
    // writes the other, so no lane overwrites a value another has yet to read
    float* row_in = row_h;
    float* row_out = row_r;
    for (int t0 = 0; t0 < T; t0 += kChunk) {
      const int nc = min(kChunk, T - t0);
      cp_async_wait<0>();
      __syncwarp();  // this chunk's x has arrived; row_in holds h
      // the chunk's drives x_t . W_in + bias, each lane for its own units:
      // over d for all kChunk steps at once (kChunk independent sums), then bias
      const float* xc = area + (slot ? L.xbuf[1] : L.xbuf[0]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nu) continue;
        float acc[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) acc[c] = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float wd = cell.win_at(d, u, un.col[u]);
#pragma unroll
          for (int c = 0; c < kChunk; ++c)  // past nc: unread
            acc[c] = fmaf(xc[c * D + d], wd, acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) drvs[(c * nu + u) * 32 + lane] = cell.drive(acc[c], u);
      }
      // the next chunk's x (or the next window's first) while this one runs
      if (t0 + kChunk < T) stage_chunk(slot ^ 1, window, t0 + kChunk);
      else if (w + n_warps < bb) {
        stage_chunk(slot ^ 1, window + n_warps, 0);
        load_h0(un, h_next, h0 + (size_t)(window + n_warps) * H);
      }
      cp_async_commit();
      slot ^= 1;

      for (int c = 0; c < nc; ++c) {
        float drive[U];
#pragma unroll
        for (int u = 0; u < U; ++u) drive[u] = u < nu ? drvs[(c * nu + u) * 32 + lane] : 0.0f;
        substeps<UNROLL>(n_substeps, [&](int) {
          float rec[1][U];
          matvec<N, 1, U>(row_in, H, nu, w_recc, rec);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (u >= nu) continue;
            h[u] = cell.step(h[u], drive[u], rec[0][u], u);
            if (un.own[u]) row_out[un.col[u]] = h[u];
          }
          __syncwarp();
          float* const read = row_in;
          row_in = row_out;
          row_out = read;
        });
      }
    }
    const auto hd = head_at(smem, L.head, Dh, K);
    warp_head<N, U>(un, h, H, hd, row_h, row_r, out + (size_t)window * K, act_int, act_frac);
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

// The slot axis of mr_step, gru_scan, mr_step_ltc and mr_step_node: S
// independent calls in one launch, grid (B / bb, S), one call S = 1. Block
// (x, s) runs slot s: each operand at its base plus s times its own slot
// stride in elements (0: one operand shared by every slot), the output at
// s times one call's output. The offset is taken in the __global__ entry, so
// the bodies run as for one call and a slot's bits are that call's.
constexpr int kMaxSlots = 65535;  // gridDim.y
template <int M>
struct SlotStrides {
  long long v[M];
};
template <class P>
__device__ __forceinline__ P* slot_at(P* p, long long stride) {
  return p + (long long)blockIdx.y * stride;
}

}  // namespace wc
}  // namespace repro
