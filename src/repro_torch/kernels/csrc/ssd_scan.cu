// Mamba2 chunked SSD scan: x [B,T,H,P], dt [B,T,H], A, D [H], B, C [B,T,G,N],
// an optional carried state [B,H,N,P] -> y [B,T,H,P] (x's dtype) and the
// final state [B,H,N,P] (float32).
//
// Replaces repro/kernels/ssd_scan/kernel.py:91 ssd_scan_pallas (body
// _ssd_chunk_kernel, :25-88). The TPU grid (B, H, chunks) ran the chunk axis
// in order with the [N, P] state in VMEM. Here the chunks run in parallel, as
// the plain ssd_chunked is written (kernels/ssd_scan/ref.py), in three
// kernels on one stream:
//   1. chunk states, a block per (chunk, head, sequence): cum = the inclusive
//      prefix sum of dt*A (in ssd_chunked's order), total = cum[L-1], and
//      S_c = sum_j B_j (x) (exp(total - cum_j) dt_j x_j), into scratch;
//   2. the state pass, a thread per (sequence, head, state element):
//      S_enter[0] = the carried state (or 0),
//      S_enter[c+1] = exp(total_c) S_enter[c] + S_c, written over S_c's
//      scratch (float32) or split into bf16 halves into a second scratch
//      (bf16), and the last one as the final state;
//   3. outputs, a block per (chunk, head, sequence):
//      y_i = exp(cum_i) C_i . S_enter                        (inter-chunk)
//          + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j (intra-chunk)
//          + D x_i,
//      rounded to x's dtype once. exp(cum_i - cum_j) is evaluated only where
//      j <= i: above the diagonal the exponent is positive and could overflow
//      (and inf * 0 is NaN).
// Everything is computed in float32 whatever the input dtype, as the Pallas
// kernel casts its operands (kernel.py:49-52).
//
// What bounds it on an H100: at the model's prefill shapes (L=128, N=128,
// P=64) a chunk is ~3.5 M multiply-adds against ~50 KB of input, so bytes
// (or, in float32, the FMA rate). The chunk grid gives B*H*chunks blocks (768
// for a prefill of 4 x 1,024 tokens); the sequential part is pass 2, N*P
// multiply-adds a chunk. The float32 chunk states make a round trip through
// device memory between the passes.
//
// bf16 operands: passes 1 and 3 run their products on the tensor cores
// (mma.sync.m16n8k16, mma.cuh), a warp per 16 rows, operands staged by
// cp.async into rows padded by 16 bytes (conflict-free ldmatrix). C . B^T is
// bf16 x bf16. The other three products have a float32 factor (w (.) x in
// S_c, the decayed scores in scores . x, S_enter in C . S_enter), which is
// split into hi + lo bf16 and run as two products into one float32
// accumulator: one bf16 rounding of it would put y outside one bf16 rounding
// of the float32 result and the state ~2.6e-3 of its largest value off.
// Ragged N and P (the JAX tests' 4..32) are zero-padded to 16 in shared memory.
//
// float32 operands stay on the FMA units (TF32 would miss the float32 bounds):
// a block's 256 threads form a 16 x 16 grid and each owns a register tile of
// every product (rows ty + 16a, columns tx + 16c), so every value it loads
// feeds 4 to 8 multiply-adds. C and B are staged transposed ([N][L]), the
// rows of B and of the score tile padded to L+1 floats, and the [L, L] score
// tile is built in row blocks (`rows`, ops.score_rows) to fit the carve.
#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro {

constexpr int SSD_THREADS = 256;  // float32 passes: a 16 x 16 grid
constexpr int SSD_MAX_A = 8;      // row groups of 16: L, N <= 128
constexpr int SSD_MAX_C = 4;      // column groups of 16: P <= 64
constexpr int SSD_MAX_B = 8;      // score column groups: L <= 128
constexpr int SSD_MAX_RA = 4;     // score row groups of a row block: rows <= 64
constexpr int SSD_STATE_WARPS = 8;  // bf16 pass 1: a warp per 16 rows of N <= 128
constexpr int SSD_PASS_THREADS = 256;
constexpr int SSD_PASS_BATCH = 8;  // chunks whose loads pass 2 keeps in flight together

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// The inclusive prefix sum of dt*A over the chunk in ssd_chunked's order, bit for
// bit: its torch.cumsum of dt * A is a sequential sum along that axis, each product
// and each sum rounded on its own. A blocked scan parts from it by a few ulps of
// |cum|, which exp(cum_i - cum_j) carries into every output: about twice the plain
// version's distance from float64 at zamba2's width, past 1e-3 of the logits after
// its 38 layers. Every thread forms products, then thread 0 adds them in order, 16
// loaded at a time so that only the 128 additions wait on each other. Every thread
// of the block calls it (it meets a barrier); L is a multiple of 16 (the launcher's
// check). The caller synchronises before reading cum.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a_h, float* cum, int L) {
  for (int k = threadIdx.x; k < L; k += blockDim.x) cum[k] = __fmul_rn(dts[k], a_h);
  __syncthreads();
  if (threadIdx.x != 0) return;
  float run = 0.0f;
  for (int k0 = 0; k0 < L; k0 += 16) {
    float p[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) p[k] = cum[k0 + k];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      run = __fadd_rn(run, p[k]);
      cum[k0 + k] = run;
    }
  }
}

// The chunk's dt (a column of [B, T, H]) into shared memory.
__device__ __forceinline__ void stage_dt(float* dts, const float* dt, int b, int t0, int T, int H,
                                         int h, int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) dts[i] = dt[((size_t)b * T + t0 + i) * H + h];
}

// ---------------------------------------------------------------------------
// pass 2: the state pass, shared by both dtypes
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SSD_PASS_THREADS)
    ssd_state_pass_kernel(float* chunk_states, const float* __restrict__ totals,
                          const float* __restrict__ init, bf16* __restrict__ split,
                          float* __restrict__ s_out, int NP, int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NP) return;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  float S = init ? init[bh * NP + e] : 0.0f;
  float* sc = chunk_states + bh * nc * NP + e;
  bf16* sp = split ? split + bh * nc * 2 * NP + e : nullptr;
  const float* tot = totals + bh * nc;
  for (int c0 = 0; c0 < nc; c0 += SSD_PASS_BATCH) {
    // the batch's loads first, so that they are in flight together
    float s_c[SSD_PASS_BATCH], decay[SSD_PASS_BATCH];
#pragma unroll
    for (int k = 0; k < SSD_PASS_BATCH; ++k) {
      const int c = c0 + k;
      s_c[k] = c < nc ? sc[(size_t)c * NP] : 0.0f;
      decay[k] = c < nc ? expf(tot[c]) : 1.0f;
    }
#pragma unroll
    for (int k = 0; k < SSD_PASS_BATCH; ++k) {
      const int c = c0 + k;
      if (c >= nc) break;
      if (sp) {  // bf16: S_enter[c] split into hi and lo for the tensor cores
        const bf16 hi = __float2bfloat16(S);
        sp[(size_t)c * 2 * NP] = hi;
        sp[(size_t)c * 2 * NP + NP] = __float2bfloat16(S - __bfloat162float(hi));
      } else {  // float32: S_enter[c] in place of S_c
        sc[(size_t)c * NP] = S;
      }
      S = decay[k] * S + s_c[k];
    }
  }
  s_out[bh * NP + e] = S;
}

// ---------------------------------------------------------------------------
// bf16: passes 1 and 3 on the tensor cores
// ---------------------------------------------------------------------------
struct SsdTcCarve {
  int NP, PP, LDN, LDP;  // padded widths and row strides (bf16 elements)
  __host__ __device__ SsdTcCarve(int N, int P)
      : NP(round16(N)), PP(round16(P)), LDN(round16(N) + 8), LDP(round16(P) + 8) {}
  // pass 1: B [L][LDN], x, then (w x)_hi in its place, and (w x)_lo [L][LDP];
  // dt, cum, w [L]
  __host__ __device__ size_t state_bytes(int L) const {
    return 2 * ((size_t)L * LDN + 2 * (size_t)L * LDP) + 4 * 3 * (size_t)L;
  }
  // pass 3: first C [L][LDN] and S_enter hi and lo [NP][LDP], then B [L][LDN]
  // and x [L][LDP] in the same region; dt, cum [L]
  __host__ __device__ size_t out_region_bytes(int L) const {
    const size_t first = (size_t)L * LDN + 2 * (size_t)NP * LDP;
    const size_t second = (size_t)L * LDN + (size_t)L * LDP;
    return 2 * (first > second ? first : second);
  }
  __host__ __device__ size_t out_bytes(int L) const { return out_region_bytes(L) + 4 * 2 * (size_t)L; }
};

template <bool FULL>  // FULL: the model's prefill shape (L = 128, N = 128, P = 64), unguarded
__global__ void __launch_bounds__(32 * SSD_STATE_WARPS)
    ssd_chunk_state_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                                const float* __restrict__ A, const bf16* __restrict__ bm,
                                float* __restrict__ chunk_states, float* __restrict__ totals,
                                int T, int H, int P, int G, int N, int L, int vec_n,
                                int vec_p) {
  const SsdTcCarve cv(N, P);
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* bs = reinterpret_cast<bf16*>(ssd_smem);  // [L][LDN] the chunk's B
  bf16* wx_hi = bs + L * cv.LDN;                 // [L][LDP] the chunk's x, then (w x)_hi
  bf16* wx_lo = wx_hi + L * cv.LDP;              // [L][LDP]
  float* dts = reinterpret_cast<float*>(wx_lo + L * cv.LDP);
  float* cum = dts + L;
  float* w = cum + L;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x, t0 = c * L;
  const int g = h * G / H;  // the group of head h (kernel.py:116-117)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, qg = lane >> 2, qt = lane & 3;
  const int KB = FULL ? 8 : L / 16, PB2 = FULL ? 4 : cv.PP / 16;

  // two groups of copies: x, which w (.) x needs first, then B
  stage_rows_bf16(wx_hi, cv.LDP, x + (((size_t)b * T + t0) * H + h) * P, (size_t)H * P, L, L, P,
                  cv.PP, vec_p);
  cp_async_commit();
  stage_rows_bf16(bs, cv.LDN, bm + (((size_t)b * T + t0) * G + g) * N, (size_t)G * N, L, L, N,
                  cv.NP, vec_n);
  cp_async_commit();
  stage_dt(dts, dt, b, t0, T, H, h, L);
  __syncthreads();
  chunk_cumsum(dts, A[h], cum, L);
  __syncthreads();
  const float total = cum[L - 1];
  for (int j = threadIdx.x; j < L; j += blockDim.x) w[j] = expf(total - cum[j]) * dts[j];
  cp_async_wait<1>();
  __syncthreads();
  // w (.) x, split; each element is read and overwritten by one thread
  for (int j = warp; j < L; j += SSD_STATE_WARPS) {
    for (int p = lane; p < cv.PP; p += 32) {
      const float f = w[j] * __bfloat162float(wx_hi[j * cv.LDP + p]);
      const bf16 hi = __float2bfloat16(f);
      wx_hi[j * cv.LDP + p] = hi;
      wx_lo[j * cv.LDP + p] = __float2bfloat16(f - __bfloat162float(hi));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // S_c [n][p] = sum_j B[j][n] (w x)[j][p]: warp w owns rows n0 .. n0 + 15
  const int n0 = 16 * warp;
  if (n0 < cv.NP) {
    float acc[8][4];
#pragma unroll
    for (int pb = 0; pb < 8; ++pb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk >= KB) break;
      uint32_t af[4];
      ldmatrix_x4_trans(af, bs + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * cv.LDN + n0 +
                                (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int pb2 = 0; pb2 < 4; ++pb2) {
        if (pb2 >= PB2) break;
        const int off = (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * cv.LDP + 16 * pb2 +
                        ((lane >> 4) << 3);
        uint32_t fh[4], fl[4];
        ldmatrix_x4_trans(fh, wx_hi + off);
        ldmatrix_x4_trans(fl, wx_lo + off);
        mma_bf16(acc[2 * pb2], af, fh[0], fh[1]);
        mma_bf16(acc[2 * pb2 + 1], af, fh[2], fh[3]);
        mma_bf16(acc[2 * pb2], af, fl[0], fl[1]);
        mma_bf16(acc[2 * pb2 + 1], af, fl[2], fl[3]);
      }
    }
    float* out = chunk_states + (((size_t)b * H + h) * nc + c) * N * P;
#pragma unroll
    for (int pb = 0; pb < 8; ++pb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + qg + 8 * r, p = 8 * pb + 2 * qt;
        if (n >= N || p >= P) continue;
        if (P % 2 == 0) {  // (p, p + 1) both in, 8-byte aligned
          *reinterpret_cast<float2*>(out + n * P + p) = make_float2(acc[pb][2 * r], acc[pb][2 * r + 1]);
        } else {
          out[n * P + p] = acc[pb][2 * r];
          if (p + 1 < P) out[n * P + p + 1] = acc[pb][2 * r + 1];
        }
      }
    }
  }
  if (threadIdx.x == 0) totals[((size_t)b * H + h) * nc + c] = total;
}

template <bool FULL>  // FULL: the model's prefill shape (L = 128, N = 128, P = 64), unguarded
__global__ void __launch_bounds__(256, 2)
    ssd_chunk_out_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                              const float* __restrict__ A, const bf16* __restrict__ bm,
                              const bf16* __restrict__ cm, const float* __restrict__ Dskip,
                              const bf16* __restrict__ s_split, bf16* __restrict__ y, int T,
                              int H, int P, int G, int N, int L, int vec_n, int vec_p) {
  const SsdTcCarve cv(N, P);
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  // first C [L][LDN] and S_enter's halves [NP][LDP]; once C's fragments are in
  // registers and the inter-chunk product is done, B [L][LDN] and x [L][LDP]
  bf16* cs = reinterpret_cast<bf16*>(ssd_smem);
  bf16* s_hi = cs + L * cv.LDN;
  bf16* s_lo = s_hi + cv.NP * cv.LDP;
  bf16* bs = cs;
  bf16* xs = bs + L * cv.LDN;
  float* dts = reinterpret_cast<float*>(ssd_smem + cv.out_region_bytes(L));
  float* cum = dts + L;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x, t0 = c * L;
  const int g = h * G / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, qg = lane >> 2, qt = lane & 3;
  const int KB = FULL ? 8 : cv.NP / 16, PB2 = FULL ? 4 : cv.PP / 16;

  const size_t bc_row0 = (((size_t)b * T + t0) * G + g) * N;
  stage_rows_bf16(cs, cv.LDN, cm + bc_row0, (size_t)G * N, L, L, N, cv.NP, vec_n);
  const bf16* sp = s_split + (((size_t)b * H + h) * nc + c) * 2 * N * P;
  stage_rows_bf16(s_hi, cv.LDP, sp, P, cv.NP, N, P, cv.PP, vec_p);
  stage_rows_bf16(s_lo, cv.LDP, sp + (size_t)N * P, P, cv.NP, N, P, cv.PP, vec_p);
  cp_async_commit();
  stage_dt(dts, dt, b, t0, T, H, h, L);
  __syncthreads();
  chunk_cumsum(dts, A[h], cum, L);
  cp_async_wait<0>();
  __syncthreads();

  // warp w owns rows i0 .. i0 + 15 and needs keys j < i0 + 16 (pairs jp <= w)
  const int i0 = 16 * warp;
  const int rows_i[2] = {i0 + qg, i0 + qg + 8};
  const float cum_i[2] = {cum[rows_i[0]], cum[rows_i[1]]};
  uint32_t cf[8][4];  // C_i's fragments, 16 columns of N each
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk < KB) ldmatrix_x4(cf[kk], cs + (i0 + (lane & 15)) * cv.LDN + 16 * kk + ((lane >> 4) << 3));
  // -- inter-chunk: exp(cum_i) C_i . S_enter, S_enter split ----------------------
  float ya[8][4];
#pragma unroll
  for (int pb = 0; pb < 8; ++pb)
#pragma unroll
    for (int e = 0; e < 4; ++e) ya[pb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk >= KB) break;
#pragma unroll
    for (int pb2 = 0; pb2 < 4; ++pb2) {
      if (pb2 >= PB2) break;
      const int off = (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * cv.LDP + 16 * pb2 +
                      ((lane >> 4) << 3);
      uint32_t fh[4], fl[4];
      ldmatrix_x4_trans(fh, s_hi + off);
      ldmatrix_x4_trans(fl, s_lo + off);
      mma_bf16(ya[2 * pb2], cf[kk], fh[0], fh[1]);
      mma_bf16(ya[2 * pb2 + 1], cf[kk], fh[2], fh[3]);
      mma_bf16(ya[2 * pb2], cf[kk], fl[0], fl[1]);
      mma_bf16(ya[2 * pb2 + 1], cf[kk], fl[2], fl[3]);
    }
  }
  {
    const float e_i[2] = {expf(cum_i[0]), expf(cum_i[1])};
#pragma unroll
    for (int pb = 0; pb < 8; ++pb)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[pb][e] *= e_i[e >> 1];
  }
  __syncthreads();  // every warp is done with C and S_enter: B and x take their place
  stage_rows_bf16(bs, cv.LDN, bm + bc_row0, (size_t)G * N, L, L, N, cv.NP, vec_n);
  stage_rows_bf16(xs, cv.LDP, x + (((size_t)b * T + t0) * H + h) * P, (size_t)H * P, L, L, P,
                  cv.PP, vec_p);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // -- intra-chunk, 16 keys at a time: scores = C_i . B_j (bf16 x bf16), the
  // decay and dt below the diagonal only, then += scores . x, the scores split
  for (int jp = 0; jp <= warp; ++jp) {
    float s2[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 4; ++e) s2[half][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk >= KB) break;
      uint32_t bf[4];
      ldmatrix_x4(bf, bs + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * cv.LDN + 16 * kk +
                          (((lane >> 3) & 1) << 3));
      mma_bf16(s2[0], cf[kk], bf[0], bf[1]);
      mma_bf16(s2[1], cf[kk], bf[2], bf[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = 16 * jp + 8 * half + 2 * qt + (e & 1);
        float v = 0.0f;
        if (j <= rows_i[r]) {
          v = s2[half][e] * expf(cum_i[r] - cum[j]);
          v *= dts[j];
        }
        s2[half][e] = v;
      }
    }
    uint32_t a_hi[4], a_lo[4];
    split_a(s2[0], s2[1], a_hi, a_lo);
#pragma unroll
    for (int pb2 = 0; pb2 < 4; ++pb2) {
      if (pb2 >= PB2) break;
      uint32_t xf[4];
      ldmatrix_x4_trans(xf, xs + (16 * jp + (lane & 7) + (((lane >> 3) & 1) << 3)) * cv.LDP +
                                16 * pb2 + ((lane >> 4) << 3));
      mma_bf16(ya[2 * pb2], a_hi, xf[0], xf[1]);
      mma_bf16(ya[2 * pb2 + 1], a_hi, xf[2], xf[3]);
      mma_bf16(ya[2 * pb2], a_lo, xf[0], xf[1]);
      mma_bf16(ya[2 * pb2 + 1], a_lo, xf[2], xf[3]);
    }
  }
  // -- y = inter + intra + D x, in bf16 ---------------------------------------------
  const float d_h = Dskip[h];
#pragma unroll
  for (int pb = 0; pb < 8; ++pb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rows_i[r], p = 8 * pb + 2 * qt;
      if (p >= P) continue;
      const float y0 = ya[pb][2 * r] + d_h * __bfloat162float(xs[i * cv.LDP + p]);
      const float y1 = ya[pb][2 * r + 1] + d_h * __bfloat162float(xs[i * cv.LDP + p + 1]);
      bf16* out = y + (((size_t)b * T + t0 + i) * H + h) * P + p;
      if (P % 2 == 0) {  // (p, p + 1) both in, 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y0, y1);
      } else {
        out[0] = __float2bfloat16(y0);
        if (p + 1 < P) out[1] = __float2bfloat16(y1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: passes 1 and 3 on the FMA units
// ---------------------------------------------------------------------------
inline size_t ssd_state_f32_floats(int L, int N, int P) {
  // x [L][P], B^T [N][L+1], dt, cum, w [L]
  return (size_t)L * P + (size_t)N * (L + 1) + 3 * (size_t)L;
}

inline size_t ssd_out_f32_floats(int L, int N, int P, int rows) {
  // S_enter [N][P], x [L][P], B^T [N][L+1], C^T [N][L], dt, cum [L], scores [rows][L+1]
  return (size_t)N * P + (size_t)L * P + (size_t)N * (L + 1) + (size_t)N * L + 2 * (size_t)L +
         (size_t)rows * (L + 1);
}

__global__ void __launch_bounds__(SSD_THREADS)
    ssd_chunk_state_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                               const float* __restrict__ A, const float* __restrict__ bm,
                               float* __restrict__ chunk_states, float* __restrict__ totals, int T,
                               int H, int P, int G, int N, int L) {
  extern __shared__ float smem[];
  const int LB = L + 1;
  float* xs = smem;            // [L][P]
  float* bt = xs + L * P;      // [N][LB] B, transposed
  float* dts = bt + N * LB;    // [L]
  float* cum = dts + L;        // [L]
  float* w = cum + L;          // [L] exp(total - cum) * dt

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x, t0 = c * L;
  const int g = h * G / H;
  const int NG = (N + 15) >> 4;

  for (int e = tid; e < L * P; e += SSD_THREADS) {
    const int i = e / P, p = e - i * P;
    xs[e] = x[(((size_t)b * T + t0 + i) * H + h) * P + p];
  }
  for (int e = tid; e < L * N; e += SSD_THREADS) {
    const int i = e / N, n = e - i * N;
    bt[n * LB + i] = bm[(((size_t)b * T + t0 + i) * G + g) * N + n];
  }
  stage_dt(dts, dt, b, t0, T, H, h, L);
  __syncthreads();
  chunk_cumsum(dts, A[h], cum, L);
  __syncthreads();
  const float total = cum[L - 1];
  for (int j = tid; j < L; j += SSD_THREADS) w[j] = expf(total - cum[j]) * dts[j];
  __syncthreads();
  for (int e = tid; e < N * L; e += SSD_THREADS) {
    const int n = e / L, j = e - n * L;
    bt[n * LB + j] *= w[j];
  }
  __syncthreads();

  // S_c = sum_j (B_j w_j) (x) x_j: rows n = ty + 16a, columns p = tx + 16c
  float sacc[SSD_MAX_A][SSD_MAX_C];
#pragma unroll
  for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) sacc[a][cc] = 0.0f;
  for (int j = 0; j < L; ++j) {
    float bv[SSD_MAX_A], xv[SSD_MAX_C];
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a)
      bv[a] = a < NG && ty + 16 * a < N ? bt[(ty + 16 * a) * LB + j] : 0.0f;
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) xv[cc] = tx + 16 * cc < P ? xs[j * P + tx + 16 * cc] : 0.0f;
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
      for (int cc = 0; cc < SSD_MAX_C; ++cc) sacc[a][cc] += bv[a] * xv[cc];
  }
  float* out = chunk_states + (((size_t)b * H + h) * nc + c) * N * P;
#pragma unroll
  for (int a = 0; a < SSD_MAX_A; ++a) {
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) {
      const int n = ty + 16 * a, p = tx + 16 * cc;
      if (a < NG && n < N && p < P) out[n * P + p] = sacc[a][cc];
    }
  }
  if (tid == 0) totals[((size_t)b * H + h) * nc + c] = total;
}

__global__ void __launch_bounds__(SSD_THREADS)
    ssd_chunk_out_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                             const float* __restrict__ A, const float* __restrict__ bm,
                             const float* __restrict__ cm, const float* __restrict__ Dskip,
                             const float* __restrict__ s_enter, float* __restrict__ y, int T,
                             int H, int P, int G, int N, int L, int rows) {
  extern __shared__ float smem[];
  const int LB = L + 1;          // padded row of B^T and of the score tile
  float* S = smem;               // [N][P] S_enter
  float* xs = S + N * P;         // [L][P] the chunk's x
  float* bt = xs + L * P;        // [N][LB] the chunk's B, transposed
  float* ct = bt + N * LB;       // [N][L] the chunk's C, transposed
  float* dts = ct + N * L;       // [L]
  float* cum = dts + L;          // [L] inclusive prefix sum of dt*A
  float* sc = cum + L;           // [rows][LB] a row block of the score tile

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x, t0 = c * L;
  const int g = h * G / H;
  const float d_h = Dskip[h];
  const int LG = L >> 4, RG = rows >> 4;  // row groups

  const float* se = s_enter + (((size_t)b * H + h) * nc + c) * N * P;
  for (int e = tid; e < N * P; e += SSD_THREADS) S[e] = se[e];
  for (int e = tid; e < L * P; e += SSD_THREADS) {
    const int i = e / P, p = e - i * P;
    xs[e] = x[(((size_t)b * T + t0 + i) * H + h) * P + p];
  }
  for (int e = tid; e < L * N; e += SSD_THREADS) {
    const int i = e / N, n = e - i * N;
    const size_t src = (((size_t)b * T + t0 + i) * G + g) * N + n;
    ct[n * L + i] = cm[src];
    bt[n * LB + i] = bm[src];
  }
  stage_dt(dts, dt, b, t0, T, H, h, L);
  __syncthreads();
  chunk_cumsum(dts, A[h], cum, L);
  __syncthreads();

  // -- inter-chunk: acc[a][c] = exp(cum_i) * C_i . S_enter[:, p] ---------------
  // (row i = ty + 16a of the chunk, column p = tx + 16c)
  float acc[SSD_MAX_A][SSD_MAX_C];
#pragma unroll
  for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) acc[a][cc] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float cv[SSD_MAX_A], sv[SSD_MAX_C];
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a) cv[a] = a < LG ? ct[n * L + ty + 16 * a] : 0.0f;
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) sv[cc] = tx + 16 * cc < P ? S[n * P + tx + 16 * cc] : 0.0f;
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
      for (int cc = 0; cc < SSD_MAX_C; ++cc) acc[a][cc] += cv[a] * sv[cc];
  }
#pragma unroll
  for (int a = 0; a < SSD_MAX_A; ++a) {
    if (a < LG) {
      const float e = expf(cum[ty + 16 * a]);
#pragma unroll
      for (int cc = 0; cc < SSD_MAX_C; ++cc) acc[a][cc] *= e;
    }
  }

  // -- intra-chunk, one block of score rows at a time ---------------------------
  // summed apart from the inter-chunk term and added to it at the end, as
  // ssd_chunked adds y_intra + y_inter
  float intra[SSD_MAX_A][SSD_MAX_C];
#pragma unroll
  for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) intra[a][cc] = 0.0f;
  for (int r0 = 0; r0 < L; r0 += rows) {
    const int jn = r0 + rows;  // the block's rows see keys j < jn only
    __syncthreads();           // the previous row block's readers are done with sc
    {
      float s[SSD_MAX_RA][SSD_MAX_B];
#pragma unroll
      for (int a = 0; a < SSD_MAX_RA; ++a)
#pragma unroll
        for (int q = 0; q < SSD_MAX_B; ++q) s[a][q] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[SSD_MAX_RA], bv[SSD_MAX_B];
#pragma unroll
        for (int a = 0; a < SSD_MAX_RA; ++a) cv[a] = a < RG ? ct[n * L + r0 + ty + 16 * a] : 0.0f;
#pragma unroll
        for (int q = 0; q < SSD_MAX_B; ++q) bv[q] = 16 * q < jn ? bt[n * LB + tx + 16 * q] : 0.0f;
#pragma unroll
        for (int a = 0; a < SSD_MAX_RA; ++a)
#pragma unroll
          for (int q = 0; q < SSD_MAX_B; ++q) s[a][q] += cv[a] * bv[q];
      }
#pragma unroll
      for (int a = 0; a < SSD_MAX_RA; ++a) {
#pragma unroll
        for (int q = 0; q < SSD_MAX_B; ++q) {
          const int ii = ty + 16 * a, i = r0 + ii, j = tx + 16 * q;
          if (a < RG && 16 * q < jn) {
            float v = 0.0f;
            if (j <= i) {
              v = s[a][q] * expf(cum[i] - cum[j]);
              v *= dts[j];
            }
            sc[ii * LB + j] = v;
          }
        }
      }
    }
    __syncthreads();
    const int a0 = r0 >> 4;  // this block's rows are the thread's groups a0 .. a0+RG-1
    for (int j = 0; j < jn; ++j) {
      float xv[SSD_MAX_C];
#pragma unroll
      for (int cc = 0; cc < SSD_MAX_C; ++cc) xv[cc] = tx + 16 * cc < P ? xs[j * P + tx + 16 * cc] : 0.0f;
#pragma unroll
      for (int a = 0; a < SSD_MAX_A; ++a) {
        if (a >= a0 && a < a0 + RG) {
          const float sv = sc[(ty + 16 * (a - a0)) * LB + j];
#pragma unroll
          for (int cc = 0; cc < SSD_MAX_C; ++cc) intra[a][cc] += sv * xv[cc];
        }
      }
    }
  }

  // -- y = (intra + inter) + D * x -----------------------------------------------
#pragma unroll
  for (int a = 0; a < SSD_MAX_A; ++a) {
#pragma unroll
    for (int cc = 0; cc < SSD_MAX_C; ++cc) {
      const int i = ty + 16 * a, p = tx + 16 * cc;
      if (a < LG && p < P)
        y[(((size_t)b * T + t0 + i) * H + h) * P + p] = (intra[a][cc] + acc[a][cc]) + d_h * xs[i * P + p];
    }
  }
}

}  // namespace repro

extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* bm,
                               const void* cm, const float* D, const float* init, void* y,
                               float* s_out, float* chunk_states, float* totals, void* s_split,
                               int B, int T,
                               int H, int P, int G, int N, int L, int rows, int is_bf16,
                               void* stream) {
  using namespace repro;
  if (B < 1 || B > 65535 || H > 65535 || L < 16 || L % 16 != 0 || L > 16 * SSD_MAX_B ||
      T < L || T % L != 0 || rows < 16 || rows % 16 != 0 || rows > 16 * SSD_MAX_RA ||
      L % rows != 0 || G < 1 || H % G != 0 || P < 1 || P > 16 * SSD_MAX_C || N < 1 ||
      N > 16 * SSD_MAX_A)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = T / L;
  const dim3 chunks(nc, H, B);
  cudaError_t err;
  if (is_bf16) {
    const SsdTcCarve cv(N, P);
    const size_t smem1 = cv.state_bytes(L), smem3 = cv.out_bytes(L);
    const bool full = L == 128 && N == 128 && P == 64;
    if ((err = allow_shared(ssd_chunk_state_bf16_kernel<true>, smem1)) != cudaSuccess) return (int)err;
    if ((err = allow_shared(ssd_chunk_state_bf16_kernel<false>, smem1)) != cudaSuccess) return (int)err;
    if ((err = allow_shared(ssd_chunk_out_bf16_kernel<true>, smem3)) != cudaSuccess) return (int)err;
    if ((err = allow_shared(ssd_chunk_out_bf16_kernel<false>, smem3)) != cudaSuccess) return (int)err;
    const int vec_n = N % 8 == 0 && aligned16(bm) && aligned16(cm);
    const int vec_p = P % 8 == 0 && aligned16(x) && aligned16(s_split);
    if (full)
      ssd_chunk_state_bf16_kernel<true><<<chunks, 32 * SSD_STATE_WARPS, smem1, s>>>((const bf16*)x,
          dt, A, (const bf16*)bm, chunk_states, totals, T, H, P, G, N, L, vec_n, vec_p);
    else
      ssd_chunk_state_bf16_kernel<false><<<chunks, 32 * SSD_STATE_WARPS, smem1, s>>>((const bf16*)x,
          dt, A, (const bf16*)bm, chunk_states, totals, T, H, P, G, N, L, vec_n, vec_p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 pass((N * P + SSD_PASS_THREADS - 1) / SSD_PASS_THREADS, H, B);
    ssd_state_pass_kernel<<<pass, SSD_PASS_THREADS, 0, s>>>(chunk_states, totals, init,
                                                            (bf16*)s_split, s_out, N * P, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (full)
      ssd_chunk_out_bf16_kernel<true><<<chunks, 2 * L, smem3, s>>>((const bf16*)x, dt, A,
          (const bf16*)bm, (const bf16*)cm, D, (const bf16*)s_split, (bf16*)y, T, H, P, G, N, L,
          vec_n, vec_p);
    else
      ssd_chunk_out_bf16_kernel<false><<<chunks, 2 * L, smem3, s>>>((const bf16*)x, dt, A,
          (const bf16*)bm, (const bf16*)cm, D, (const bf16*)s_split, (bf16*)y, T, H, P, G, N, L,
          vec_n, vec_p);
    return (int)cudaGetLastError();
  }
  const size_t smem1 = ssd_state_f32_floats(L, N, P) * sizeof(float);
  const size_t smem3 = ssd_out_f32_floats(L, N, P, rows) * sizeof(float);
  if ((err = allow_shared(ssd_chunk_state_f32_kernel, smem1)) != cudaSuccess) return (int)err;
  if ((err = allow_shared(ssd_chunk_out_f32_kernel, smem3)) != cudaSuccess) return (int)err;
  ssd_chunk_state_f32_kernel<<<chunks, SSD_THREADS, smem1, s>>>((const float*)x, dt, A,
      (const float*)bm, chunk_states, totals, T, H, P, G, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 pass((N * P + SSD_PASS_THREADS - 1) / SSD_PASS_THREADS, H, B);
  ssd_state_pass_kernel<<<pass, SSD_PASS_THREADS, 0, s>>>(chunk_states, totals, init, nullptr,
                                                          s_out, N * P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_out_f32_kernel<<<chunks, SSD_THREADS, smem3, s>>>((const float*)x, dt, A,
      (const float*)bm, (const float*)cm, D, chunk_states, (float*)y, T, H, P, G, N, L, rows);
  return (int)cudaGetLastError();
}
