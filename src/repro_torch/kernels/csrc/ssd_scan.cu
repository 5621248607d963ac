// Mamba2 chunked SSD scan: x [B,T,H,P], dt [B,T,H], A, D [H], B, C [B,T,G,N]
// -> y [B,T,H,P] (x's dtype) and the final state [B,H,N,P] (float32).
//
// Replaces repro/kernels/ssd_scan/kernel.py:91 ssd_scan_pallas (body
// _ssd_chunk_kernel, :25-88). The TPU grid (B, H, chunks) ran the chunk axis
// in order with the [N, P] state in VMEM; here one block per (sequence, head)
// walks the chunks in a loop with the state resident in shared memory, so
// the state never leaves the SM. Per chunk of L steps, as the Pallas body:
//   cum = inclusive prefix sum of dt*A (a warp scan in place of the TPU's
//         triangular-ones product), total = cum[L-1];
//   y   = exp(cum_i) * C_i . S_in                         (inter-chunk)
//       + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j (intra-chunk)
//       + D * x;
//   S   = exp(total) * S_in + sum_j (B_j exp(total - cum_j) dt_j) (x) x_j.
// Everything is computed in float32 whatever the input dtype, as the Pallas
// kernel casts its operands (kernel.py:49-52); y is rounded to x's dtype
// once, at the end. exp(cum_i - cum_j) is evaluated only where j <= i: above
// the diagonal the exponent is positive and could overflow.
//
// What bounds it on an H100: at the model's prefill shapes (L=128, N=128,
// P=64) a chunk is ~3.5 M multiply-adds against ~50 KB of input, so the card
// could finish on its bytes (or on the bf16 tensor cores); this kernel runs
// the products on the float32 cores from shared memory and fills B*H blocks
// (96 for a 4-prompt prefill, 24 for one) of 132 SMs, so it is bound by its
// shared-memory loads, the float32 rate and the empty SMs. Against the loads,
// the block's 256 threads form a 16 x 16 grid and each owns a register tile
// of every product (rows ty + 16a, columns tx + 16c): a thread loads a row
// vector and a column vector per step of a sum and does their outer product,
// so every value it loads feeds 4 to 8 multiply-adds. C and B are staged
// transposed ([N][L]) so that those vectors are contiguous across the grid,
// and the rows of B and of the score tile are padded to L+1 floats so that
// the two rows a warp reads fall in different banks. At L=128, N=128, P=64
// the float32 carve leaves room for 64 of the [L, L] score tile's rows, so
// the tile is built in row blocks (`rows`, chosen by ops.score_rows).
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro {

constexpr int SSD_THREADS = 256;  // a 16 x 16 grid
constexpr int SSD_MAX_A = 8;      // row groups of 16: L, N <= 128
constexpr int SSD_MAX_C = 4;      // column groups of 16: P <= 64
constexpr int SSD_MAX_B = 8;      // score column groups: L <= 128
constexpr int SSD_MAX_RA = 4;     // score row groups of a row block: rows <= 64

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

inline size_t ssd_shared_floats(int L, int N, int P, int rows) {
  // S [N][P], x [L][P], B^T [N][L+1], C^T [N][L], dt, cum, w [L], scores [rows][L+1]
  return (size_t)N * P + (size_t)L * P + (size_t)N * (L + 1) + (size_t)N * L + 3 * (size_t)L +
         (size_t)rows * (L + 1);
}

template <typename Elem>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_scan_kernel(const Elem* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const Elem* __restrict__ bm,
                    const Elem* __restrict__ cm, const float* __restrict__ Dskip,
                    Elem* __restrict__ y, float* __restrict__ s_out, int T_len, int H, int P, int G,
                    int N, int L, int rows) {
  extern __shared__ float smem[];
  const int LB = L + 1;          // padded row of B^T and of the score tile
  float* S = smem;               // [N][P] the resident state
  float* xs = S + N * P;         // [L][P] the chunk's x
  float* bt = xs + L * P;        // [N][LB] the chunk's B, transposed
  float* ct = bt + N * LB;       // [N][L] the chunk's C, transposed
  float* dts = ct + N * L;       // [L]
  float* cum = dts + L;          // [L] inclusive prefix sum of dt*A
  float* w = cum + L;            // [L] exp(total - cum) * dt
  float* sc = w + L;             // [rows][LB] a row block of the score tile

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h * G / H;  // the group of head h (kernel.py:116-117)
  const float a_h = A[h], d_h = Dskip[h];
  const int LG = L >> 4, NG = (N + 15) >> 4, RG = rows >> 4;  // row groups

  for (int e = tid; e < N * P; e += SSD_THREADS) S[e] = 0.0f;

  for (int t0 = 0; t0 < T_len; t0 += L) {
    // -- stage the chunk ------------------------------------------------------
    for (int e = tid; e < L * P; e += SSD_THREADS) {
      const int i = e / P, p = e - i * P;
      xs[e] = to_f32(x[(((size_t)b * T_len + t0 + i) * H + h) * P + p]);
    }
    for (int e = tid; e < L * N; e += SSD_THREADS) {
      const int i = e / N, n = e - i * N;
      const size_t src = (((size_t)b * T_len + t0 + i) * G + g) * N + n;
      ct[n * L + i] = to_f32(cm[src]);
      bt[n * LB + i] = to_f32(bm[src]);
    }
    for (int i = tid; i < L; i += SSD_THREADS) dts[i] = dt[((size_t)b * T_len + t0 + i) * H + h];
    __syncthreads();

    // -- cum: each lane of warp 0 sums a run of ceil(L/32) steps, then a
    // warp scan adds the runs before it --------------------------------------
    if (tid < 32) {
      const int per = (L + 31) / 32, lo = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per && lo + k < L; ++k) {
        run += dts[lo + k] * a_h;
        cum[lo + k] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.0f;
      for (int k = 0; k < per && lo + k < L; ++k) cum[lo + k] += before;
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int j = tid; j < L; j += SSD_THREADS) w[j] = expf(total - cum[j]) * dts[j];

    // -- inter-chunk: acc[a][c] = exp(cum_i) * C_i . S_in[:, p] ----------------
    // (row i = ty + 16a of the chunk, column p = tx + 16c)
    float acc[SSD_MAX_A][SSD_MAX_C];
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
      for (int c = 0; c < SSD_MAX_C; ++c) acc[a][c] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[SSD_MAX_A], sv[SSD_MAX_C];
#pragma unroll
      for (int a = 0; a < SSD_MAX_A; ++a) cv[a] = a < LG ? ct[n * L + ty + 16 * a] : 0.0f;
#pragma unroll
      for (int c = 0; c < SSD_MAX_C; ++c) sv[c] = tx + 16 * c < P ? S[n * P + tx + 16 * c] : 0.0f;
#pragma unroll
      for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
        for (int c = 0; c < SSD_MAX_C; ++c) acc[a][c] += cv[a] * sv[c];
    }
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a) {
      if (a < LG) {
        const float e = expf(cum[ty + 16 * a]);
#pragma unroll
        for (int c = 0; c < SSD_MAX_C; ++c) acc[a][c] *= e;
      }
    }

    // -- intra-chunk, one block of score rows at a time -----------------------
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
        for (int c = 0; c < SSD_MAX_C; ++c) xv[c] = tx + 16 * c < P ? xs[j * P + tx + 16 * c] : 0.0f;
#pragma unroll
        for (int a = 0; a < SSD_MAX_A; ++a) {
          if (a >= a0 && a < a0 + RG) {
            const float sv = sc[(ty + 16 * (a - a0)) * LB + j];
#pragma unroll
            for (int c = 0; c < SSD_MAX_C; ++c) acc[a][c] += sv * xv[c];
          }
        }
      }
    }
    __syncthreads();  // every read of S_in, of the raw B and of w's writers is done

    // -- the state: S = exp(total) * S_in + sum_j (B_j w_j) (x) x_j ----------
    for (int e = tid; e < N * L; e += SSD_THREADS) {
      const int n = e / L, j = e - n * L;
      bt[n * LB + j] *= w[j];
    }
    __syncthreads();
    {
      const float decay = expf(total);
      float sacc[SSD_MAX_A][SSD_MAX_C];
#pragma unroll
      for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
        for (int c = 0; c < SSD_MAX_C; ++c) sacc[a][c] = 0.0f;
      for (int j = 0; j < L; ++j) {
        float bv[SSD_MAX_A], xv[SSD_MAX_C];
#pragma unroll
        for (int a = 0; a < SSD_MAX_A; ++a)
          bv[a] = a < NG && ty + 16 * a < N ? bt[(ty + 16 * a) * LB + j] : 0.0f;
#pragma unroll
        for (int c = 0; c < SSD_MAX_C; ++c) xv[c] = tx + 16 * c < P ? xs[j * P + tx + 16 * c] : 0.0f;
#pragma unroll
        for (int a = 0; a < SSD_MAX_A; ++a)
#pragma unroll
          for (int c = 0; c < SSD_MAX_C; ++c) sacc[a][c] += bv[a] * xv[c];
      }
#pragma unroll
      for (int a = 0; a < SSD_MAX_A; ++a) {
#pragma unroll
        for (int c = 0; c < SSD_MAX_C; ++c) {
          const int n = ty + 16 * a, p = tx + 16 * c;
          if (a < NG && n < N && p < P) S[n * P + p] = decay * S[n * P + p] + sacc[a][c];
        }
      }
    }

    // -- y = inter + intra + D * x, in x's dtype ------------------------------
#pragma unroll
    for (int a = 0; a < SSD_MAX_A; ++a) {
#pragma unroll
      for (int c = 0; c < SSD_MAX_C; ++c) {
        const int i = ty + 16 * a, p = tx + 16 * c;
        if (a < LG && p < P)
          store(y + (((size_t)b * T_len + t0 + i) * H + h) * P + p, acc[a][c] + d_h * xs[i * P + p]);
      }
    }
    __syncthreads();  // the next chunk overwrites the staged operands and reads S
  }

  float* out = s_out + ((size_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += SSD_THREADS) out[e] = S[e];
}

template <typename Elem>
int ssd_scan_launch_t(const void* x, const float* dt, const float* A, const void* bm,
                      const void* cm, const float* D, void* y, float* s_out, int B, int T, int H,
                      int P, int G, int N, int L, int rows, cudaStream_t stream) {
  const size_t smem = ssd_shared_floats(L, N, P, rows) * sizeof(float);
  cudaError_t err = allow_shared(ssd_scan_kernel<Elem>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<Elem><<<B * H, SSD_THREADS, smem, stream>>>((const Elem*)x, dt, A,
      (const Elem*)bm, (const Elem*)cm, D, (Elem*)y, s_out, T, H, P, G, N, L, rows);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* bm,
                               const void* cm, const float* D, void* y, float* s_out, int B,
                               int T, int H, int P, int G, int N, int L, int rows, int bf16,
                               void* stream) {
  using namespace repro;
  if (B < 1 || L < 16 || L % 16 != 0 || L > 16 * SSD_MAX_B || T < L || T % L != 0 ||
      rows < 16 || rows % 16 != 0 || rows > 16 * SSD_MAX_RA || L % rows != 0 || G < 1 ||
      H % G != 0 || P < 1 || P > 16 * SSD_MAX_C || N < 1 || N > 16 * SSD_MAX_A)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return ssd_scan_launch_t<__nv_bfloat16>(x, dt, A, bm, cm, D, y, s_out, B, T, H, P, G, N, L,
                                            rows, s);
  return ssd_scan_launch_t<float>(x, dt, A, bm, cm, D, y, s_out, B, T, H, P, G, N, L, rows, s);
}
