// Blockwise online-softmax attention, forward: q [B,Sq,QH,Dh], k, v [B,Sk,KH,Dh]
// (the model layout) -> o [B,Sq,QH,Dh] in q's dtype.
//
// Replaces repro/kernels/flash_attention/kernel.py:104 flash_attention_pallas
// (body _flash_kernel, :29-98). One block per (q tile of 64 rows, q head,
// sequence) walks the keys in tiles of 64 with the online-softmax running max,
// sum and accumulator resident (the accumulator in registers, the row
// statistics in shared memory), so the [Sq, Sk] scores never reach device
// memory. Query head h reads kv head h*KH/QH (GQA, MQA).
//
// The masks are the Pallas kernel's, element for element: a causal or
// windowed key scores -1e30 (not -inf), and a key tile whose logical block
// (block_k keys) is irrelevant to the row's logical block (block_q rows) is
// skipped, as pl.when(relevant) skips it (kernel.py:60-66). The physical
// 64 x 64 tiles are independent of the logical blocks: relevance is judged
// per element from the logical blocks, so any legal block_q/block_k gives the
// Pallas kernel's result. A row with no unmasked key therefore ends as the
// Pallas kernel's does: 0 where no tile was relevant to its block (l = 0,
// safe_l), else the mean of v over the masked keys of the relevant tiles
// (every masked score equals the running max -1e30, so each weighs exp(0)).
// Keys past Sk and irrelevant tiles score -inf, which weighs 0. Products and
// the softmax run in float32 whatever the input dtype (kernel.py:69-71).
//
// What bounds it on an H100: the products, 4*Sq*Sk*Dh operations a head (half
// of that under a causal mask) against (2*Sq + 2*Sk)*Dh elements of traffic,
// so operations. This kernel does them on the float32 cores from shared
// memory, not on the tensor cores (989 TFLOP/s in bf16), so it stays far from
// the bound, which a wgmma version would approach. Against the shared-memory
// loads, the block's 256 threads form a 16 x 16 grid and each owns a register
// tile of the scores (4 x 4) and of the accumulator (4 rows x Dh/16 columns):
// a thread loads a row and a column vector per step of a sum and does their
// outer product. q is staged transposed ([Dh][64]) and k's rows padded to
// Dh+1 floats, so that both vectors are read without bank conflicts; the
// probabilities' rows are padded to 65.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace repro {

constexpr int FA_THREADS = 256;  // a 16 x 16 grid
constexpr int FA_TILE = 64;      // query rows of a block, keys of a tile
constexpr int FA_MAX_DH = 128;
constexpr int FA_RG = FA_TILE / 16;      // 4 row (and key) groups of 16
constexpr int FA_DG = FA_MAX_DH / 16;    // at most 8 column groups of Dh
constexpr int FA_PS = FA_TILE + 1;       // padded row of the probabilities
constexpr float FA_NEG = -1e30f;  // the Pallas kernel's mask value (kernel.py:27)

__device__ __forceinline__ float fa_f32(float v) { return v; }
__device__ __forceinline__ float fa_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

inline size_t fa_shared_floats(int Dh) {
  // q^T [Dh][64], k [64][Dh+1], v [64][Dh], p [64][65], m, l, corr [64]
  return (size_t)FA_TILE * (3 * Dh + 1) + FA_TILE * FA_PS + 3 * FA_TILE;
}

template <typename Elem>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                           const Elem* __restrict__ v, Elem* __restrict__ o, int Sq, int Sk,
                           int QH, int KH, int Dh, int bq, int bk, int causal, int window,
                           int q_offset, float scale) {
  extern __shared__ float smem[];
  const int ks_ld = Dh + 1;
  float* qt = smem;                  // [Dh][64] q, transposed
  float* ks = qt + FA_TILE * Dh;     // [64][Dh+1]
  float* vs = ks + FA_TILE * ks_ld;  // [64][Dh]
  float* ps = vs + FA_TILE * Dh;     // [64][65] scores, then probabilities
  float* m = ps + FA_TILE * FA_PS;   // [64] running max
  float* l = m + FA_TILE;            // [64] running sum
  float* corr = l + FA_TILE;         // [64] this tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * KH / QH;
  const size_t q_row = (size_t)QH * Dh, kv_row = (size_t)KH * Dh;
  const Elem* q_b = q + (size_t)b * Sq * q_row + (size_t)h * Dh;
  const Elem* k_b = k + (size_t)b * Sk * kv_row + (size_t)kvh * Dh;
  const Elem* v_b = v + (size_t)b * Sk * kv_row + (size_t)kvh * Dh;
  const int DG = (Dh + 15) >> 4;

  for (int e = tid; e < FA_TILE * Dh; e += FA_THREADS) {
    const int i = e / Dh, d = e - i * Dh;
    qt[d * FA_TILE + i] = (r0 + i < Sq) ? fa_f32(q_b[(size_t)(r0 + i) * q_row + d]) : 0.0f;
  }
  if (tid < FA_TILE) {
    m[tid] = FA_NEG;
    l[tid] = 0.0f;
  }
  // the accumulator: rows ty + 16a, columns tx + 16c
  float acc[FA_RG][FA_DG];
#pragma unroll
  for (int a = 0; a < FA_RG; ++a)
#pragma unroll
    for (int c = 0; c < FA_DG; ++c) acc[a][c] = 0.0f;

  for (int kt0 = 0; kt0 < Sk; kt0 += FA_TILE) {
    // which of this thread's scores (rows ty + 16a, keys tx + 16c) exist and
    // lie in a relevant pair of logical blocks
    bool rel[FA_RG][FA_RG];
    bool any = false;
#pragma unroll
    for (int a = 0; a < FA_RG; ++a) {
#pragma unroll
      for (int c = 0; c < FA_RG; ++c) {
        const int qi = r0 + ty + 16 * a, kj = kt0 + tx + 16 * c;
        bool r = qi < Sq && kj < Sk;
        const int q_start = (qi / bq) * bq + q_offset, k_start = (kj / bk) * bk;
        if (causal) r = r && k_start <= q_start + bq - 1;
        if (window >= 0) r = r && k_start + bk - 1 > q_start - window;
        rel[a][c] = r;
        any = any || r;
      }
    }
    if (!__syncthreads_or(any)) continue;  // the whole tile is skipped, as pl.when does

    for (int e = tid; e < FA_TILE * Dh; e += FA_THREADS) {
      const int j = e / Dh, d = e - j * Dh;
      const bool in = kt0 + j < Sk;
      ks[j * ks_ld + d] = in ? fa_f32(k_b[(size_t)(kt0 + j) * kv_row + d]) : 0.0f;
      vs[e] = in ? fa_f32(v_b[(size_t)(kt0 + j) * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    {
      float s[FA_RG][FA_RG];
#pragma unroll
      for (int a = 0; a < FA_RG; ++a)
#pragma unroll
        for (int c = 0; c < FA_RG; ++c) s[a][c] = 0.0f;
      for (int d = 0; d < Dh; ++d) {
        float qv[FA_RG], kv[FA_RG];
#pragma unroll
        for (int a = 0; a < FA_RG; ++a) qv[a] = qt[d * FA_TILE + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < FA_RG; ++c) kv[c] = ks[(tx + 16 * c) * ks_ld + d];
#pragma unroll
        for (int a = 0; a < FA_RG; ++a)
#pragma unroll
          for (int c = 0; c < FA_RG; ++c) s[a][c] += qv[a] * kv[c];
      }
#pragma unroll
      for (int a = 0; a < FA_RG; ++a) {
#pragma unroll
        for (int c = 0; c < FA_RG; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          float sv = -INFINITY;
          if (rel[a][c]) {
            const int qpos = r0 + i + q_offset, kpos = kt0 + j;
            const bool masked = (causal && kpos > qpos) || (window >= 0 && kpos <= qpos - window);
            sv = masked ? FA_NEG : s[a][c] * scale;
          }
          ps[i * FA_PS + j] = sv;
        }
      }
    }
    __syncthreads();

    // the online softmax: each warp updates 8 rows' max and sum
    for (int i = warp; i < FA_TILE; i += FA_THREADS / 32) {
      float* p_i = ps + i * FA_PS;
      const float s0 = p_i[lane], s1 = p_i[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[i], m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      p_i[lane] = p0;
      p_i[lane + 32] = p1;
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[i] = cr;
        l[i] = l[i] * cr + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();

    {
      float pv[FA_RG][FA_DG];
#pragma unroll
      for (int a = 0; a < FA_RG; ++a)
#pragma unroll
        for (int c = 0; c < FA_DG; ++c) pv[a][c] = 0.0f;
      for (int j = 0; j < FA_TILE; ++j) {
        float pr[FA_RG], vv[FA_DG];
#pragma unroll
        for (int a = 0; a < FA_RG; ++a) pr[a] = ps[(ty + 16 * a) * FA_PS + j];
#pragma unroll
        for (int c = 0; c < FA_DG; ++c) vv[c] = (c < DG && tx + 16 * c < Dh) ? vs[j * Dh + tx + 16 * c] : 0.0f;
#pragma unroll
        for (int a = 0; a < FA_RG; ++a)
#pragma unroll
          for (int c = 0; c < FA_DG; ++c) pv[a][c] += pr[a] * vv[c];
      }
#pragma unroll
      for (int a = 0; a < FA_RG; ++a) {
        const float cr = corr[ty + 16 * a];
#pragma unroll
        for (int c = 0; c < FA_DG; ++c) acc[a][c] = acc[a][c] * cr + pv[a][c];
      }
    }
    __syncthreads();  // the next tile overwrites k, v and the probabilities
  }

  Elem* o_b = o + (size_t)b * Sq * q_row + (size_t)h * Dh;
#pragma unroll
  for (int a = 0; a < FA_RG; ++a) {
    const int i = ty + 16 * a;
    if (r0 + i >= Sq) continue;
    const float li = l[i];
    const float inv = li == 0.0f ? 1.0f : li;  // safe_l: a row with no relevant tile is 0
#pragma unroll
    for (int c = 0; c < FA_DG; ++c) {
      const int d = tx + 16 * c;
      if (c < DG && d < Dh) fa_store(o_b + (size_t)(r0 + i) * q_row + d, acc[a][c] / inv);
    }
  }
}

template <typename Elem>
int flash_attention_launch_t(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                             int Sk, int QH, int KH, int Dh, int bq, int bk, int causal,
                             int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = fa_shared_floats(Dh) * sizeof(float);
  cudaError_t err = allow_shared(flash_attention_kernel<Elem>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_TILE - 1) / FA_TILE, QH, B);
  flash_attention_kernel<Elem><<<grid, FA_THREADS, smem, stream>>>((const Elem*)q,
      (const Elem*)k, (const Elem*)v, (Elem*)o, Sq, Sk, QH, KH, Dh, bq, bk, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int Sq, int Sk, int QH, int KH, int Dh, int bq, int bk,
                                      int causal, int window, int q_offset, float scale, int bf16,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || QH % KH != 0 || Dh < 1 || Dh > repro::FA_MAX_DH ||
      bq < 1 || bk < 1 || Sq % bq != 0 || Sk % bk != 0 || QH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return repro::flash_attention_launch_t<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq,
                                                          bk, causal, window, q_offset, scale, s);
  return repro::flash_attention_launch_t<float>(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq, bk, causal,
                                                window, q_offset, scale, s);
}
