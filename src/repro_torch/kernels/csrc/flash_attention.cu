// Blockwise online-softmax attention, forward: q [B,Sq,QH,Dh], k, v [B,Sk,KH,Dh]
// (the model layout) -> o [B,Sq,QH,Dh] in q's dtype.
//
// Replaces repro/kernels/flash_attention/kernel.py:104 flash_attention_pallas
// (body _flash_kernel, :29-98). A block owns a tile of query rows of one head
// and sequence and walks the keys in tiles with the online-softmax running
// max, sum and accumulator resident, so the [Sq, Sk] scores never reach
// device memory. Query head h reads kv head h*KH/QH (GQA, MQA).
//
// The masks are the Pallas kernel's, element for element: a causal or
// windowed key scores -1e30 (not -inf), and a key whose logical block
// (block_k keys) is irrelevant to the row's logical block (block_q rows) is
// skipped, as pl.when(relevant) skips it (kernel.py:60-66). The physical
// tiles are independent of the logical blocks: relevance is judged per
// element from the logical blocks, so any legal block_q/block_k gives the
// Pallas kernel's result. A row with no unmasked key therefore ends as the
// Pallas kernel's does: 0 where no tile was relevant to its block (l = 0,
// safe_l), else the mean of v over the masked keys of the relevant tiles
// (every masked score equals the running max -1e30, so each weighs exp(0)).
// Keys past Sk and irrelevant keys score -inf, which weighs 0. The scale
// multiplies the product, and the softmax runs in float32 (kernel.py:69-77).
//
// What bounds it on an H100: the products, 4*Sq*Sk*Dh operations a head (half
// of that under a causal mask) against (2*Sq + 2*Sk)*Dh elements of traffic,
// so operations on the tensor cores.
//
// bf16 operands (flash_attention_bf16_kernel): Hopper's wgmma (wgmma.cuh). A
// block of two warpgroups owns 128 query rows, 64 a warpgroup, and walks the
// keys in tiles of 64, staged by cp.async into a ring of three stages of
// unswizzled core matrices. S = QK^T is a wgmma with Q and K in shared memory
// (bf16 x bf16 into float32 registers, exact products); the scale and the
// masks are applied in registers and the online softmax reduces over the 4
// lanes that share a row. P is float32, and one bf16 rounding of it would put
// the output outside one bf16 rounding of the float32 result, so P is split
// into P_hi + P_lo (bf16 each), and both run, as the A operand in registers,
// against V (MN-major in shared memory) into one accumulator: 1.5x the
// tensor-core work of a rounded P, the price of the bound. The loop is
// pipelined within a warpgroup (FlashAttention-3): S of tile i+1 and P V of
// tile i are issued together, the softmax of tile i+1 runs while P V of tile i
// is on the tensor cores, and the accumulator's rescale waits for that
// product; the last tile's P V is peeled out of the loop so that no wait is
// conditional (ptxas serialises the products otherwise). The block walks only
// the key tiles its rows' logical blocks may need (the causal triangle, the
// window); tiles with every element unmasked skip the mask arithmetic; the
// grid puts the query tile slowest and launches the longest (last) tiles
// first, so that the causal triangle's short tiles fill the last wave. Dh is
// padded with zeros to 16, 32, 64 or 128.
//
// float32 operands (flash_attention_f32_kernel) stay on the float32 FMA units:
// TF32 would miss the float32 bound (2e-5). The block's 256 threads form a
// 16 x 16 grid and each owns a register tile of the scores (4 x 4) and of the
// accumulator (4 rows x Dh/16 columns) over 64 query rows and 64-key tiles; q
// is staged transposed ([Dh][64]) and k's rows padded to Dh+1 floats, so
// that both vectors are read without bank conflicts.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace repro {

constexpr int FA_THREADS = 256;  // a 16 x 16 grid
constexpr int FA_TILE = 64;      // query rows of a block, keys of a tile
constexpr int FA_MAX_DH = 128;
constexpr int FA_RG = FA_TILE / 16;      // 4 row (and key) groups of 16
constexpr int FA_DG = FA_MAX_DH / 16;    // at most 8 column groups of Dh
constexpr int FA_PS = FA_TILE + 1;       // padded row of the probabilities
constexpr float FA_NEG = -1e30f;  // the Pallas kernel's mask value (kernel.py:27)

inline size_t fa_shared_floats(int Dh) {
  // q^T [Dh][64], k [64][Dh+1], v [64][Dh], p [64][65], m, l, corr [64]
  return (size_t)FA_TILE * (3 * Dh + 1) + FA_TILE * FA_PS + 3 * FA_TILE;
}

__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
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
  const float* q_b = q + (size_t)b * Sq * q_row + (size_t)h * Dh;
  const float* k_b = k + (size_t)b * Sk * kv_row + (size_t)kvh * Dh;
  const float* v_b = v + (size_t)b * Sk * kv_row + (size_t)kvh * Dh;
  const int DG = (Dh + 15) >> 4;

  for (int e = tid; e < FA_TILE * Dh; e += FA_THREADS) {
    const int i = e / Dh, d = e - i * Dh;
    qt[d * FA_TILE + i] = (r0 + i < Sq) ? q_b[(size_t)(r0 + i) * q_row + d] : 0.0f;
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
      ks[j * ks_ld + d] = in ? k_b[(size_t)(kt0 + j) * kv_row + d] : 0.0f;
      vs[e] = in ? v_b[(size_t)(kt0 + j) * kv_row + d] : 0.0f;
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

  float* o_b = o + (size_t)b * Sq * q_row + (size_t)h * Dh;
#pragma unroll
  for (int a = 0; a < FA_RG; ++a) {
    const int i = ty + 16 * a;
    if (r0 + i >= Sq) continue;
    const float li = l[i];
    const float inv = li == 0.0f ? 1.0f : li;  // safe_l: a row with no relevant tile is 0
#pragma unroll
    for (int c = 0; c < FA_DG; ++c) {
      const int d = tx + 16 * c;
      if (c < DG && d < Dh) o_b[(size_t)(r0 + i) * q_row + d] = acc[a][c] / inv;
    }
  }
}

constexpr int FB_WARPS = 8;             // two warpgroups of 64 query rows
constexpr int FB_THREADS = 32 * FB_WARPS;
constexpr int FB_ROWS = 16 * FB_WARPS;  // query rows of a block
constexpr int FB_KT = 64;               // keys of a tile
constexpr int FB_STAGES = 3;            // the ring of key and value tiles
constexpr float FB_LOG2E = 1.4426950408889634f;

inline size_t fb_shared_bytes(int DP) {
  // q [128 x DP], k and v [STAGES][64 x DP], in core matrices
  return sizeof(bf16) * (size_t)DP * (FB_ROWS + 2 * FB_STAGES * FB_KT);
}

// The key range [lo, hi) that rows [r0, r1] (r1 >= r0) may need: a superset
// of the keys relevant to their logical blocks. Keys outside it are
// irrelevant to every one of these rows (the causal bound grows with the row,
// the window's lower bound too).
__device__ __forceinline__ void fb_key_range(int r0, int r1, int Sk, int bq, int bk, int causal,
                                             int window, int q_offset, int& lo, int& hi) {
  lo = 0;
  hi = Sk;
  if (causal) {
    const int lim = (r1 / bq) * bq + q_offset + bq - 1;  // k_start <= q_start + bq - 1
    hi = lim < 0 ? 0 : min(Sk, (lim / bk + 1) * bk);
  }
  if (window >= 0) {
    const int first = (r0 / bq) * bq + q_offset - window - bk + 2;  // k_start + bk - 1 > q_start - window
    if (first > 0) lo = (first + bk - 1) / bk * bk;
  }
}

template <int DK>  // Dh padded to DP = 16 * DK
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
                                int QH, int KH, int Dh, int bq, int bk, int causal, int window,
                                int q_offset, float scale, int vec) {
  constexpr int DP = 16 * DK;
  extern __shared__ __align__(128) unsigned char fb_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fb_smem);  // [128 x DP]
  bf16* ks = qs + FB_ROWS * DP;                 // [STAGES][64 x DP]
  bf16* vs = ks + FB_STAGES * FB_KT * DP;       // [STAGES][64 x DP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * FB_ROWS;  // the longest tiles first
  const int kvh = h * KH / QH;
  const size_t q_row = (size_t)QH * Dh, kv_row = (size_t)KH * Dh;
  const bf16* q_b = q + (size_t)b * Sq * q_row + (size_t)h * Dh;
  const bf16* k_b = k + (size_t)b * Sk * kv_row + (size_t)kvh * Dh;
  const bf16* v_b = v + (size_t)b * Sk * kv_row + (size_t)kvh * Dh;

  int k_lo, k_hi;
  fb_key_range(r0, min(r0 + FB_ROWS, Sq) - 1, Sk, bq, bk, causal, window, q_offset, k_lo, k_hi);
  const int kt_first = k_lo / FB_KT * FB_KT;
  const int n_tiles = k_hi > kt_first ? (k_hi - kt_first + FB_KT - 1) / FB_KT : 0;

  // this warp's 16 rows (its warpgroup's wgmma computes 64)
  const int wr0 = r0 + 16 * warp;
  const int qi[2] = {wr0 + g, wr0 + g + 8};
  int q_start[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) q_start[r] = (qi[r] / bq) * bq + q_offset;

  auto load_kv = [&](int tile) {
    const int kt0 = kt_first + tile * FB_KT, stage = tile % FB_STAGES;
    stage_core_bf16(ks + stage * FB_KT * DP, FB_KT, k_b + (size_t)kt0 * kv_row, kv_row, Sk - kt0,
                    Dh, DP, vec);
    stage_core_bf16(vs + stage * FB_KT * DP, FB_KT, v_b + (size_t)kt0 * kv_row, kv_row, Sk - kt0,
                    Dh, DP, vec);
  };
  // S = Q K^T of tile `tile` into s, on the tensor cores (issued, not waited for)
  auto issue_qk = [&](float (&s)[FB_KT / 8][4], int tile) {
    const bf16* kst = ks + (tile % FB_STAGES) * FB_KT * DP;
#pragma unroll
    for (int nb = 0; nb < FB_KT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
    pin_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      wgmma_ss(s, gmma_desc(qs + core_offset(FB_ROWS, 64 * wg, 16 * kk), FB_ROWS * 16, 128),
               gmma_desc(kst + core_offset(FB_KT, 0, 16 * kk), FB_KT * 16, 128), kk > 0);
    wgmma_commit();
  };

  float acc[2 * DK][4];
#pragma unroll
  for (int nb = 0; nb < 2 * DK; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
  float m_run[2] = {FA_NEG, FA_NEG}, l_run[2] = {0.0f, 0.0f};  // l: this lane's share
  float s[FB_KT / 8][4];
  uint32_t p_hi[FB_KT / 16][4], p_lo[FB_KT / 16][4];

  // the scale, the masks and the online softmax of tile `tile` on s (in place: s becomes
  // P); updates m_run, l_run and corr, the accumulator's rescale
  float corr[2];
  auto softmax = [&](int tile) {
    const int kt0 = kt_first + tile * FB_KT;
    const bool full = kt0 + FB_KT <= Sk && (!causal || kt0 + FB_KT - 1 <= wr0 + q_offset) &&
                      (window < 0 || kt0 > wr0 + 15 + q_offset - window);
    if (full) {
#pragma unroll
      for (int nb = 0; nb < FB_KT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= scale;
    } else {
#pragma unroll
      for (int nb = 0; nb < FB_KT / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kj = kt0 + 8 * nb + 2 * t + (e & 1);
          const int qpos = qi[r] + q_offset, k_start = (kj / bk) * bk;
          bool rel = qi[r] < Sq && kj < Sk;
          if (causal) rel = rel && k_start <= q_start[r] + bq - 1;
          if (window >= 0) rel = rel && k_start + bk - 1 > q_start[r] - window;
          const bool masked = (causal && kj > qpos) || (window >= 0 && kj <= qpos - window);
          s[nb][e] = !rel ? -INFINITY : (masked ? FA_NEG : s[nb][e] * scale);
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nb = 0; nb < FB_KT / 8; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m_run[r] - mx[r]) * FB_LOG2E);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < FB_KT / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[nb][e] = exp2f((s[nb][e] - mx[r]) * FB_LOG2E);
        sum[r] += s[nb][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + sum[r];
  };

  if (n_tiles > 0) {
    stage_core_bf16(qs, FB_ROWS, q_b + (size_t)r0 * q_row, q_row, Sq - r0, Dh, DP, vec);
    load_kv(0);
    cp_async_commit();
    if (n_tiles > 1) load_kv(1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    issue_qk(s, 0);
    wgmma_wait<0>();
    pin_regs(s);
    softmax(0);  // acc is 0: its rescale is moot
#pragma unroll
    for (int kk = 0; kk < FB_KT / 16; ++kk) split_a(s[2 * kk], s[2 * kk + 1], p_hi[kk], p_lo[kk]);
  }
  // tile it: P (p_hi, p_lo) is ready; S of tile it + 1 runs on the tensor cores while the
  // accumulator takes P V of tile it, and the softmax of tile it + 1 overlaps that product
  auto issue_pv = [&](int tile) {
    const bf16* vst = vs + (tile % FB_STAGES) * FB_KT * DP;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FB_KT / 16; ++kk) {
      const uint64_t dv = gmma_desc(vst + core_offset(FB_KT, 16 * kk, 0), 128, FB_KT / 8 * 128);
      wgmma_rs(acc, p_hi[kk], dv);
      wgmma_rs(acc, p_lo[kk], dv);
    }
    wgmma_commit();
  };
  for (int it = 0; it + 1 < n_tiles; ++it) {
    cp_async_wait<0>();  // tile it + 1
    fence_proxy_async();
    __syncthreads();     // every warpgroup is done with tile it - 1's stage
    if (it + 2 < n_tiles) load_kv(it + 2);
    cp_async_commit();
    pin_regs(acc);
    issue_qk(s, it + 1);
    issue_pv(it);
    wgmma_wait<1>();  // S of tile it + 1
    pin_regs(s);
    softmax(it + 1);
    wgmma_wait<0>();  // P V of tile it
    pin_regs(acc);
    pin_regs(p_hi);
    pin_regs(p_lo);
#pragma unroll
    for (int nb = 0; nb < 2 * DK; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < FB_KT / 16; ++kk) split_a(s[2 * kk], s[2 * kk + 1], p_hi[kk], p_lo[kk]);
  }
  if (n_tiles > 0) {  // the last tile's P V (its keys were waited for above)
    pin_regs(acc);
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    pin_regs(acc);
    pin_regs(p_hi);
    pin_regs(p_lo);
  }

  // -- o = acc / l (safe_l: a row with no relevant key is 0) -------------------
  bf16* o_b = o + (size_t)b * Sq * q_row + (size_t)h * Dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.0f ? 1.0f : l;
    if (qi[r] >= Sq) continue;
    bf16* row = o_b + (size_t)qi[r] * q_row;
#pragma unroll
    for (int nb = 0; nb < 2 * DK; ++nb) {
      const int d = 8 * nb + 2 * t;
      const float o0 = acc[nb][2 * r] / inv, o1 = acc[nb][2 * r + 1] / inv;
      if (Dh % 2 == 0) {  // (d, d + 1) both in or both out, 4-byte aligned
        if (d < Dh) *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(o0, o1);
      } else {
        if (d < Dh) row[d] = __float2bfloat16(o0);
        if (d + 1 < Dh) row[d + 1] = __float2bfloat16(o1);
      }
    }
  }
}

template <int DK>
int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* o, int B,
                                int Sq, int Sk, int QH, int KH, int Dh, int bq, int bk, int causal,
                                int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = fb_shared_bytes(16 * DK);
  cudaError_t err = allow_shared(flash_attention_bf16_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = Dh % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid(QH, B, (Sq + FB_ROWS - 1) / FB_ROWS);
  flash_attention_bf16_kernel<DK><<<grid, FB_THREADS, smem, stream>>>((const bf16*)q,
      (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Sk, QH, KH, Dh, bq, bk, causal, window,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                               int Sk, int QH, int KH, int Dh, int bq, int bk, int causal,
                               int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = fa_shared_floats(Dh) * sizeof(float);
  cudaError_t err = allow_shared(flash_attention_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_TILE - 1) / FA_TILE, QH, B);
  flash_attention_f32_kernel<<<grid, FA_THREADS, smem, stream>>>((const float*)q,
      (const float*)k, (const float*)v, (float*)o, Sq, Sk, QH, KH, Dh, bq, bk, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int Sq, int Sk, int QH, int KH, int Dh, int bq, int bk,
                                      int causal, int window, int q_offset, float scale, int is_bf16,
                                      void* stream) {
  using namespace repro;
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || QH % KH != 0 || Dh < 1 || Dh > FA_MAX_DH ||
      bq < 1 || bk < 1 || Sq % bq != 0 || Sk % bk != 0 || QH > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return flash_attention_f32_launch(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq, bk, causal, window,
                                      q_offset, scale, s);
  if (Dh <= 16)
    return flash_attention_bf16_launch<1>(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq, bk, causal,
                                          window, q_offset, scale, s);
  if (Dh <= 32)
    return flash_attention_bf16_launch<2>(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq, bk, causal,
                                          window, q_offset, scale, s);
  if (Dh <= 64)
    return flash_attention_bf16_launch<4>(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq, bk, causal,
                                          window, q_offset, scale, s);
  return flash_attention_bf16_launch<8>(q, k, v, o, B, Sq, Sk, QH, KH, Dh, bq, bk, causal, window,
                                        q_offset, scale, s);
}
