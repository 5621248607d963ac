// GRU(-flow) sequence scan at the widths the warp cell does not take
// (256 < H <= 512): xs [B, T, D] -> hs [B, T, H], the wide form of gru_scan.
//
// Replaces, at those widths, repro/kernels/gru_scan/kernel.py:107
// gru_scan_pallas (step :42-63 _gru_step_math): the merinda-gru LM's mixer,
// d_model = gru_hidden = 512, in prefill (B = 4 or 1, T = 1,024) and in decode
// (T = 1). gru_scan.cu's warp cell keeps a window's whole cell in one warp and
// its weights in one block's shared memory; at H = 512 wx and wh are 3 MB each
// in float32, against 227 KB a block. So the call is two kernels:
//
// 1. the h-independent terms, gx [B*T, 3H] = xs . wx + b, in float32. In
//    prefill gru_wide_gx_kernel, a tiled GEMM (64 x 64 output tiles, 16-deep k
//    tiles staged in shared memory, 4 x 4 outputs a thread); at the bootstrap
//    prefill it is 4,096 x 512 x 1,536, 6.4 GFLOP, bound by the FMA units. At
//    M = B*T <= kSkinnyRows (decode) gru_wide_gx_skinny_kernel: 32 output
//    columns a block (a lane each), its 8 warps splitting k, their partial
//    sums added in warp order; it reads wx once over 48 blocks at H = 512,
//    where the tiled GEMM's 24 blocks walk 32 dependent k tiles each.
// 2. gru_wide_kernel, the recurrence: a thread-block cluster of kCluster = 16
//    blocks runs kRows = 1 batch row through all T steps (a cluster a row).
//    Block `rank` owns hidden units [32 rank, 32 rank + 32); warp w of it owns
//    the 4 consecutive units 32 rank + 4 w + j, so that its 4 new values of
//    r*h, and of h, are one float4. A lane holds its 16 k (k = 128 p + 4 lane
//    + e, p, e < 4) of the warp's 12 recurrent columns (r, z and c of 4 units)
//    in registers, loaded once before the time loop (192 floats a thread; 241
//    registers, no spill); a halving shuffle exchange leaves each lane one
//    finished sum. One step:
//      - every warp forms its units' r and z from the whole h_t;
//      - lanes 0-15 push the warp's float4 of r*h_t into block `lane`'s r*h
//        row with st.async, whose bytes complete on that block's mbarrier;
//      - every block waits on its own r*h barrier (16 blocks x 8 warps x 16
//        bytes a row), forms c and the (flow) update for its units, pushes
//        h_{t+1} the same way into the other h buffer, and stores hs[:, t].
//    h and r*h are double-buffered by step parity, with one mbarrier a buffer
//    (four a block). Thread 0 of a block re-arms a barrier (arrive.expect_tx)
//    right after it has waited on it, so a barrier's phase k + 1 is armed only
//    once phase k completed. No push lands in a buffer a peer still reads:
//    a push of step t + 2's values into a buffer needs its pusher to have
//    waited on step t + 1's exchange, which completes only once every warp of
//    every block has pushed into it, and each warp pushes step t + 1's values
//    after it has read the buffer's step t values (the barrier's complete_tx
//    releases, the wait acquires, at cluster scope). The same argument keeps
//    step t + 2's bytes out of phase t of the barrier. The flow gate's
//    phi(dt) * alpha = tanh(softplus(time_scale) dt) * 0.4 is computed beside
//    the step, off its chain, as are the next step's gx loads. Two
//    cluster.sync() remain: after the barriers are initialized, and before
//    exit, so that no block leaves while a peer may still write into it.
//
// What bounds it on an H100: the recurrence's chain, not the roofline. At the
// bootstrap prefill the call is 12.9 GFLOP and ~23 MB a layer (0.19 ms at 67
// TFLOP/s of float32), but its T steps are dependent: each is two 512-deep
// products split over the cluster (16 FMAs deep a lane, then five shuffle
// rounds), two all-to-all exchanges, a sigmoid and a tanh: ~1,920 cycles
// reckoned, ~3,000 on the card (PERF.md row 2b: each exchange ~610, the
// products ~910, the reductions ~280, sigmoid and tanh ~200). The design before
// this one read all 96 of a block's columns from shared memory every step and made
// 1,024 4-byte remote stores and two cluster barriers (~1,000 cycles each) a
// step, ~6,800-8,000 cycles. An exchange as one 128-byte cp.async.bulk slice a
// block took twice these per-warp pushes (launch/cluster_probe.cu).
//
// Arithmetic: float32 throughout, the warp cell's accurate sigmoid (common.cuh)
// and tanhf, softplus as warp_cell.cuh; the standard GRU's update rounds both
// products, as the plain version. Within 1e-4 of gru_scan_reference; sums are
// taken in another order than the plain version's one product over [x, h].
//
// Shapes: any B, T, D >= 1 and 1 <= H <= 512 (a tile of kRows past B computes
// rows that are never stored). A launch whose cluster cannot be resident is refused
// (cudaErrorInvalidConfiguration), as is a shape outside these.
#include <cooperative_groups.h>

#include "tick.cuh"       // ClusterFit, launch_clusters
#include "warp_cell.cuh"  // softplus, kInvLipschitzAlpha, allow_shared_once

namespace repro {
namespace cg = cooperative_groups;

namespace wide {

constexpr int kCluster = 16;                    // blocks a cluster: the non-portable maximum
constexpr int kRows = 1;                        // batch rows a cluster
constexpr int kUnits = 32;                      // hidden units a block
constexpr int kWarps = 8;                       // warps a block
constexpr int kWarpUnits = kUnits / kWarps;     // consecutive hidden units a warp: one float4
static_assert(kWarpUnits == 4, "a warp's units of a gate are one float4");
constexpr int kMaxHidden = kCluster * kUnits;   // 512: a row's length in shared memory
constexpr int kPass = 128;                      // k a warp covers in one pass: 32 lanes x 4
constexpr int kPasses = kMaxHidden / kPass;     // 4
constexpr int kLaneK = 4 * kPasses;             // k a lane holds of each column: 16
constexpr int kRowBytes = kCluster * kWarps * 16;  // bytes a row's exchange brings a block
constexpr int kTileM = 64, kTileN = 64, kTileK = 16;  // gru_wide_gx_kernel's tiles
constexpr int kSkinnyRows = 16;  // M = B*T at most this: gru_wide_gx_skinny_kernel (tiling.py)
constexpr int kSkinnyCols = 32;  // its output columns a block
constexpr int kSkinnyK = 256;    // and the k of one of its rounds
constexpr unsigned kFull = 0xffffffffu;

// A block's carve in floats: h and r*h, each [2 step parities][kRows][kMaxHidden],
// then the four mbarriers (h by parity, then r*h by parity; 8 bytes each).
struct Layout {
  size_t h, rh, bar, total;
  __host__ __device__ Layout() {
    h = 0;
    rh = h + 2 * kRows * kMaxHidden;
    bar = rh + 2 * kRows * kMaxHidden;
    total = bar + 2 * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address `a` of this block's shared memory in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// The one arrival of a phase, expecting `bytes` of pushes.
__device__ __forceinline__ void bar_arm(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// 16 bytes into another block's shared memory, completing on its barrier.
__device__ __forceinline__ void push4(uint32_t remote, const float4& v, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar)
      : "memory");
}

// Sums v[i] over the warp's lanes for every i < NV (a power of two <= 32):
// lane l returns the total of v[l % NV]. Offsets >= NV add whole vectors;
// each offset below halves the vector, a lane keeping the half its bit picks.
template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off >= NV; off >>= 1)
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(kFull, v[i], off);
#pragma unroll
  for (int off = NV / 2; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  return v[0];
}

// acc[c * kRows + r] = this lane's 16 k of column c, w[c][4 p + e], times row
// r of `rows` [kRows][kMaxHidden], in increasing k.
template <int NC>
__device__ __forceinline__ void products(const float (&w)[NC][kLaneK], const float* rows,
                                         float (&acc)[NC * kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NC * kRows; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 hv =
          *reinterpret_cast<const float4*>(rows + r * kMaxHidden + p * kPass + 4 * lane);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float a = acc[c * kRows + r];
        a = fmaf(w[c][4 * p], hv.x, a);
        a = fmaf(w[c][4 * p + 1], hv.y, a);
        a = fmaf(w[c][4 * p + 2], hv.z, a);
        a = fmaf(w[c][4 * p + 3], hv.w, a);
        acc[c * kRows + r] = a;
      }
    }
  }
}

// Lanes 0-15 push row r's 4 values of the warp (held by lanes j * kRows + r,
// j < 4) into block `lane`'s buffer at `peer` + the row's offset, completing
// on its barrier `peer_bar`; every lane takes part in the shuffles.
__device__ __forceinline__ void push_rows(float v, uint32_t peer, uint32_t peer_bar, int unit0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 q = make_float4(__shfl_sync(kFull, v, 0 * kRows + r), __shfl_sync(kFull, v, 1 * kRows + r),
                                 __shfl_sync(kFull, v, 2 * kRows + r), __shfl_sync(kFull, v, 3 * kRows + r));
    if (lane < kCluster) push4(peer + 4u * (unsigned)(r * kMaxHidden + unit0), q, peer_bar);
  }
}

}  // namespace wide

// gx [M, N] = xs [M, K] . wx [K, N] + b [N] (M = B*T, K = D, N = 3H): a tile of
// 64 x 64 outputs a block, 4 x 4 a thread, k in order through 16-deep tiles.
__global__ void __launch_bounds__(256) gru_wide_gx_kernel(const float* __restrict__ xs,
                                                 const float* __restrict__ wx,
                                                 const float* __restrict__ b,
                                                 float* __restrict__ gx, int M, int N, int K) {
  using namespace wide;
  __shared__ __align__(16) float xt[kTileK][kTileM + 4];  // the x tile, transposed: [k][m]
  __shared__ __align__(16) float wt[kTileK][kTileN + 4];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = t; i < kTileM * kTileK; i += 256) {
      const int m = i / kTileK, k = i % kTileK;
      xt[k][m] = (m0 + m < M && k0 + k < K) ? xs[(size_t)(m0 + m) * K + k0 + k] : 0.0f;
    }
    for (int i = t; i < kTileK * kTileN; i += 256) {
      const int k = i / kTileN, n = i % kTileN;
      wt[k][n] = (k0 + k < K && n0 + n < N) ? wx[(size_t)(k0 + k) * N + n0 + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xt[k][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&wt[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) gx[(size_t)m * N + n] = acc[i][j] + b[n];
    }
  }
}

// The same for M <= kSkinnyRows: lane `lane` of every warp owns output column
// 32 blockIdx.x + lane; warp w sums k = w, w + 8, ... in increasing k for every
// row, and the 8 warps' partial sums are added in warp order, then b. k goes in
// rounds of kSkinnyK: each warp loads its kSkinnyK / 8 values of wx first, so
// that they are in flight together, while the block stages x^T of the round
// (zero past M and past K) in shared memory, read back as float4 broadcasts.
__global__ void __launch_bounds__(256) gru_wide_gx_skinny_kernel(const float* __restrict__ xs,
                                                        const float* __restrict__ wx,
                                                        const float* __restrict__ b,
                                                        float* __restrict__ gx, int M, int N,
                                                        int K) {
  using namespace wide;
  constexpr int kQ = kSkinnyK / kWarps;  // a warp's k a round
  __shared__ __align__(16) float xt[kSkinnyK][kSkinnyRows];
  __shared__ float part[kWarps][kSkinnyRows][kSkinnyCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kSkinnyCols + lane;
  const bool ok = n < N;
  float acc[kSkinnyRows];
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m) acc[m] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kSkinnyK) {
    float w[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = k0 + warp + kWarps * q;
      w[q] = ok && k < K ? __ldg(wx + (size_t)k * N + n) : 0.0f;
    }
    __syncthreads();  // every warp is done with the previous round's x
    for (int i = threadIdx.x; i < kSkinnyRows * kSkinnyK; i += blockDim.x) {
      const int k = i / kSkinnyRows, m = i % kSkinnyRows;
      xt[k][m] = m < M && k0 + k < K ? xs[(size_t)m * K + k0 + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4* x4 = reinterpret_cast<const float4*>(xt[warp + kWarps * q]);
#pragma unroll
      for (int v = 0; v < kSkinnyRows / 4; ++v) {
        const float4 x = x4[v];
        acc[4 * v] = fmaf(x.x, w[q], acc[4 * v]);
        acc[4 * v + 1] = fmaf(x.y, w[q], acc[4 * v + 1]);
        acc[4 * v + 2] = fmaf(x.z, w[q], acc[4 * v + 2]);
        acc[4 * v + 3] = fmaf(x.w, w[q], acc[4 * v + 3]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m)
    if (m < M) part[warp][m][lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kSkinnyCols; i += blockDim.x) {
    const int m = i / kSkinnyCols, c = i % kSkinnyCols, col = blockIdx.x * kSkinnyCols + c;
    if (col >= N) continue;
    float s = part[0][m][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][m][c];
    gx[(size_t)m * N + col] = s + b[col];
  }
}

// The recurrence over gx: one cluster a tile of kRows batch rows (see the top).
template <bool FLOW>
__global__ void __launch_bounds__(wide::kWarps * 32, 1)
    gru_wide_kernel(const float* __restrict__ gx, const float* __restrict__ h0,
                    const float* __restrict__ wh, const float* __restrict__ time_scale,
                    const float* __restrict__ dts, float* __restrict__ hs, int B, int T, int H) {
  using namespace wide;
  constexpr int NA = 2 * kWarpUnits * kRows;  // a warp's r and z sums: (gate, unit, row)
  constexpr int NB = kWarpUnits * kRows;      // its candidate sums: (unit, row)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / kCluster) * kRows, H3 = 3 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit0 = rank * kUnits + kWarpUnits * warp;  // the warp's first unit
  const Layout L;
  float* hbuf = smem + L.h;    // h_t in hbuf[t % 2]
  float* rhbuf = smem + L.rh;  // r*h_t in rhbuf[t % 2]
  const uint32_t bar = wide::smem_addr(smem + L.bar);  // h[0], h[1], r*h[0], r*h[1]: 8 bytes apart
  constexpr int kStepBytes = kRows * kRowBytes;

  // the warp's recurrent columns, this lane's k = 128 p + 4 lane + e at [4 p + e]
  // (zero past H): r and z of its 4 units, then c; a gate's 4 units are one
  // float4 of a row of wh where H and wh are 16-byte aligned
  float wrz[2 * kWarpUnits][kLaneK], wcand[kWarpUnits][kLaneK];
  const bool vec = (H & 3) == 0 && (reinterpret_cast<uintptr_t>(wh) & 15) == 0;
#pragma unroll
  for (int i = 0; i < kLaneK; ++i) {
    const int k = (i / 4) * kPass + 4 * lane + i % 4;
    const float* row = wh + (size_t)k * H3 + unit0;
    if (vec) {
      const bool ok = k < H && unit0 < H;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 r = ok ? __ldg(reinterpret_cast<const float4*>(row)) : zero;
      const float4 z = ok ? __ldg(reinterpret_cast<const float4*>(row + H)) : zero;
      const float4 c = ok ? __ldg(reinterpret_cast<const float4*>(row + 2 * H)) : zero;
      wrz[0][i] = r.x, wrz[1][i] = r.y, wrz[2][i] = r.z, wrz[3][i] = r.w;
      wrz[4][i] = z.x, wrz[5][i] = z.y, wrz[6][i] = z.z, wrz[7][i] = z.w;
      wcand[0][i] = c.x, wcand[1][i] = c.y, wcand[2][i] = c.z, wcand[3][i] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < kWarpUnits; ++j) {
        const bool ok = k < H && unit0 + j < H;
        wrz[j][i] = ok ? __ldg(row + j) : 0.0f;
        wrz[kWarpUnits + j][i] = ok ? __ldg(row + H + j) : 0.0f;
        wcand[j][i] = ok ? __ldg(row + 2 * H + j) : 0.0f;
      }
    }
  }
  // h_0 into h[0] (zero past H and past B); the barriers, each armed for its first phase
  for (int i = threadIdx.x; i < kRows * kMaxHidden; i += blockDim.x) {
    const int r = i / kMaxHidden, k = i % kMaxHidden;
    hbuf[i] = (k < H && b0 + r < B) ? h0[(size_t)(b0 + r) * H + k] : 0.0f;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) wide::bar_init(bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i) wide::bar_arm(bar + 8 * i, kStepBytes);
  }

  // the sum this lane finishes in each phase
  const int va = lane % NA, ja = (va / kRows) % kWarpUnits, ra = va % kRows, ga = va / NB;
  const int ua = unit0 + ja, row_a = b0 + ra;  // unit and batch row
  const bool ok_a = ua < H && row_a < B;
  const int vb = lane % NB, jb = vb / kRows, rb = vb % kRows;
  const int ub = unit0 + jb, row_b = b0 + rb;
  const bool ok_b = ub < H && row_b < B;
  const float sp = FLOW && ok_b ? softplus(time_scale[ub]) : 0.0f;
  const float* gx_a = gx + (size_t)row_a * T * H3 + ga * H + ua;  // step t at + t * H3
  const float* gx_b = gx + (size_t)row_b * T * H3 + 2 * H + ub;
  float next_a = ok_a ? __ldg(gx_a) : 0.0f;
  float next_b = ok_b ? __ldg(gx_b) : 0.0f;
  float next_dt = FLOW ? __ldg(dts) : 0.0f;
  // lane d < 16 pushes to block d: its buffers and barriers there
  const int peer = lane % kCluster;
  const uint32_t h_peer = wide::peer_addr(wide::smem_addr(hbuf), peer);
  const uint32_t rh_peer = wide::peer_addr(wide::smem_addr(rhbuf), peer);
  const uint32_t bar_peer = wide::peer_addr(bar, peer);

  cluster.sync();  // every block of the cluster runs, its barriers initialized and armed
  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    const float gxa = next_a, gxb = next_b;
    const float pa = FLOW ? tanhf(sp * next_dt) * kInvLipschitzAlpha : 0.0f;
    if (t + 1 < T) {  // the next step's terms, loaded while this one runs
      next_a = ok_a ? __ldg(gx_a + (size_t)(t + 1) * H3) : 0.0f;
      next_b = ok_b ? __ldg(gx_b + (size_t)(t + 1) * H3) : 0.0f;
      if (FLOW) next_dt = __ldg(dts + t + 1);
    }
    if (t > 0) {  // h_t from every block (phase (t - 1) / 2 of h[par]), then re-armed for h_{t+2}
      wide::bar_wait(bar + 8 * par, ((t - 1) >> 1) & 1);
      if (threadIdx.x == 0) wide::bar_arm(bar + 8 * par, kStepBytes);
    }
    const float* h = hbuf + par * kRows * kMaxHidden;

    // r and z of the warp's units from the whole h; r*h of them into every block
    float acc_a[NA];
    wide::products<2 * kWarpUnits>(wrz, h, acc_a);
    const float gate = sigmoid(gxa + wide::reduce_scatter<NA>(acc_a));
    const float rh = ok_a ? gate * h[ra * kMaxHidden + ua] : 0.0f;  // read by the r lanes
    wide::push_rows(rh, rh_peer + 4u * (unsigned)(par * kRows * kMaxHidden), bar_peer + 8 * (2 + par),
                    unit0);

    // every block's r*h_t (phase t / 2 of r*h[par]), then re-armed for r*h_{t+2}
    wide::bar_wait(bar + 8 * (2 + par), (t >> 1) & 1);
    if (threadIdx.x == 0) wide::bar_arm(bar + 8 * (2 + par), kStepBytes);
    const float* rhrow = rhbuf + par * kRows * kMaxHidden;
    float acc_b[NB];
    wide::products<kWarpUnits>(wcand, rhrow, acc_b);
    const float cand = tanhf(gxb + wide::reduce_scatter<NB>(acc_b));
    const float z = __shfl_sync(kFull, gate, NB + vb);  // the z lane of this lane's (unit, row)
    const float hb = h[rb * kMaxHidden + ub];
    float h_new;
    if (FLOW) {
      h_new = hb + pa * (1.0f - z) * (cand - hb);
    } else {  // both products rounded, as the plain version: no FMA to pick
      h_new = __fadd_rn(__fmul_rn(1.0f - z, cand), __fmul_rn(z, hb));
    }
    h_new = ok_b ? h_new : 0.0f;
    if (t + 1 < T)  // h_{t+1} into every block's other h buffer
      wide::push_rows(h_new, h_peer + 4u * (unsigned)((1 - par) * kRows * kMaxHidden),
                      bar_peer + 8 * (1 - par), unit0);
    if (lane < NB && ok_b) hs[((size_t)row_b * T + t) * H + ub] = h_new;
  }
  cluster.sync();  // no block leaves while a peer may still write into its shared memory
}

// The dynamic shared memory of a gru_wide_kernel block, in bytes (exported as
// gru_scan_wide_smem_bytes); the same at every H.
static size_t gru_wide_smem() { return wide::Layout().total * sizeof(float); }

// static: internal linkage, so each library keeps its own records
template <bool FLOW>
static cudaError_t launch_gru_wide(const float* gx, const float* h0, const float* wh,
                                   const float* time_scale, const float* dts, float* hs, int B,
                                   int T, int H, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  static bool non_portable[wc::kMaxDevices] = {};
  static ClusterFit fit;
  const size_t smem = gru_wide_smem();
  auto kernel = &gru_wide_kernel<FLOW>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= wc::kMaxDevices || !non_portable[dev]) {  // a cluster of 16 is non-portable
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < wc::kMaxDevices) non_portable[dev] = true;
  }
  const unsigned clusters = (unsigned)((B + wide::kRows - 1) / wide::kRows);
  return launch_clusters(kernel, wide::kCluster, clusters, 32 * wide::kWarps, smem, stream, fit,
                         gx, h0, wh, time_scale, dts, hs, B, T, H);
}

}  // namespace repro

extern "C" long long gru_scan_wide_smem_bytes(int H) {
  (void)H;
  return (long long)repro::gru_wide_smem();
}

// xs [B, T, D], h0 [B, H], wx [D, 3H], wh [H, 3H], b [3H], time_scale [H],
// dts [T]; gx [B, T, 3H] is the caller's scratch, hs [B, T, H] the output.
// Two launches on `stream`: the gx kernel (skinny at B*T <= kSkinnyRows), then
// gru_wide_kernel.
extern "C" int gru_scan_wide_launch(const float* xs, const float* h0, const float* wx,
                                    const float* wh, const float* b, const float* time_scale,
                                    const float* dts, float* gx, float* hs, int B, int T, int D,
                                    int H, int flow, void* stream) {
  using namespace repro::wide;
  if (B < 1 || T < 1 || D < 1 || H < 1 || H > kMaxHidden ||
      (long long)B * T > (long long)kTileM * 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int M = B * T, N = 3 * H;
  if (M <= kSkinnyRows)
    repro::gru_wide_gx_skinny_kernel<<<(N + kSkinnyCols - 1) / kSkinnyCols, 32 * kWarps, 0, s>>>(
        xs, wx, b, gx, M, N, D);
  else
    repro::gru_wide_gx_kernel<<<dim3((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM), 256, 0,
                                s>>>(xs, wx, b, gx, M, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto launch = flow ? &repro::launch_gru_wide<true> : &repro::launch_gru_wide<false>;
  return (int)launch(gx, h0, wh, time_scale, dts, hs, B, T, H, s);
}
