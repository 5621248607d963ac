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
// 1. gru_wide_gx_kernel, the h-independent terms: gx [B*T, 3H] = xs . wx + b, a tiled
//    float32 GEMM (64 x 64 output tiles, 16-deep k tiles staged in shared
//    memory, 4 x 4 outputs a thread). At the bootstrap prefill it is 4,096 x
//    512 x 1,536, 6.4 GFLOP, bound by the FMA units.
// 2. gru_wide_kernel, the recurrence: a thread-block cluster of kCluster = 16
//    blocks runs kRows = 1 batch row through all T steps (a cluster a row);
//    block `rank` owns hidden units [32 rank, 32 rank + 32) and holds their r,
//    z and c columns of wh in shared memory, column-major (3 x 32 x (Hp + 4)
//    floats, 198 KB at H = 512), beside the row's h and r*h (every unit) and
//    its own z. A warp owns 4 of the block's units, the lanes split the
//    512-deep products (4 consecutive k a lane, 128 a pass), and a halving
//    shuffle exchange leaves each lane one finished sum. One step:
//      - every block forms its units' r and z from the whole h;
//      - it writes r*h of its units into every block's r*h rows through
//        distributed shared memory (cluster.map_shared_rank), cluster.sync();
//      - it forms c and the (flow) update for its units and writes the new h
//        the same way, stores hs[:, t] for its units, cluster.sync().
//    The flow gate's phi(dt) * alpha = tanh(softplus(time_scale) dt) * 0.4 is
//    computed beside the step, off its chain, as are the next step's gx loads.
//
// What bounds it on an H100: the recurrence's chain, not the roofline. At the
// bootstrap prefill the call is 12.9 GFLOP and ~23 MB a layer (0.19 ms at 67
// TFLOP/s of float32), but its T steps are dependent: each is two 512-deep
// products split over the cluster, two cluster barriers, a sigmoid and a tanh
// (~1,650 cycles reckoned). On the card a step takes ~8,000 cycles, and each
// more row a cluster adds ~6,000 (PERF.md; launch/kernel_phases.py builds
// kRows = 2 and 4 as variants): the per-row work, which includes each block's
// 4-byte distributed shared-memory stores (a row's 32 values a block to all 16
// blocks, twice a step), and not the barriers, is most of it. So one row a
// cluster is built.
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
constexpr int kWarpUnits = kUnits / kWarps;     // hidden units a warp
constexpr int kMaxHidden = kCluster * kUnits;   // 512
constexpr int kPass = 128;                      // k a warp covers in one pass: 32 lanes x 4
constexpr int kMaxPasses = kMaxHidden / kPass;  // 4
constexpr int kTileM = 64, kTileN = 64, kTileK = 16;  // gru_wide_gx_kernel's tiles
constexpr unsigned kFull = 0xffffffffu;

// H rounded up to whole passes: the rows' and columns' length in shared memory
__host__ __device__ inline int padded(int H) { return (H + kPass - 1) / kPass * kPass; }
// floats between two weight columns: a whole number of float4s, 4 mod 32
__host__ __device__ inline int col_stride(int H) { return padded(H) + 4; }

// A block's carve in floats: its units' wh columns [3 * kUnits][col_stride],
// the tile's h and r*h rows [kRows][padded(H)] each, its units' z [kRows][kUnits].
struct Layout {
  size_t w, h, rh, z, total;
  __host__ __device__ explicit Layout(int H) {
    w = 0;
    h = w + (size_t)3 * kUnits * col_stride(H);
    rh = h + (size_t)kRows * padded(H);
    z = rh + (size_t)kRows * padded(H);
    total = z + (size_t)kRows * kUnits;
  }
};

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

// acc[(c * R) + r] += this lane's k of column c of the block's weights times
// row r, for the warp's NC columns cols[c] and R rows `rows`.
template <int NC, int R>
__device__ __forceinline__ void partial_products(const float* w, int S, const int (&cols)[NC],
                                                 const float4 (&rows)[R][kMaxPasses], int passes,
                                                 float (&acc)[NC * R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NC * R; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p >= passes) break;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(w + cols[c] * S + p * kPass + 4 * lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = acc[c * R + r];
        a = fmaf(wv.x, rows[r][p].x, a);
        a = fmaf(wv.y, rows[r][p].y, a);
        a = fmaf(wv.z, rows[r][p].z, a);
        a = fmaf(wv.w, rows[r][p].w, a);
        acc[c * R + r] = a;
      }
    }
  }
}

// This lane's k of each of the R rows of `rows` [R][padded(H)].
template <int R>
__device__ __forceinline__ void load_rows(const float* rows, int Hp, int passes,
                                          float4 (&out)[R][kMaxPasses]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < passes)
        out[r][p] = *reinterpret_cast<const float4*>(rows + r * Hp + p * kPass + 4 * lane);
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
  const int b0 = (int)(blockIdx.x / kCluster) * kRows, u0 = rank * kUnits;
  const int Hp = padded(H), S = col_stride(H), passes = Hp / kPass, H3 = 3 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout L(H);
  float* w = smem + L.w;
  float* hrow = smem + L.h;
  float* rhrow = smem + L.rh;
  float* zrow = smem + L.z;

  // staging: this block's r, z and c columns of wh (zero past H), kStage loads
  // in flight a thread; the tile's h0 rows (zero past H and past B) and zero r*h
  // rows
  constexpr int kStage = 8;
  const int n_w = 3 * kUnits * Hp;
  for (int i0 = threadIdx.x; i0 < n_w; i0 += kStage * blockDim.x) {
    float v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = i0 + q * blockDim.x;
      const int u = i % kUnits, k = (i / kUnits) % Hp, g = i / (kUnits * Hp), col = u0 + u;
      v[q] = (i < n_w && k < H && col < H) ? __ldg(wh + (size_t)k * H3 + g * H + col) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = i0 + q * blockDim.x;
      const int u = i % kUnits, k = (i / kUnits) % Hp, g = i / (kUnits * Hp);
      if (i < n_w) w[(g * kUnits + u) * S + k] = v[q];
    }
  }
  for (int i = threadIdx.x; i < kRows * Hp; i += blockDim.x) {
    const int r = i / Hp, k = i % Hp;
    hrow[i] = (k < H && b0 + r < B) ? h0[(size_t)(b0 + r) * H + k] : 0.0f;
    rhrow[i] = 0.0f;
  }

  // the warp's columns: unit warp + 8 j of the block, gates r and z, then c
  int cols_rz[2 * kWarpUnits], cols_c[kWarpUnits];
#pragma unroll
  for (int j = 0; j < kWarpUnits; ++j) {
    cols_rz[j] = warp + kWarps * j;
    cols_rz[kWarpUnits + j] = kUnits + warp + kWarps * j;
    cols_c[j] = 2 * kUnits + warp + kWarps * j;
  }
  // the sum this lane finishes in each phase, and which of its copies it is
  const int va = lane % NA, ca = lane / NA, nca = 32 / NA;
  const int ga = va / (kWarpUnits * kRows), ja = (va / kRows) % kWarpUnits, ra = va % kRows;
  const int ua = u0 + warp + kWarps * ja, row_a = b0 + ra;  // unit and batch row
  const bool ok_a = ua < H && row_a < B;
  const int vb = lane % NB, cb = lane / NB, ncb = 32 / NB;
  const int jb = vb / kRows, rb = vb % kRows;
  const int ub = u0 + warp + kWarps * jb, row_b = b0 + rb;
  const bool ok_b = ub < H && row_b < B;
  const float sp = FLOW && ok_b ? softplus(time_scale[ub]) : 0.0f;
  const float* gx_a = gx + (size_t)row_a * T * H3 + ga * H + ua;  // step t at + t * H3
  const float* gx_b = gx + (size_t)row_b * T * H3 + 2 * H + ub;
  float next_a = ok_a ? __ldg(gx_a) : 0.0f;
  float next_b = ok_b ? __ldg(gx_b) : 0.0f;
  float next_dt = FLOW ? __ldg(dts) : 0.0f;

  cluster.sync();  // every block of the cluster runs and has staged its rows
  for (int t = 0; t < T; ++t) {
    const float gxa = next_a, gxb = next_b;
    const float pa = FLOW ? tanhf(sp * next_dt) * kInvLipschitzAlpha : 0.0f;
    if (t + 1 < T) {  // the next step's terms, loaded while this one runs
      next_a = ok_a ? __ldg(gx_a + (size_t)(t + 1) * H3) : 0.0f;
      next_b = ok_b ? __ldg(gx_b + (size_t)(t + 1) * H3) : 0.0f;
      if (FLOW) next_dt = __ldg(dts + t + 1);
    }

    // r and z of the warp's units from the whole h
    float4 rows[kRows][kMaxPasses];
    wide::load_rows<kRows>(hrow, Hp, passes, rows);
    float acc_a[NA];
    wide::partial_products<2 * kWarpUnits, kRows>(w, S, cols_rz, rows, passes, acc_a);
    const float gate = sigmoid(gxa + wide::reduce_scatter<NA>(acc_a));
    if (ga == 0) {  // r: r*h of this unit into every block's r*h rows
      if (ok_a) {
        const float rh = gate * hrow[ra * Hp + ua];
        for (int d = ca; d < kCluster; d += nca)
          cluster.map_shared_rank(rhrow, d)[ra * Hp + ua] = rh;
      }
    } else if (ca == 0) {
      zrow[ra * kUnits + warp + kWarps * ja] = gate;
    }
    cluster.sync();  // every r*h has arrived; every block is done reading h

    // the candidate from r*h, and the update
    wide::load_rows<kRows>(rhrow, Hp, passes, rows);
    float acc_b[NB];
    wide::partial_products<kWarpUnits, kRows>(w, S, cols_c, rows, passes, acc_b);
    const float cand = tanhf(gxb + wide::reduce_scatter<NB>(acc_b));
    const float z = zrow[rb * kUnits + warp + kWarps * jb];
    const float h = ok_b ? hrow[rb * Hp + ub] : 0.0f;
    __syncwarp();  // every copy has read h before any writes its unit's new h here
    float h_new;
    if (FLOW) {
      h_new = h + pa * (1.0f - z) * (cand - h);
    } else {  // both products rounded, as the plain version: no FMA to pick
      h_new = __fadd_rn(__fmul_rn(1.0f - z, cand), __fmul_rn(z, h));
    }
    if (ok_b) {
      for (int d = cb; d < kCluster; d += ncb) cluster.map_shared_rank(hrow, d)[rb * Hp + ub] = h_new;
      if (cb == 0) hs[((size_t)row_b * T + t) * H + ub] = h_new;
    }
    cluster.sync();  // the new h is in every block; every block is done reading r*h
  }
}

// The dynamic shared memory of a gru_wide_kernel block, in bytes (exported as
// gru_scan_wide_smem_bytes).
static size_t gru_wide_smem(int H) { return wide::Layout(H).total * sizeof(float); }

// static: internal linkage, so each library keeps its own records
template <bool FLOW>
static cudaError_t launch_gru_wide(const float* gx, const float* h0, const float* wh,
                                   const float* time_scale, const float* dts, float* hs, int B,
                                   int T, int H, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  static bool non_portable[wc::kMaxDevices] = {};
  static ClusterFit fit;
  const size_t smem = gru_wide_smem(H);
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
  return (long long)repro::gru_wide_smem(H);
}

// xs [B, T, D], h0 [B, H], wx [D, 3H], wh [H, 3H], b [3H], time_scale [H],
// dts [T]; gx [B, T, 3H] is the caller's scratch, hs [B, T, H] the output.
// Two launches on `stream`: gru_wide_gx_kernel, then gru_wide_kernel.
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
  repro::gru_wide_gx_kernel<<<dim3((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM), 256, 0, s>>>(
      xs, wx, b, gx, M, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto launch = flow ? &repro::launch_gru_wide<true> : &repro::launch_gru_wide<false>;
  return (int)launch(gx, h0, wh, time_scale, dts, hs, B, T, H, s);
}
