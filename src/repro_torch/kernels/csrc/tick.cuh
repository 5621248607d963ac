// The ingest, the readout and the cluster launch of a banked service tick,
// shared by mr_tick.cu and mr_tick_int8.cu: warp-cell kernels that spread a
// slot's windows over a thread-block cluster, whose leader rolls the buffers
// (tick_roll) and reads the slot out (tick_readout), and whose warps build
// their own windows (tick_x).
//
// Counterpart of the code around the cell in repro/kernels/mr_step/tick.py
// _mr_tick_kernel (:86-142) and _mr_tick_q_kernel (:251-310).
#pragma once

#include <math.h>

#include "common.cuh"

namespace repro {

// Row `row` of a rolled buffer: buf [L, w] keeps its rows C.., then chunk [C, w].
__device__ __forceinline__ float rolled(const float* __restrict__ buf,
                                        const float* __restrict__ chunk, int row, int col,
                                        int keep, int C, int w) {
  return row < keep ? buf[(row + C) * w + col] : chunk[(row - keep) * w + col];
}

// Slot s's rolled buffers written out (y, and u when m > 0), from the
// pre-roll buffers and the chunks, by threads t, t + nt, ...
__device__ inline void tick_roll(const float* __restrict__ buf_y, const float* __restrict__ new_y,
                                 const float* __restrict__ buf_u, const float* __restrict__ new_u,
                                 float* __restrict__ buf_y_out, float* __restrict__ buf_u_out,
                                 int s, int L, int n, int m, int C, int t, int nt) {
  const int keep = L - C;
  const float* by = buf_y + (size_t)s * L * n;
  const float* ny = new_y + (size_t)s * C * n;
  for (int i = t; i < L * n; i += nt)
    buf_y_out[(size_t)s * L * n + i] = rolled(by, ny, i / n, i % n, keep, C, n);
  if (m == 0) return;
  const float* bu = buf_u + (size_t)s * L * m;
  const float* nu = new_u + (size_t)s * C * m;
  for (int i = t; i < L * m; i += nt)
    buf_u_out[(size_t)s * L * m + i] = rolled(bu, nu, i / m, i % m, keep, C, m);
}

// Element (t, d) of window w of slot s's normalized window set [N, T, n + m],
// from the pre-roll buffers and the chunks: y normalized with the mean and
// scale frozen at admission (an IEEE division, as the plain version), u raw.
__device__ __forceinline__ float tick_x(const float* __restrict__ buf_y,
                                        const float* __restrict__ new_y,
                                        const float* __restrict__ buf_u,
                                        const float* __restrict__ new_u,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ scale, int s, int w, int t,
                                        int d, int L, int n, int m, int C, int stride) {
  const int keep = L - C, row = w * stride + t;
  if (d < n)
    return (rolled(buf_y + (size_t)s * L * n, new_y + (size_t)s * C * n, row, d, keep, C, n) -
            mean[s * n + d]) / scale[s * n + d];
  return rolled(buf_u + (size_t)s * L * m, new_u + (size_t)s * C * m, row, d - n, keep, C, m);
}

// Slot s's readout from the head output out [N, Ko] in shared memory: the
// mean over windows of the first Kc outputs, blended into the previous
// readout (EMA) or seeding it on the slot's first tick, then
// delta = max|theta - theta0| / (max|theta| + 1e-3), inf for an inactive
// slot. Warp 0 of a block calls it, after a barrier that published out.
__device__ inline void tick_readout(const float* out, const float* __restrict__ theta0,
                                    const float* __restrict__ seed,
                                    const float* __restrict__ active,
                                    float* __restrict__ theta_out, float* __restrict__ delta_out,
                                    int s, int N, int Ko, int Kc, float ema,
                                    float one_minus_ema) {
  const int lane = threadIdx.x;
  const bool first = seed[s] > 0.0f;
  float change = 0.0f, mag = 0.0f;
  for (int c = lane; c < Kc; c += 32) {
    float acc = 0.0f;
    for (int w = 0; w < N; ++w) acc += out[w * Ko + c];
    const float raw = acc / (float)N;
    const float prev = theta0[(size_t)s * Kc + c];
    // no fused multiply-add: the plain version rounds each product
    const float th = first ? raw : __fadd_rn(__fmul_rn(ema, prev), __fmul_rn(one_minus_ema, raw));
    theta_out[(size_t)s * Kc + c] = th;
    change = fmaxf(change, fabsf(th - prev));
    mag = fmaxf(mag, fabsf(th));
  }
  for (int off = 16; off > 0; off >>= 1) {
    change = fmaxf(change, __shfl_xor_sync(0xffffffffu, change, off));
    mag = fmaxf(mag, __shfl_xor_sync(0xffffffffu, mag, off));
  }
  if (lane == 0) delta_out[s] = active[s] > 0.0f ? change / (mag + 1e-3f) : INFINITY;
}

// The launchers' shared refusals (cudaErrorInvalidValue when true).
inline bool tick_geometry_bad(int S, int L, int n, int m, int C, int T, int stride, int Ko,
                              int Kc, int bank, const float* buf_u, const float* new_u,
                              const float* buf_u_out) {
  return bank < 1 || S % bank != 0 || T < 1 || T > L || C < 1 || C > L || stride < 1 || Kc > Ko ||
         n < 1 || m < 0 || (m > 0 && (!buf_u || !new_u || !buf_u_out));
}

// The cluster shape a launcher last found to fit on a device.
struct ClusterFit {
  int dev = -1;
  unsigned blocks = 0, threads = 0;
  size_t smem = 0;
};

// cudaErrorInvalidConfiguration unless at least one cluster of cfg's shape
// can be resident on the current device; asked once a shape.
template <typename Kernel>
static cudaError_t cluster_fits_once(Kernel kernel, const cudaLaunchConfig_t& cfg,
                                     unsigned blocks, ClusterFit& fit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (fit.dev == dev && fit.blocks == blocks && fit.threads == cfg.blockDim.x &&
      fit.smem == cfg.dynamicSmemBytes)
    return cudaSuccess;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  fit = {dev, blocks, cfg.blockDim.x, cfg.dynamicSmemBytes};
  return cudaSuccess;
}

// Launches `kernel` with cudaLaunchKernelEx on `clusters` clusters of `cs`
// blocks of `threads` threads and `smem` bytes of dynamic shared memory each,
// once cluster_fits_once has found the shape to fit.
template <typename Kernel, typename... Args>
static cudaError_t launch_clusters(Kernel kernel, unsigned cs, unsigned clusters, unsigned threads,
                                   size_t smem, cudaStream_t stream, ClusterFit& fit,
                                   Args... args) {
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = cs;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  cudaError_t err = cluster_fits_once(kernel, cfg, cs, fit);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace repro
