// Latency probes of a thread-block cluster of 16 blocks of 256 threads on
// Hopper, for launch/kernel_phases.py (built by it alone, not part of the
// kernel library): the cycles a loop iteration of
//   kind 0: one cluster.sync();
//   kind 1: one all-to-all exchange as csrc/gru_scan_wide.cu makes it, from one
//           warp a block: lanes 0-15 each push 16 bytes into block `lane` with
//           st.async, completing on its mbarrier, and every block waits on its
//           own barrier for the 16 pushes (256 bytes) and re-arms it; two
//           buffers and two barriers alternate by the iteration's parity;
//   kind 2: the same from all 8 warps (128 pushes, 2,048 bytes a barrier phase:
//           the wide scan's exchange of one batch row);
//   kind 3: the same 2,048 bytes as one 128-byte slice a block: every warp
//           writes its 16 bytes into a local slice (by parity), __syncthreads(),
//           then lanes 0-15 of warp 0 each copy the slice into block `lane`
//           with cp.async.bulk, completing on its mbarrier.
// Each block's thread 0 reads clock64() around the loop, between two
// cluster.sync(), into cycles[blockIdx.x].
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16, kWarps = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_arm(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

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

__global__ void __launch_bounds__(kWarps * 32, 1) cluster_probe_kernel(int kind, int n,
                                                                    long long* cycles) {
  __shared__ __align__(16) float4 buf[2][kWarps][kCluster];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ __align__(128) float4 slices[2][kCluster][kWarps];  // kind 3: a slice a source block
  __shared__ __align__(128) float4 stage[2][kWarps];              // kind 3: this block's slice
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pushers = kind >= 2 ? kWarps : 1, bytes = pushers * kCluster * 16;
  const uint32_t bar = smem_addr(bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar + 8 * i) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < 2; ++i) bar_arm(bar + 8 * i, bytes);
  }
  const int peer = lane % kCluster, rank = (int)cluster.block_rank();
  const uint32_t buf_peer = peer_addr(smem_addr(buf), peer), bar_peer = peer_addr(bar, peer);
  float4 v = make_float4((float)rank, (float)warp, (float)lane, 0.0f);
  cluster.sync();
  const long long t0 = clock64();
  if (kind == 0) {
    for (int i = 0; i < n; ++i) cluster.sync();
  } else if (kind == 3) {
    const uint32_t slices_peer = peer_addr(smem_addr(slices), peer);
    for (int i = 0; i < n; ++i) {
      const int par = i & 1;
      if (lane == 0) stage[par][warp] = v;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (warp == 0 && lane < kCluster) {
        const uint32_t dst = slices_peer + 16u * (unsigned)((par * kCluster + rank) * kWarps);
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], "
            "%2, [%3];" ::"r"(dst),
            "r"(smem_addr(stage[par])), "r"(kWarps * 16), "r"(bar_peer + 8 * par)
            : "memory");
      }
      bar_wait(bar + 8 * par, (i >> 1) & 1);
      if (threadIdx.x == 0) bar_arm(bar + 8 * par, bytes);
      v.w += slices[par][(rank + 1) % kCluster][warp].x;
    }
  } else if (warp < pushers) {
    for (int i = 0; i < n; ++i) {
      const int par = i & 1;
      if (lane < kCluster) {
        const uint32_t dst = buf_peer + 16u * (unsigned)((par * kWarps + warp) * kCluster + rank);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
            "[%5];" ::"r"(dst),
            "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar_peer + 8 * par)
            : "memory");
      }
      bar_wait(bar + 8 * par, (i >> 1) & 1);
      if (threadIdx.x == 0) bar_arm(bar + 8 * par, bytes);
      v.w += buf[par][warp][(rank + 1) % kCluster].x;  // the next push waits on this one's data
    }
  }
  const long long t1 = clock64();
  cluster.sync();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0 + (long long)(v.w * 0.0f);
}

}  // namespace

// One cluster of 16 blocks on `stream`; cycles [16] receives each block's loop cycles.
extern "C" int cluster_probe_launch(int kind, int n, long long* cycles, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(cluster_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, kind, n, cycles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
