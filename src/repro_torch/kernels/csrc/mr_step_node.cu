// Stage-fused NODE (ODE-RNN) recovery step: K Euler substeps of a tanh-MLP
// vector field and the input injection per input step -> RMS-norm ->
// optional Qm.n activation step -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:541 mr_step_node_pallas (body
// _mr_step_node_kernel, :492-535; step _node_step_math, :474-489). Per input
// step t and window:
//
//   K times: z = tanh(h . W_f1 + b_f1)
//            h = h + sub_dt * (z . W_f2 + b_f2)
//   then     h = h + (x_t . W_in + b_in)
//
// with sub_dt the float32 Euler substep handed in by the wrapper and K a
// runtime int. Then the head on h_T. The substep loop takes a compile-time
// unroll factor UNROLL (wc::substeps; any K runs at each factor, and no factor
// changes a bit of the result); only UNROLL = 1 is instantiated, since 2 and 6
// measured no faster on an H100 (6 slower at H = 64).
//
// A warp-per-window recurrence (warp_cell.cuh): a block of `bb` windows
// stages w_f1, w_f2, w_in, the biases and the head weights once; each warp
// runs its window's T * K substeps and the head with no block barrier. A
// substep's chain is h.W_f1 (four partial sums an output, from registers at
// H <= 32), tanh, z.W_f2 and the Euler update; the injection x_t.W_in + b_in
// was computed before the chunk of steps and joins the last substep's update.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each two H x H matvecs a window: ~54 MFLOP at B=64, T=32,
// H=32, K=6, under a microsecond of the card's float32 rate. The only
// device-memory traffic is x in and the head output out.
//
// One launch runs S stages (the batching rule jax.vmap gives
// mr_step_node_pallas), each on its own windows and weights, grid (B / bb, S);
// a single call is S = 1. Every operand has a slot stride, 0 for one shared by
// all slots (h0); block (x, s) offsets the pointers by slot s (wc::slot_at)
// and runs node_windows, the body, unchanged.
#include "warp_cell.cuh"

namespace repro {

// Block blockIdx.x's windows of one call: the kernel's body.
template <int N, int UNROLL>
__device__ __forceinline__ void node_windows(
    const float* __restrict__ xs, const float* __restrict__ h0, const float* __restrict__ w_f1,
    const float* __restrict__ b_f1, const float* __restrict__ w_f2,
    const float* __restrict__ b_f2, const float* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int T,
    int D, int H_rt, int Dh, int K, int bb, int n_substeps, float sub_dt, int act_int,
    int act_frac) {
  constexpr int U = N > 0 ? (N + 31) / 32 : wc::kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // the field's columns fit in registers
  constexpr int kC = wc::kChunk;
  const int H = wc::width<N>(H_rt), S = wc::col_stride(H);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wc::NodeLayout L(D, H, Dh, K, bb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * bb;
  float* area = smem + L.warps + warp * L.per_warp;

  // a window's x chunk [t0, t0 + kC) into slot s of the warp's area
  auto stage_chunk = [&](int s, int window, int t0) {
    const int nc = min(kC, T - t0);
    float* dst = area + (s ? L.xbuf[1] : L.xbuf[0]);
    wc::copy_async(dst, xs + ((size_t)window * T + t0) * D, nc * D, lane, 32);
  };

  // staging: the weights by every thread, each warp's first x chunk by the warp
  if constexpr (REG) {  // read once into registers: row-major, 16-byte copies
    wc::copy_async(smem + L.wf1, w_f1, H * H, threadIdx.x, blockDim.x);
    wc::copy_async(smem + L.wf2, w_f2, H * H, threadIdx.x, blockDim.x);
  } else {  // read every substep: column-major, a float4 of a column per load
    wc::copy_columns_async(smem + L.wf1, w_f1, H, H, S, threadIdx.x, blockDim.x);
    wc::copy_columns_async(smem + L.wf2, w_f2, H, H, S, threadIdx.x, blockDim.x);
  }
  wc::copy_async(smem + L.win, w_in, D * H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.bf1, b_f1, H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.bf2, b_f2, H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.bin, b_in, H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.head.w1, w1, H * Dh, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.head.b1, b1, Dh, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.head.w2, w2, Dh * K, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.head.b2, b2, K, threadIdx.x, blockDim.x);
  stage_chunk(0, b0 + warp, 0);
  cp_async_commit();
  const wc::Units<U> un(H);
  float h_next[U];  // the warp's next window's h0, loaded ahead of its use
  wc::load_h0(un, h_next, h0 + (size_t)(b0 + warp) * H);
  cp_async_wait<0>();
  __syncthreads();  // the block's only barrier

  // column j of w_f1 (f = 0) or w_f2 (f = 1), k = 4q .. 4q + 3, from the
  // column-major copies
  const float4* wf1_4 = reinterpret_cast<const float4*>(smem + L.wf1);
  const float4* wf2_4 = reinterpret_cast<const float4*>(smem + L.wf2);
  auto wf_at = [&](int f, int q, int u) { return (f ? wf2_4 : wf1_4)[un.col[u] * (S / 4) + q]; };
  const float* wins = smem + L.win;
  float bf1[U], bf2[U], bin[U];
  float4 wr[REG ? 2 : 1][U][REG ? N / 4 : 1];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bf1[u] = smem[L.bf1 + un.col[u]];
    bf2[u] = smem[L.bf2 + un.col[u]];
    bin[u] = smem[L.bin + un.col[u]];
    if constexpr (REG) {
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float* w = smem + (f ? L.wf2 : L.wf1) + 4 * q * H + un.col[u];  // row-major
          wr[f][u][q] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
        }
    }
  }
  auto w_f1c = [&](int q, int, int u) {
    if constexpr (REG) return wr[0][u][q];
    else return wf_at(0, q, u);
  };
  auto w_f2c = [&](int q, int, int u) {
    if constexpr (REG) return wr[1][u][q];
    else return wf_at(1, q, u);
  };

  float* row_h = area + L.row_h;
  float* row_z = area + L.row_z;
  float* xbs = area + L.xb;
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
    for (int t0 = 0; t0 < T; t0 += kC) {
      const int nc = min(kC, T - t0);
      cp_async_wait<0>();
      __syncwarp();  // this chunk's x has arrived; row_h holds h
      // the chunk's injections x_t . W_in + b_in, each lane for its own units:
      // over d for all kC steps at once (kC independent sums), then b_in
      const float* xc = area + (slot ? L.xbuf[1] : L.xbuf[0]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nu) continue;
        float a[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) a[c] = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float w = wins[d * H + un.col[u]];
#pragma unroll
          for (int c = 0; c < kC; ++c) a[c] = fmaf(xc[c * D + d], w, a[c]);  // past nc: unread
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) xbs[(c * nu + u) * 32 + lane] = a[c] + bin[u];
      }
      // the next chunk's x (or the next window's first) while this one runs
      if (t0 + kC < T) stage_chunk(slot ^ 1, window, t0 + kC);
      else if (w + n_warps < bb) {
        stage_chunk(slot ^ 1, window + n_warps, 0);
        wc::load_h0(un, h_next, h0 + (size_t)(window + n_warps) * H);
      }
      cp_async_commit();
      slot ^= 1;

      for (int c = 0; c < nc; ++c) {
        wc::substeps<UNROLL>(n_substeps, [&](int s) {
          float a[1][U];
          wc::matvec<N, 1, U>(row_h, H, nu, w_f1c, a);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (un.own[u]) row_z[un.col[u]] = tanhf(a[0][u] + bf1[u]);
          __syncwarp();
          wc::matvec<N, 1, U>(row_z, H, nu, w_f2c, a);
          const bool inject = s == n_substeps - 1;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (u >= nu) continue;
            h[u] = h[u] + sub_dt * (a[0][u] + bf2[u]);
            if (inject) h[u] = h[u] + xbs[(c * nu + u) * 32 + lane];
            if (un.own[u]) row_h[un.col[u]] = h[u];
          }
          __syncwarp();
        });
      }
    }
    const wc::F32Head hd{smem + L.head.w1, smem + L.head.b1, smem + L.head.w2, smem + L.head.b2,
                         Dh, K};
    wc::warp_head<N, U>(un, h, H, hd, row_h, row_z, out + (size_t)window * K, act_int, act_frac);
  }
}

template <int N, int UNROLL>
// minBlocksPerSM = 1: without it ptxas holds the H=64 instantiations to
// 64-128 registers and issues each shared load just ahead of its FMAs
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_node_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                        const float* __restrict__ w_f1, const float* __restrict__ b_f1,
                        const float* __restrict__ w_f2, const float* __restrict__ b_f2,
                        const float* __restrict__ w_in, const float* __restrict__ b_in,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        float* __restrict__ out, wc::SlotStrides<13> st, int T, int D, int H_rt,
                        int Dh, int K, int bb, int n_substeps, float sub_dt, int act_int,
                        int act_frac) {
  node_windows<N, UNROLL>(wc::slot_at(xs, st.v[0]), wc::slot_at(h0, st.v[1]),
                  wc::slot_at(w_f1, st.v[2]), wc::slot_at(b_f1, st.v[3]),
                  wc::slot_at(w_f2, st.v[4]), wc::slot_at(b_f2, st.v[5]),
                  wc::slot_at(w_in, st.v[6]), wc::slot_at(b_in, st.v[7]),
                  wc::slot_at(w1, st.v[8]), wc::slot_at(b1, st.v[9]), wc::slot_at(w2, st.v[10]),
                  wc::slot_at(b2, st.v[11]), wc::slot_at(out, st.v[12]), T, D, H_rt, Dh, K, bb,
                  n_substeps, sub_dt, act_int, act_frac);
}

// The dynamic shared memory a launch requests, in bytes: NodeLayout's carve
// (exported as mr_step_node_smem_bytes).
static size_t node_smem(int D, int H, int Dh, int K, int bb) {
  return wc::NodeLayout(D, H, Dh, K, bb).total * sizeof(float);
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N, int UNROLL>
static cudaError_t launch_node(const float* xs, const float* h0, const float* w_f1,
                               const float* b_f1, const float* w_f2, const float* b_f2,
                               const float* w_in, const float* b_in, const float* w1,
                               const float* b1, const float* w2, const float* b2, float* out,
                               const wc::SlotStrides<13>& st, int S, int B, int T, int D, int H,
                               int Dh, int K, int bb, int n_substeps, float sub_dt, int act_int,
                               int act_frac, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = node_smem(D, H, Dh, K, bb);
  auto kernel = &mr_step_node_kernel<N, UNROLL>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B / bb, S), 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, w2, b2, out, st, T, D, H, Dh, K, bb,
      n_substeps, sub_dt, act_int, act_frac);
  return cudaGetLastError();
}

// The launch at width N with the substep loop unrolled `unroll` times: one of
// the instantiated factors (kernels/mr_step/tiling.py SUBSTEP_UNROLLS), else
// cudaErrorInvalidValue. Another factor is one more case here.
template <int N, class... Args>
static cudaError_t launch_node_unrolled(int unroll, Args... args) {
  switch (unroll) {
    case 1: return launch_node<N, 1>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

extern "C" long long mr_step_node_smem_bytes(int D, int H, int Dh, int K, int bb) {
  return (long long)repro::node_smem(D, H, Dh, K, bb);
}

// Operand i of slot s at its pointer + s * its slot stride (elements; 0 =
// shared by every slot), out [S, B, K].
extern "C" int mr_step_node_launch(
    const float* xs, const float* h0, const float* w_f1, const float* b_f1, const float* w_f2,
    const float* b_f2, const float* w_in, const float* b_in, const float* w1, const float* b1,
    const float* w2, const float* b2, float* out, long long s_xs, long long s_h0,
    long long s_w_f1, long long s_b_f1, long long s_w_f2, long long s_b_f2, long long s_w_in,
    long long s_b_in, long long s_w1, long long s_b1, long long s_w2, long long s_b2, int S,
    int B, int T, int D, int H, int Dh, int K, int bb, int n_substeps, int unroll, int act_int,
    int act_frac, float sub_dt, void* stream) {
  if (S < 1 || S > repro::wc::kMaxSlots || bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1 ||
      H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
  const repro::wc::SlotStrides<13> st{{s_xs, s_h0, s_w_f1, s_b_f1, s_w_f2, s_b_f2, s_w_in, s_b_in,
                                       s_w1, s_b1, s_w2, s_b2, (long long)B * K}};
#define REPRO_NODE(N)                                                                        \
  repro::launch_node_unrolled<N>(unroll, xs, h0, w_f1, b_f1, w_f2, b_f2, w_in, b_in, w1, b1, \
                                 w2, b2, out, st, S, B, T, D, H, Dh, K, bb, n_substeps,       \
                                 sub_dt, act_int, act_frac, (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_NODE(8);
    case 32: return (int)REPRO_NODE(32);
    case 64: return (int)REPRO_NODE(64);
    default: return (int)REPRO_NODE(0);
  }
#undef REPRO_NODE
}
