// Stage-fused MR per-window step: GRU(-flow) scan -> RMS-norm -> optional
// Qm.n activation step -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:129 mr_step_pallas (body
// _mr_step_kernel, :79-125; step gru_scan/kernel.py:42-63 _gru_step_math;
// head kernel.py:64-76 _head_math). A warp-per-window recurrence
// (warp_cell.cuh): a block of `bb` windows stages the gate weights and the
// head weights once, then each warp runs its window's T steps and the head
// with no block barrier. Per step the chain is h.Wh_{r,z} (four partial sums
// an output, from registers at H <= 32), the two sigmoids, (r*h).Wh_c, the
// candidate's tanh and the (flow) update; x.Wx + b and the flow gate's
// phi(t) * alpha were computed before the chunk of steps. Per window the only
// device-memory traffic is x in and the head output out; hs [B, T, H] is
// never written.
//
// What bounds it on an H100: the chain of T dependent steps, each a few
// hundred FMAs a window; at the quickstart the whole call is ~15 MFLOP and
// ~53 KB, under a microsecond of the card's float32 and memory rates. The
// tiling (kernels/mr_step/tiling.py) keeps at least min(B, 132) blocks.
//
// The candidate gate is tanh(x.Wx_c + (r*h).Wh_c + b_c), as in the JAX
// package, not torch.nn.GRU's r*(h.Wh_c).
#include "warp_cell.cuh"

namespace repro {

template <int N, bool FLOW>
// minBlocksPerSM = 1: without it ptxas holds the H=64 instantiations to
// 64-128 registers and issues each shared load just ahead of its FMAs
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                   const float* __restrict__ wx, const float* __restrict__ wh,
                   const float* __restrict__ b, const float* __restrict__ time_scale,
                   const float* __restrict__ dts, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int T, int D, int H_rt,
                   int Dh, int K, int bb, int act_int, int act_frac) {
  constexpr int U = N > 0 ? (N + 31) / 32 : wc::kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // the recurrent columns fit in registers
  constexpr int kC = wc::kChunk;
  const int H = wc::width<N>(H_rt), H3 = 3 * H, S = wc::col_stride(H);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wc::GruLayout L(D, H, Dh, K, bb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * bb;
  float* area = smem + L.warps + warp * L.per_warp;

  // a window's x chunk [t0, t0 + kC) and its dts into slot s of the warp's area
  auto stage_chunk = [&](int s, int window, int t0) {
    const int nc = min(kC, T - t0);
    float* dst = area + (s ? L.xbuf[1] : L.xbuf[0]);
    wc::copy_async(dst, xs + ((size_t)window * T + t0) * D, nc * D, lane, 32);
    wc::copy_async(area + (s ? L.dbuf[1] : L.dbuf[0]), dts + t0, nc, lane, 32);
  };

  // staging: the weights by every thread, each warp's first x chunk by the warp
  wc::copy_async(smem + L.wx, wx, D * H3, threadIdx.x, blockDim.x);
  if constexpr (REG)  // read once into registers: row-major, 16-byte copies
    wc::copy_async(smem + L.wh, wh, H * H3, threadIdx.x, blockDim.x);
  else  // read every step: column-major, a float4 of a column per load
    wc::copy_columns_async(smem + L.wh, wh, H, H3, S, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.b, b, H3, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.ts, time_scale, H, threadIdx.x, blockDim.x);
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

  // wh's column g * H + j, k = 4q .. 4q + 3: a float4 of the column-major copy
  const float4* wh4 = reinterpret_cast<const float4*>(smem + L.wh);
  auto wh_at = [&](int q, int g, int u) { return wh4[(g * H + un.col[u]) * (S / 4) + q]; };
  const float* wxs = smem + L.wx;
  float bias[3][U], sp[U];
  float4 wr[REG ? 3 : 1][U][REG ? N / 4 : 1];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int g = 0; g < 3; ++g) bias[g][u] = smem[L.b + g * H + un.col[u]];
    sp[u] = softplus(smem[L.ts + un.col[u]]);
    if constexpr (REG) {
      const float* c = smem + L.wh + un.col[u];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float* w = c + g * H + 4 * q * H3;  // row-major: k = 4q .. 4q + 3
          wr[g][u][q] = make_float4(w[0], w[H3], w[2 * H3], w[3 * H3]);
        }
    }
  }
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
  float* phis = area + L.phi;
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
      __syncwarp();  // this chunk's x and dts have arrived; row_h holds h
      // the chunk's h-independent terms: x.Wx + b, and the flow gate's phi * alpha
      const float* xc = area + (slot ? L.xbuf[1] : L.xbuf[0]);
      const float* dc = area + (slot ? L.dbuf[1] : L.dbuf[0]);
      wc::gru_terms_ahead<U>(un, xc, wxs, D, H, bias, gxs, [&](int c, int u) {
        if (FLOW) phis[(c * nu + u) * 32 + lane] = tanhf(sp[u] * dc[c]) * kInvLipschitzAlpha;
      });
      // the next chunk's x (or the next window's first) while this one runs
      if (t0 + kC < T) stage_chunk(slot ^ 1, window, t0 + kC);
      else if (w + n_warps < bb) {
        stage_chunk(slot ^ 1, window + n_warps, 0);
        wc::load_h0(un, h_next, h0 + (size_t)(window + n_warps) * H);
      }
      cp_async_commit();
      slot ^= 1;

      auto pa = [&](int c, int u) { return phis[(c * nu + u) * 32 + lane]; };
      wc::gru_steps<N, FLOW, U>(un, h, H, nc, w_rz, w_c, gxs, pa, row_h, row_r);
    }
    wc::warp_head<N, U>(un, h, H, Dh, K, smem + L.head.w1, smem + L.head.b1, smem + L.head.w2,
                        smem + L.head.b2, row_h, row_r, out + (size_t)window * K, act_int,
                        act_frac);
  }
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N, bool FLOW>
static cudaError_t launch_mr_step(const float* xs, const float* h0, const float* wx,
                                  const float* wh, const float* b, const float* time_scale,
                                  const float* dts, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out, int B, int T,
                                  int D, int H, int Dh, int K, int bb, int act_int, int act_frac,
                                  cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = wc::GruLayout(D, H, Dh, K, bb).total * sizeof(float);
  auto kernel = &mr_step_kernel<N, FLOW>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<B / bb, 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, T, D, H, Dh, K, bb, act_int,
      act_frac);
  return cudaGetLastError();
}

template <bool FLOW>
static cudaError_t launch_mr_step_width(const float* xs, const float* h0, const float* wx,
                                        const float* wh, const float* b,
                                        const float* time_scale, const float* dts,
                                        const float* w1, const float* b1, const float* w2,
                                        const float* b2, float* out, int B, int T, int D, int H,
                                        int Dh, int K, int bb, int act_int, int act_frac,
                                        cudaStream_t stream) {
#define REPRO_MR_STEP(N)                                                                       \
  launch_mr_step<N, FLOW>(xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, B, T, D, H, \
                          Dh, K, bb, act_int, act_frac, stream)
  switch (H) {
    case 8: return REPRO_MR_STEP(8);
    case 32: return REPRO_MR_STEP(32);
    case 64: return REPRO_MR_STEP(64);
    default: return REPRO_MR_STEP(0);
  }
#undef REPRO_MR_STEP
}

}  // namespace repro

extern "C" int mr_step_launch(const float* xs, const float* h0, const float* wx, const float* wh,
                              const float* b, const float* time_scale, const float* dts,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              float* out, int B, int T, int D, int H, int Dh, int K, int bb,
                              int flow, int act_int, int act_frac, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || H < 1 || H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
  auto launch = flow ? &repro::launch_mr_step_width<true> : &repro::launch_mr_step_width<false>;
  return (int)launch(xs, h0, wx, wh, b, time_scale, dts, w1, b1, w2, b2, out, B, T, D, H, Dh, K,
                     bb, act_int, act_frac, (cudaStream_t)stream);
}
