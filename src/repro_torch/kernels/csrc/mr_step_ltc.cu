// Stage-fused LTC recovery step: K semi-implicit solver substeps per input
// step -> RMS-norm -> optional Qm.n activation step -> ReLU MLP head.
//
// Replaces repro/kernels/mr_step/kernel.py:404 mr_step_ltc_pallas (body
// _mr_step_ltc_kernel, :354-398; step _ltc_step_math, :330-351). Per input
// step t and window:
//
//   drive = x_t . W_in + bias                      (once per input step)
//   K times: f = sigmoid(drive + h . W_rec)
//            h = (h + sub_dt * f * a) / (1 + sub_dt * (inv_tau + f))
//
// with sub_dt = dt / K in float32, handed in by the wrapper, and K a runtime
// int. Then the head on h_T.
//
// A warp-per-window recurrence (warp_cell.cuh): a block of `bb` windows
// stages w_rec, w_in, bias, a, inv_tau and the head weights once; each warp
// runs its window's T * K substeps and the head with no block barrier. A
// substep's chain is h.W_rec (four partial sums an output, from registers at
// H <= 32), the add of the drive, the sigmoid, the numerator and denominator
// and their IEEE division; the drive x_t.W_in + bias was computed before the
// chunk of steps. The update forms (sub_dt * f) * a and sub_dt * (inv_tau + f)
// as the plain version does, each with its add fused into one FMA (what nvcc
// makes of a * b + c by default), and divides num / den exactly.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each an H x H matvec a window: ~31 MFLOP at B=64, T=32,
// H=32, K=6, about half a microsecond of the card's float32 rate. The only
// device-memory traffic is x in and the head output out.
#include "warp_cell.cuh"

namespace repro {

template <int N>
// minBlocksPerSM = 1: without it ptxas holds the H=64 instantiations to
// 64-128 registers and issues each shared load just ahead of its FMAs
__global__ void __launch_bounds__(wc::kWarps * 32, 1)
    mr_step_ltc_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                       const float* __restrict__ w_in, const float* __restrict__ w_rec,
                       const float* __restrict__ bias, const float* __restrict__ a,
                       const float* __restrict__ inv_tau, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ out, int T, int D,
                       int H_rt, int Dh, int K, int bb, int n_substeps, float sub_dt,
                       int act_int, int act_frac) {
  constexpr int U = N > 0 ? (N + 31) / 32 : wc::kMaxUnits;
  constexpr bool REG = N > 0 && N <= 32;  // w_rec's columns fit in registers
  constexpr int kC = wc::kChunk;
  const int H = wc::width<N>(H_rt), S = wc::col_stride(H);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wc::LtcLayout L(D, H, Dh, K, bb);
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
  if constexpr (REG)  // read once into registers: row-major, 16-byte copies
    wc::copy_async(smem + L.wrec, w_rec, H * H, threadIdx.x, blockDim.x);
  else  // read every substep: column-major, a float4 of a column per load
    wc::copy_columns_async(smem + L.wrec, w_rec, H, H, S, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.win, w_in, D * H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.bias, bias, H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.a, a, H, threadIdx.x, blockDim.x);
  wc::copy_async(smem + L.itau, inv_tau, H, threadIdx.x, blockDim.x);
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

  // column j of w_rec, k = 4q .. 4q + 3, from the column-major copy
  const float4* wrec4 = reinterpret_cast<const float4*>(smem + L.wrec);
  const float* wins = smem + L.win;
  float bs[U], as[U], itau[U];
  float4 wr[U][REG ? N / 4 : 1];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bs[u] = smem[L.bias + un.col[u]];
    as[u] = smem[L.a + un.col[u]];
    itau[u] = smem[L.itau + un.col[u]];
    if constexpr (REG) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float* w = smem + L.wrec + 4 * q * H + un.col[u];  // row-major
        wr[u][q] = make_float4(w[0], w[H], w[2 * H], w[3 * H]);
      }
    }
  }
  auto w_recc = [&](int q, int, int u) {
    if constexpr (REG) return wr[u][q];
    else return wrec4[un.col[u] * (S / 4) + q];
  };

  float* row_h = area + L.row_h;
  float* row_r = area + L.row_r;
  float* drvs = area + L.drv;
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
      // the chunk's drives x_t . W_in + bias, each lane for its own units:
      // over d for all kC steps at once (kC independent sums), then bias
      const float* xc = area + (slot ? L.xbuf[1] : L.xbuf[0]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nu) continue;
        float acc[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float wd = wins[d * H + un.col[u]];
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[c] = fmaf(xc[c * D + d], wd, acc[c]);  // past nc: unread
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) drvs[(c * nu + u) * 32 + lane] = acc[c] + bs[u];
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
        float drive[U];
#pragma unroll
        for (int u = 0; u < U; ++u) drive[u] = u < nu ? drvs[(c * nu + u) * 32 + lane] : 0.0f;
        for (int s = 0; s < n_substeps; ++s) {
          float rec[1][U];
          wc::matvec<N, 1, U>(row_h, H, nu, w_recc, rec);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (u >= nu) continue;
            const float f = sigmoid(drive[u] + rec[0][u]);
            const float num = fmaf(sub_dt * f, as[u], h[u]);  // h + (sub_dt * f) * a
            const float den = fmaf(sub_dt, itau[u] + f, 1.0f);  // 1 + sub_dt * (inv_tau + f)
            h[u] = num / den;
            if (un.own[u]) row_h[un.col[u]] = h[u];
          }
          __syncwarp();
        }
      }
    }
    const wc::F32Head hd{smem + L.head.w1, smem + L.head.b1, smem + L.head.w2, smem + L.head.b2,
                         Dh, K};
    wc::warp_head<N, U>(un, h, H, hd, row_h, row_r, out + (size_t)window * K, act_int, act_frac);
  }
}

// static: internal linkage, so each library keeps its own `allowed` record
template <int N>
static cudaError_t launch_ltc(const float* xs, const float* h0, const float* w_in,
                              const float* w_rec, const float* bias, const float* a,
                              const float* inv_tau, const float* w1, const float* b1,
                              const float* w2, const float* b2, float* out, int B, int T, int D,
                              int H, int Dh, int K, int bb, int n_substeps, float sub_dt,
                              int act_int, int act_frac, cudaStream_t stream) {
  static size_t allowed[wc::kMaxDevices] = {};
  const size_t smem = wc::LtcLayout(D, H, Dh, K, bb).total * sizeof(float);
  auto kernel = &mr_step_ltc_kernel<N>;
  cudaError_t err = wc::allow_shared_once(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<B / bb, 32 * wc::warps_for(bb), smem, stream>>>(
      xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out, T, D, H, Dh, K, bb,
      n_substeps, sub_dt, act_int, act_frac);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int mr_step_ltc_launch(const float* xs, const float* h0, const float* w_in,
                                  const float* w_rec, const float* bias, const float* a,
                                  const float* inv_tau, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out, int B, int T,
                                  int D, int H, int Dh, int K, int bb, int n_substeps,
                                  int act_int, int act_frac, float sub_dt, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1 || H < 1 ||
      H > 32 * repro::wc::kMaxUnits)
    return (int)cudaErrorInvalidValue;
#define REPRO_LTC(N)                                                                           \
  repro::launch_ltc<N>(xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out, B, T, D, H, \
                       Dh, K, bb, n_substeps, sub_dt, act_int, act_frac, (cudaStream_t)stream)
  switch (H) {
    case 8: return (int)REPRO_LTC(8);
    case 32: return (int)REPRO_LTC(32);
    case 64: return (int)REPRO_LTC(64);
    default: return (int)REPRO_LTC(0);
  }
#undef REPRO_LTC
}
