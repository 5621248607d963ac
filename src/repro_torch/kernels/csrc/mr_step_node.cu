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
//   then     h = h + x_t . W_in + b_in
//
// with sub_dt the float32 Euler substep handed in by the wrapper and K a
// runtime int. Then the head (head.cuh) on h_T.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each two H x H matvecs per window: ~53 MFLOP at B=64,
// T=32, H=32, K=6, under a microsecond of the card's float32 rate. The time
// is the latency of that chain. One block per tile of `bb` windows keeps
// w_f1, w_f2, w_in (about 36 KB at H=64), the biases and the head weights in
// dynamic shared memory, with h and z [bb, H] beside them; each (window,
// hidden unit) pair has its own thread, and a substep is two barriers (z,
// then h). The injection is folded into the last substep's h update, so it
// costs no barrier of its own. The only device-memory traffic is x in and
// the head output out.
#include "common.cuh"
#include "head.cuh"

namespace repro {

inline size_t node_shared_floats(int D, int H, int Dh, int K, int bb) {
  return 2 * (size_t)H * H + (size_t)D * H + 3 * (size_t)H + 2 * (size_t)bb * H +
         head_shared_floats(H, Dh, K, bb);
}

__global__ void mr_step_node_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                                    const float* __restrict__ w_f1,
                                    const float* __restrict__ b_f1,
                                    const float* __restrict__ w_f2,
                                    const float* __restrict__ b_f2,
                                    const float* __restrict__ w_in,
                                    const float* __restrict__ b_in,
                                    const float* __restrict__ w1, const float* __restrict__ b1,
                                    const float* __restrict__ w2, const float* __restrict__ b2,
                                    float* __restrict__ out, int T, int D, int H, int Dh, int K,
                                    int bb, int n_substeps, float sub_dt, int act_int,
                                    int act_frac) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  float* p = smem;
  float* wf1_s = p;  p += H * H;
  float* wf2_s = p;  p += H * H;
  float* win_s = p;  p += D * H;
  float* bf1_s = p;  p += H;
  float* bf2_s = p;  p += H;
  float* bin_s = p;  p += H;
  float* h_s = p;    p += bb * H;  // hidden state of the tile
  float* z_s = p;    p += bb * H;  // the field's hidden layer
  HeadShared hd;
  head_setup(hd, p, w1, b1, w2, b2, H, Dh, K, bb);
  stage(wf1_s, w_f1, H * H);
  stage(wf2_s, w_f2, H * H);
  stage(win_s, w_in, D * H);
  stage(bf1_s, b_f1, H);
  stage(bf2_s, b_f2, H);
  stage(bin_s, b_in, H);
  stage(h_s, h0 + (size_t)b0 * H, bb * H);
  __syncthreads();

  const int n = bb * H;
  for (int t = 0; t < T; ++t) {
    for (int s = 0; s < n_substeps; ++s) {
      // z = tanh(h . w_f1 + b_f1)
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        const int w = q / H, j = q - w * H;
        const float* h = h_s + w * H;
        float acc = 0.0f;
        for (int k = 0; k < H; ++k) acc = fmaf(h[k], wf1_s[k * H + j], acc);
        z_s[q] = tanhf(acc + bf1_s[j]);
      }
      __syncthreads();
      // h += sub_dt * (z . w_f2 + b_f2); after the last substep, + x . w_in + b_in.
      // Each thread rewrites only its own h[q], which no other thread reads here.
      const bool inject = s == n_substeps - 1;
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        const int w = q / H, j = q - w * H;
        const float* z = z_s + w * H;
        float acc = 0.0f;
        for (int k = 0; k < H; ++k) acc = fmaf(z[k], wf2_s[k * H + j], acc);
        float h = h_s[q] + sub_dt * (acc + bf2_s[j]);
        if (inject) {
          const float* x = xs + ((size_t)(b0 + w) * T + t) * D;
          float xin = 0.0f;
          for (int d = 0; d < D; ++d) xin = fmaf(x[d], win_s[d * H + j], xin);
          h = h + xin + bin_s[j];
        }
        h_s[q] = h;
      }
      __syncthreads();
    }
  }
  head_tile(hd, h_s, z_s, out + (size_t)b0 * K, H, Dh, K, bb, act_int, act_frac);
}

}  // namespace repro

extern "C" int mr_step_node_launch(const float* xs, const float* h0, const float* w_f1,
                                   const float* b_f1, const float* w_f2, const float* b_f2,
                                   const float* w_in, const float* b_in, const float* w1,
                                   const float* b1, const float* w2, const float* b2, float* out,
                                   int B, int T, int D, int H, int Dh, int K, int bb,
                                   int n_substeps, int act_int, int act_frac, float sub_dt,
                                   void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = repro::node_shared_floats(D, H, Dh, K, bb) * sizeof(float);
  cudaError_t err = repro::allow_shared(repro::mr_step_node_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  repro::mr_step_node_kernel<<<B / bb, repro::tile_threads(bb, H), smem,
                               (cudaStream_t)stream>>>(xs, h0, w_f1, b_f1, w_f2, b_f2, w_in,
                                                       b_in, w1, b1, w2, b2, out, T, D, H, Dh, K,
                                                       bb, n_substeps, sub_dt, act_int,
                                                       act_frac);
  return (int)cudaGetLastError();
}
