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
// int. Then the head (head.cuh) on h_T.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each an H x H matvec per window: ~29 MFLOP at B=64, T=32,
// H=32, K=6, about half a microsecond of the card's float32 rate. The time is
// the latency of that chain. The design keeps every operand of a substep on
// the SM and makes a substep as short as it can be: one block per tile of
// `bb` windows stages w_in, w_rec, bias, a, inv_tau and the head weights once
// in dynamic shared memory; each (window, hidden unit) pair has its own thread,
// which keeps its drive in a register for the input step; h ping-pongs between
// two [bb, H] shared buffers, so a substep reads one and writes the other and
// one barrier per substep suffices. The only device-memory traffic is x in
// and the head output out.
#include "common.cuh"
#include "head.cuh"

namespace repro {

inline size_t ltc_shared_floats(int D, int H, int Dh, int K, int bb) {
  return (size_t)D * H + (size_t)H * H + 3 * (size_t)H + 2 * (size_t)bb * H +
         head_shared_floats(H, Dh, K, bb);
}

__global__ void mr_step_ltc_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                                   const float* __restrict__ w_in,
                                   const float* __restrict__ w_rec,
                                   const float* __restrict__ bias, const float* __restrict__ a,
                                   const float* __restrict__ inv_tau,
                                   const float* __restrict__ w1, const float* __restrict__ b1,
                                   const float* __restrict__ w2, const float* __restrict__ b2,
                                   float* __restrict__ out, int T, int D, int H, int Dh, int K,
                                   int bb, int n_substeps, float sub_dt, int act_int,
                                   int act_frac) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb;
  float* p = smem;
  float* w_in_s = p;   p += D * H;
  float* w_rec_s = p;  p += H * H;
  float* bias_s = p;   p += H;
  float* a_s = p;      p += H;
  float* itau_s = p;   p += H;
  float* h_cur = p;    p += bb * H;  // h of the current substep
  float* h_next = p;   p += bb * H;  // h the substep writes
  HeadShared hd;
  head_setup(hd, p, w1, b1, w2, b2, H, Dh, K, bb);
  stage(w_in_s, w_in, D * H);
  stage(w_rec_s, w_rec, H * H);
  stage(bias_s, bias, H);
  stage(a_s, a, H);
  stage(itau_s, inv_tau, H);
  stage(h_cur, h0 + (size_t)b0 * H, bb * H);
  __syncthreads();

  // this thread's (window, unit) pair; the launcher guarantees bb * H <= blockDim.x
  const int q = threadIdx.x;
  const bool active = q < bb * H;
  const int w = active ? q / H : 0, j = active ? q - w * H : 0;
  const float* x_w = xs + (size_t)(b0 + w) * T * D;
  for (int t = 0; t < T; ++t) {
    float drive = 0.0f;
    if (active) {
      const float* x = x_w + (size_t)t * D;
      for (int d = 0; d < D; ++d) drive = fmaf(x[d], w_in_s[d * H + j], drive);
      drive += bias_s[j];
    }
    for (int s = 0; s < n_substeps; ++s) {
      if (active) {
        const float* h = h_cur + w * H;
        float rec = 0.0f;
        for (int k = 0; k < H; ++k) rec = fmaf(h[k], w_rec_s[k * H + j], rec);
        const float f = sigmoid(drive + rec);
        const float num = h[j] + sub_dt * f * a_s[j];
        const float den = 1.0f + sub_dt * (itau_s[j] + f);
        h_next[q] = num / den;
      }
      // h_cur was fully read before anyone passes this barrier, so the next
      // substep may overwrite it
      __syncthreads();
      float* tmp = h_cur;
      h_cur = h_next;
      h_next = tmp;
    }
  }
  head_tile(hd, h_cur, h_next, out + (size_t)b0 * K, H, Dh, K, bb, act_int, act_frac);
}

}  // namespace repro

extern "C" int mr_step_ltc_launch(const float* xs, const float* h0, const float* w_in,
                                  const float* w_rec, const float* bias, const float* a,
                                  const float* inv_tau, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out, int B, int T,
                                  int D, int H, int Dh, int K, int bb, int n_substeps,
                                  int act_int, int act_frac, float sub_dt, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1 || bb * H > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = repro::ltc_shared_floats(D, H, Dh, K, bb) * sizeof(float);
  cudaError_t err = repro::allow_shared(repro::mr_step_ltc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  repro::mr_step_ltc_kernel<<<B / bb, repro::tile_threads(bb, H), smem, (cudaStream_t)stream>>>(
      xs, h0, w_in, w_rec, bias, a, inv_tau, w1, b1, w2, b2, out, T, D, H, Dh, K, bb,
      n_substeps, sub_dt, act_int, act_frac);
  return (int)cudaGetLastError();
}
