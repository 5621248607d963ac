// Stage-fused fixed-point LTC step: K semi-implicit substeps per input step
// with int8 w_in and w_rec and the PWL sigmoid -> RMS-norm -> int8 ReLU MLP
// head. The serving readout of precision="int8_pwl" on the ltc row.
//
// Replaces repro/kernels/mr_step/kernel.py:695 mr_step_ltc_pallas_int8 (body
// _mr_step_ltc_q_kernel, :635-680; step _ltc_q_step_math, :614-632). Per
// input step t and window:
//
//   drive = x_t . W_in + bias                      (once per input step)
//   K times: f = pwl_sigmoid(drive + h . W_rec)
//            h = (h + sub_dt * f * a) / (1 + sub_dt * (inv_tau + f))
//
// with W = float(q) * scale[column], sub_dt = dt / K in float32 (the
// wrapper hands in core/ltc.py ltc_sub_dt), then the int8 head on h_T.
//
// Design, as mr_step_ltc.cu: one block per tile of `bb` windows stages the
// int8 w_in and w_rec, their scales, bias, a, inv_tau, the PWL table and the
// int8 head in dynamic shared memory; each (window, hidden unit) pair has
// its own thread, which keeps its drive and its two column scales in
// registers; h ping-pongs between two [bb, H] shared buffers, one barrier a
// substep. The substep's elementwise arithmetic is rounded op by op
// (__fmul_rn, __fadd_rn, __fdiv_rn) in the plain version's order.
//
// What bounds it on an H100: the chain of T * K dependent substeps (192 at
// the quickstart), each an H x H matvec per window; at the quickstart
// readout ~75 MFLOP, about a microsecond of the card's float32 rate. The
// time is the latency of that chain.
#include "head_q.cuh"
#include "pwl.cuh"

namespace repro {

inline size_t ltc_q_shared_floats(int D, int H, int Dh, int K, int bb, int n_seg) {
  return 5 * (size_t)H + pwl_floats(n_seg) + 2 * (size_t)bb * H + q_floats((size_t)D * H) +
         q_floats((size_t)H * H) + head_q_shared_floats(H, Dh, K, bb);
}

__global__ void mr_step_ltc_int8_kernel(
    const float* __restrict__ xs, const float* __restrict__ h0, const int8_t* __restrict__ w_inq,
    const float* __restrict__ s_in, const int8_t* __restrict__ w_recq,
    const float* __restrict__ s_rec, const float* __restrict__ bias, const float* __restrict__ a,
    const float* __restrict__ inv_tau, const float* __restrict__ sig,
    const int8_t* __restrict__ w1q, const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2q, const float* __restrict__ s2, const float* __restrict__ b2,
    float* __restrict__ out, int T, int D, int H, int Dh, int K, int bb, int n_substeps,
    int n_seg, float sub_dt) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * bb, nt = pwl_floats(n_seg);
  float* p = smem;
  float* s_in_s = p;   p += H;
  float* s_rec_s = p;  p += H;
  float* bias_s = p;   p += H;
  float* a_s = p;      p += H;
  float* itau_s = p;   p += H;
  float* sig_s = p;    p += nt;
  float* h_cur = p;    p += bb * H;  // h of the current substep
  float* h_next = p;   p += bb * H;  // h the substep writes
  int8_t* w_in_s = carve_q(p, (size_t)D * H);
  int8_t* w_rec_s = carve_q(p, (size_t)H * H);
  HeadQShared hd;
  head_q_setup(hd, p, w1q, s1, b1, w2q, s2, b2, H, Dh, K, bb);
  stage(s_in_s, s_in, H);
  stage(s_rec_s, s_rec, H);
  stage(bias_s, bias, H);
  stage(a_s, a, H);
  stage(itau_s, inv_tau, H);
  stage(sig_s, sig, nt);
  stage(h_cur, h0 + (size_t)b0 * H, bb * H);
  stage_q(w_in_s, w_inq, D * H);
  stage_q(w_rec_s, w_recq, H * H);
  __syncthreads();

  // this thread's (window, unit) pair; the launcher guarantees bb * H <= blockDim.x
  const int q = threadIdx.x;
  const bool active = q < bb * H;
  const int w = active ? q / H : 0, j = active ? q - w * H : 0;
  const float sin_j = s_in_s[j], srec_j = s_rec_s[j];
  const float* x_w = xs + (size_t)(b0 + w) * T * D;
  for (int t = 0; t < T; ++t) {
    float drive = 0.0f;
    if (active) {
      const float* x = x_w + (size_t)t * D;
      for (int d = 0; d < D; ++d)
        drive = fmaf(x[d], __fmul_rn((float)w_in_s[d * H + j], sin_j), drive);
      drive = __fadd_rn(drive, bias_s[j]);
    }
    for (int s = 0; s < n_substeps; ++s) {
      if (active) {
        const float* h = h_cur + w * H;
        float rec = 0.0f;
        for (int k = 0; k < H; ++k)
          rec = fmaf(h[k], __fmul_rn((float)w_rec_s[k * H + j], srec_j), rec);
        const float f = pwl_eval(sig_s, n_seg, __fadd_rn(drive, rec));
        const float num = __fadd_rn(h[j], __fmul_rn(__fmul_rn(sub_dt, f), a_s[j]));
        const float den = __fadd_rn(1.0f, __fmul_rn(sub_dt, __fadd_rn(itau_s[j], f)));
        h_next[q] = __fdiv_rn(num, den);
      }
      // h_cur was fully read before anyone passes this barrier, so the next
      // substep may overwrite it
      __syncthreads();
      float* tmp = h_cur;
      h_cur = h_next;
      h_next = tmp;
    }
  }
  head_q_tile(hd, h_cur, h_next, out + (size_t)b0 * K, H, Dh, K, bb);
}

}  // namespace repro

extern "C" int mr_step_ltc_int8_launch(
    const float* xs, const float* h0, const int8_t* w_inq, const float* s_in,
    const int8_t* w_recq, const float* s_rec, const float* bias, const float* a,
    const float* inv_tau, const float* sig, const int8_t* w1q, const float* s1, const float* b1,
    const int8_t* w2q, const float* s2, const float* b2, float* out, int B, int T, int D, int H,
    int Dh, int K, int bb, int n_substeps, int n_seg, float sub_dt, void* stream) {
  if (bb < 1 || B % bb != 0 || T < 1 || n_substeps < 1 || n_seg < 1 || bb * H > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = repro::ltc_q_shared_floats(D, H, Dh, K, bb, n_seg) * sizeof(float);
  cudaError_t err = repro::allow_shared(repro::mr_step_ltc_int8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  repro::mr_step_ltc_int8_kernel<<<B / bb, repro::tile_threads(bb, H), smem,
                                   (cudaStream_t)stream>>>(
      xs, h0, w_inq, s_in, w_recq, s_rec, bias, a, inv_tau, sig, w1q, s1, b1, w2q, s2, b2, out, T,
      D, H, Dh, K, bb, n_substeps, n_seg, sub_dt);
  return (int)cudaGetLastError();
}
