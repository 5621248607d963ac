// Int8/PWL banked service tick: the serving segment of one pure-serve
// (monitor) tick of precision="int8_pwl", for every slot, in one launch.
//
// Replaces repro/kernels/mr_step/tick.py:313 mr_tick_pallas_int8 (body
// _mr_tick_q_kernel, :251-310). It is mr_tick.cu with the standard GRU cell
// quantized: per slot it rolls the ring buffers and writes them out,
// normalizes y with the frozen mean and scale and cuts the N windows
// (tick.cuh), runs the int8/PWL GRU scan over them (gru_q_step.cuh, the N
// windows as the tile) and the int8 head (head_q.cuh) into a shared [N, Ko]
// tile, and warp 0 takes the mean over windows of the first Kc outputs, the
// EMA (or the first tick's seed) and delta = max|theta - theta0| /
// (max|theta| + 1e-3), inf for an inactive slot (tick.cuh).
//
// The weights are int8 per slot, with scales per slot and per output
// channel ([S, 3H], [S, Dh], [S, Ko]); the two PWL tables are shared by all
// slots. One block per bank of `bank` slots takes its slots in turn, so one
// slot's carve is the whole shared-memory cost (tiling.py tick_smem_bytes
// with int8=True). The rolled buffers are copies, so they match the plain
// version bit for bit; results do not depend on the bank size.
//
// What bounds it on an H100: as mr_tick, the chain of T dependent GRU steps
// on one SM per slot. At the serve shape (S=4, N=17, T=32, D=4, H=32,
// Dh=64, Ko=45) ~17 MFLOP and ~0.1 MB, a fraction of a microsecond of the
// card's float32 rate and its memory rate alike.
#include "gru_q_step.cuh"
#include "head_q.cuh"
#include "tick.cuh"

namespace repro {

inline size_t mr_tick_q_shared_floats(int N, int T, int D, int H, int Dh, int Ko, int n_seg) {
  return gru_q_shared_floats(D, H, N, n_seg) + head_q_shared_floats(H, Dh, Ko, N) +
         (size_t)N * T * D + (size_t)N * Ko;
}

__global__ void mr_tick_int8_kernel(
    const float* __restrict__ buf_y, const float* __restrict__ new_y,
    const float* __restrict__ mean, const float* __restrict__ scale,
    const float* __restrict__ theta0, const float* __restrict__ seed,
    const float* __restrict__ active, const int8_t* __restrict__ wxq,
    const int8_t* __restrict__ whq, const float* __restrict__ sx, const float* __restrict__ sh,
    const float* __restrict__ b, const float* __restrict__ sig, const float* __restrict__ tnh,
    const int8_t* __restrict__ w1q, const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2q, const float* __restrict__ s2, const float* __restrict__ b2,
    const float* __restrict__ h0, const float* __restrict__ buf_u,
    const float* __restrict__ new_u, float* __restrict__ buf_y_out,
    float* __restrict__ theta_out, float* __restrict__ delta_out, float* __restrict__ buf_u_out,
    int L, int n, int m, int C, int T, int stride, int N, int H, int Dh, int Ko, int Kc, int bank,
    int n_seg, float ema, float one_minus_ema) {
  extern __shared__ float smem[];
  const int D = n + m, H3 = 3 * H;
  float* xs = smem + gru_q_shared_floats(D, H, N, n_seg) + head_q_shared_floats(H, Dh, Ko, N);
  float* out = xs + N * T * D;  // [N, Ko]

  for (int k = 0; k < bank; ++k) {
    const int s = blockIdx.x * bank + k;
    __syncthreads();  // the previous slot is done with shared memory

    // 1-3. the rolled buffers, written out, and the normalized window set
    tick_ingest(buf_y, new_y, buf_u, new_u, mean, scale, buf_y_out, buf_u_out, xs, s, L, n, m, C,
                T, stride, N);

    // 4-5. the scan over the N windows, then the head (gru_q_setup's barrier
    // publishes xs; the scan's barriers publish the head weights)
    GruQShared g;
    float* p = gru_q_setup(g, smem, wxq + (size_t)s * D * H3, whq + (size_t)s * H * H3,
                           sx + (size_t)s * H3, sh + (size_t)s * H3, b + (size_t)s * H3, sig, tnh,
                           h0, D, H, N, n_seg);
    HeadQShared hd;
    head_q_setup(hd, p, w1q + (size_t)s * H * Dh, s1 + (size_t)s * Dh, b1 + (size_t)s * Dh,
                 w2q + (size_t)s * Dh * Ko, s2 + (size_t)s * Ko, b2 + (size_t)s * Ko, H, Dh, Ko,
                 N);
    gru_q_scan_tile<false>(g, xs, nullptr, T, D, H, N, n_seg);
    head_q_tile(hd, g.h, g.rh, out, H, Dh, Ko, N);
    __syncthreads();

    // 6-8. mean over windows, EMA, delta: warp 0
    if (threadIdx.x < 32)
      tick_readout(out, theta0, seed, active, theta_out, delta_out, s, N, Ko, Kc, ema,
                   one_minus_ema);
  }
}

}  // namespace repro

extern "C" int mr_tick_int8_launch(
    const float* buf_y, const float* new_y, const float* mean, const float* scale,
    const float* theta0, const float* seed, const float* active, const int8_t* wxq,
    const int8_t* whq, const float* sx, const float* sh, const float* b, const float* sig,
    const float* tnh, const int8_t* w1q, const float* s1, const float* b1, const int8_t* w2q,
    const float* s2, const float* b2, const float* h0, const float* buf_u, const float* new_u,
    float* buf_y_out, float* theta_out, float* delta_out, float* buf_u_out, int S, int L, int n,
    int m, int C, int T, int stride, int H, int Dh, int Ko, int Kc, int bank, int n_seg,
    float ema, float one_minus_ema, void* stream) {
  if (n_seg < 1 ||
      repro::tick_geometry_bad(S, L, n, m, C, T, stride, Ko, Kc, bank, buf_u, new_u, buf_u_out))
    return (int)cudaErrorInvalidValue;
  const int N = (L - T) / stride + 1;
  const size_t smem = repro::mr_tick_q_shared_floats(N, T, n + m, H, Dh, Ko, n_seg) * sizeof(float);
  cudaError_t err = repro::allow_shared(repro::mr_tick_int8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  repro::mr_tick_int8_kernel<<<S / bank, repro::tile_threads(N, H), smem, (cudaStream_t)stream>>>(
      buf_y, new_y, mean, scale, theta0, seed, active, wxq, whq, sx, sh, b, sig, tnh, w1q, s1, b1,
      w2q, s2, b2, h0, buf_u, new_u, buf_y_out, theta_out, delta_out, buf_u_out, L, n, m, C, T,
      stride, N, H, Dh, Ko, Kc, bank, n_seg, ema, one_minus_ema);
  return (int)cudaGetLastError();
}
