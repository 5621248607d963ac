// Tensor-core building blocks shared by the bf16 kernels (flash_attention.cu,
// ssd_scan.cu): mma.sync.m16n8k16 with bf16 operands and a float32
// accumulator, ldmatrix from shared memory, the split of a float32 factor
// into two bf16 halves, and cp.async staging of bf16 rows.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..), each a bf16 pair with the lower column in the low half;
//   B (16 x 8): b0 (k 2t..2t+1, column g), b1 (k 2t+8..2t+9, column g);
//   C (16 x 8, float32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// A C fragment of two neighbouring 8-column blocks is therefore the A fragment
// of a 16-deep product (FlashAttention-2's reuse of the scores as operand).
//
// Precision: a bf16 x bf16 product is exact in float32, so a product of two
// bf16 inputs only changes the order of the float32 sum. A float32 factor is
// split as hi = bf16(f), lo = bf16(f - hi) and multiplied as two products into
// one accumulator: hi + lo carries f to ~2^-17 of its value, where one bf16
// rounding (2^-9) would break the float32 result's bounds.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives its elements (row g, columns 2t, 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, transposed: register i receives matrix i's (rows 2t, 2t+1; column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores. Not volatile: it reads only its operands, so
// the compiler may interleave independent products (a hi and a lo product into
// one accumulator are dependent; the callers put other products between them).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed as bf16 pairs.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragments (hi and lo) of a 16 x 16 float32 tile held as the C
// fragments of its two 8-column halves.
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// 16 bytes global -> shared without registers; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows [0, nrows) of a bf16 matrix (row r at src + r * stride, columns
// [0, cols)) into shared memory dst (row stride ld), block-strided; rows at or
// past valid_rows and columns [cols, cpad) become zeros. vec (cols and stride
// multiples of 8, src 16-byte aligned): 16-byte cp.async, which the caller
// commits and waits for; otherwise element by element.
__device__ __forceinline__ void stage_rows_bf16(bf16* dst, int ld, const bf16* src, size_t stride,
                                                int nrows, int valid_rows, int cols, int cpad,
                                                bool vec) {
  if (vec) {
    const int per_row = cpad / 8;
    for (int e = threadIdx.x; e < nrows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * 8;
      const bool ok = r < valid_rows && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * cpad; e += blockDim.x) {
      const int r = e / cpad, c = e - r * cpad;
      dst[r * ld + c] = (r < valid_rows && c < cols) ? src[r * stride + c] : __float2bfloat16(0.0f);
    }
  }
}

}  // namespace repro
