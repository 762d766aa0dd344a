// Warp-level tensor-core and async-copy building blocks of the serving
// kernels (serve_attention.cu; invariant_dense.cu takes its copies) and of
// the mamba2 chunk kernels (mamba2_scan.cu): cp.async 16-byte copies into
// shared memory (zero-filled when the source is out of range), the bf16
// mma.sync m16n8k16 product with f32 accumulators, and the tf32
// m16n8k8 product with the 3xTF32 split for f32 accuracy.
//
// Fragments of mma.sync.m16n8k16.row.col (PTX ISA), lane l, g = l / 4,
// t = l % 4:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C, D (16 x 8):          c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..]
// Every element of D is its own dot product: its bits depend on its row
// of A, its column of B and its C alone, never on where the row or the
// column sits in the tile. The serving kernels' row invariance rests on
// that.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; zeros when !valid (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b over one k16 step (bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of mma.sync.m16n8k8.row.col with tf32 operands (PTX ISA), lane
// l, g = l / 4, t = l % 4:
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4]
//   B (8 x 8, k x n):      b0 = B[t][g], b1 = B[t+4][g]
//   C, D (16 x 8):         as for m16n8k16 above.
// 3xTF32: v = hi + lo with hi = tf32(v), lo = tf32(v - hi) (about 21 of
// f32's 24 bits), and a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi, the small
// terms summed apart; the a_lo b_lo term is dropped (below f32's
// rounding).

// hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// d += a b over one k8 step (tf32 operands, f32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 from the split operands: small += a_hi b_lo + a_lo b_hi, d +=
// a_hi b_hi (the caller adds small into d once its sum is complete)
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], float (&small)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace mma
}  // namespace repro_torch
