// Warp-level tensor-core and async-copy building blocks of the serving
// kernels (serve_attention.cu; invariant_dense.cu takes its copies): cp.async
// 16-byte copies into shared memory (zero-filled when the source is
// out of range), the bf16 mma.sync m16n8k16 product with f32
// accumulators.
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

}  // namespace mma
}  // namespace repro_torch
