// Helpers shared by the server-plane kernels (csrc/*.cu).
//
// Conventions of every kernel here: a block prologue computes the
// round's scalars from the device arrays into shared memory; one thread
// owns each output element in a grid-stride loop; no atomics; every
// multiply, add, divide and square root is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, no contraction into
// FMA) in the op order of the plain PyTorch versions in kernels/ref.py,
// so a kernel equals its plain version bit for bit on the card.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace repro_torch {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // grid-stride beyond 16 per SM
constexpr int kMaxK = 256;                  // server_plane.py: MAX_K

__device__ __forceinline__ float ld(const float* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const int8_t* p, size_t i) {
  return static_cast<float>(__ldg(p + i));  // exact: |q| <= 127
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// w_k = sizes_k * keep_k / max(sum_j sizes_j * keep_j, 1e-9), the sum
// taken from k = 0 upward (ref.py: _norm_weights); keep_k is 1 - keep[k]
// when keep_is_delayed. Writes w into w_out and returns tot.
__device__ inline float norm_weights(const float* sizes, const float* keep,
                                     bool keep_is_delayed, int K,
                                     float* w_out) {
  float tot = 0.f;
  for (int k = 0; k < K; ++k) {
    const float kk = keep_is_delayed ? __fsub_rn(1.f, keep[k]) : keep[k];
    const float wk = __fmul_rn(sizes[k], kk);
    tot = k == 0 ? wk : __fadd_rn(tot, wk);
    w_out[k] = wk;
  }
  const float denom = fmaxf(tot, 1e-9f);
  for (int k = 0; k < K; ++k) w_out[k] = __fdiv_rn(w_out[k], denom);
  return tot;
}

// alpha_t = min(alpha0 + eta * t, cap) from coefs = [alpha0, eta, cap, t]
__device__ __forceinline__ float alpha_schedule(const float* coefs) {
  return fminf(__fadd_rn(coefs[0], __fmul_rn(coefs[1], coefs[3])), coefs[2]);
}

inline int grid_for(long long N) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace repro_torch
