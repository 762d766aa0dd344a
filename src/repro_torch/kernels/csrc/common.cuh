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

inline int grid_for(long long N, int threads = kThreads) {
  const long long blocks = (N + threads - 1) / threads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

constexpr int kVecRows = 8;  // client rows a thread loads before combining
// a block of server_adam's and server_mix_delta's 16-byte kernels: one
// warp, so that a small N spreads over many SMs and the grid (at most
// kMaxBlocks) is resident in one wave at large N
constexpr int kVecThreads = 32;
constexpr int kUnroll = 4;  // elements a per-element thread loads at once

// 16 bytes of T as f32 elements, and back (bf16 widens exactly; the
// store rounds each element to nearest even, as __float2bfloat16_rn does)
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[2 * q] = __uint_as_float(w[q] << 16);
      f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned bits(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = bits(f[2 * q]) | (bits(f[2 * q + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// 16 int8 lanes as f32 (load only): each byte sign-extended, then
// converted, exactly (|q| <= 128), as ld() widens one
template <>
struct Vec16<int8_t> {
  static constexpr int E = 16;
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * q + b] =
            static_cast<float>(static_cast<int>(w[q] << (24 - 8 * b)) >> 24);
  }
};

// elements a 16-byte unit of two operands: 16 bytes of the narrower one
template <typename A, typename B>
__host__ __device__ constexpr int unit_elems() {
  return Vec16<A>::E > Vec16<B>::E ? Vec16<A>::E : Vec16<B>::E;
}

// E elements of T (E a multiple of Vec16<T>::E) as E / Vec16<T>::E
// 16-byte words: W<T, E> holds them, ld_words loads the words of vector
// index i (elements i E .. i E + E - 1, 16-byte aligned), unpack_words
// widens them to f32 and st_words stores f32 values rounded to T.
template <typename T, int E>
struct Words {
  static constexpr int n = E / Vec16<T>::E;
  uint4 w[n];
};
template <typename T, int E>
__device__ __forceinline__ Words<T, E> ld_words(const T* p, size_t i) {
  Words<T, E> r;
  const auto* q = reinterpret_cast<const uint4*>(p) + i * Words<T, E>::n;
#pragma unroll
  for (int j = 0; j < Words<T, E>::n; ++j) r.w[j] = __ldg(q + j);
  return r;
}
template <typename T, int E>
__device__ __forceinline__ void unpack_words(const Words<T, E>& r, float* f) {
#pragma unroll
  for (int j = 0; j < Words<T, E>::n; ++j)
    Vec16<T>::unpack(r.w[j], f + j * Vec16<T>::E);
}
template <typename T, int E>
__device__ __forceinline__ void st_words(T* p, size_t i, const float* f) {
  auto* q = reinterpret_cast<uint4*>(p) + i * Words<T, E>::n;
#pragma unroll
  for (int j = 0; j < Words<T, E>::n; ++j)
    q[j] = Vec16<T>::pack(f + j * Vec16<T>::E);
}

// the words of vector i of rows k0 .. k0 + kVecRows - 1 (those below K)
// of a (K, n) array: row k starts at element k n
template <typename R, int E>
__device__ __forceinline__ void ld_row_batch(const R* __restrict__ rows,
                                             size_t n, size_t i, int k0,
                                             int K,
                                             Words<R, E> (&x)[kVecRows]) {
#pragma unroll
  for (int q = 0; q < kVecRows; ++q)
    if (k0 + q < K) x[q] = ld_words<R, E>(rows + (k0 + q) * n, i);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace repro_torch
