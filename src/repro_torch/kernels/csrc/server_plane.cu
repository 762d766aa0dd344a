// Fused server-plane kernels for Hopper (sm_90a), bound with ctypes.
//
// server_mix   replaces the JAX package's kernels/server_plane.py:
//              server_mix_flat (Pallas): the sync AMA / FedAvg mix.
// server_async replaces kernels/server_plane.py: server_async_flat: the
//              async AMA ring-buffer enqueue + pop + mix (Eqs. 6-11).
//
// Both are bound by HBM bytes: a handful of flops per element moved.
// Each block computes the round's scalars (weights, alpha schedule,
// staleness table) from the device arrays into shared memory, then walks
// a grid-stride loop, accumulating in f32. Each output element is written
// by exactly one thread and there are no atomics, so a launch is
// deterministic. Every multiply and add is rounded on its own
// (__fmul_rn / __fadd_rn, no contraction into FMA), in the op order of
// the plain PyTorch versions in kernels/ref.py.
//
// server_mix has two such kernels, and the C entry picks one by the
// operands' layout. Where N is a multiple of the 16-byte vector (4 f32 or
// 8 bf16 elements) and prev, stacked and out start on 16-byte boundaries,
// every row k (which starts at element k N) is vector-aligned at every
// vector index, and server_mix_vec_kernel moves whole 16-byte vectors:
// each thread loads prev's vector and the vectors of up to kVecRows
// client rows before it combines them, so a thread has 16 (kVecRows + 1)
// bytes in flight where the per-element kernel had 2 or 4 bytes a
// stream. At the LLM paths' N (bf16, K = 2) the per-element kernel
// reached 42% of HBM peak (PERF.md). Otherwise server_mix_kernel takes
// one element a thread. The per-element op order is the same in both, so
// both equal ref.server_mix_math bit for bit. server_mix_design_counts
// reads the launches of each.
//
// The C entries return cudaGetLastError() after the launch; the Python
// wrappers raise when it is not 0.

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kMaxQ = 32;                   // server_plane.py: MAX_Q

// Eq. 9's alpha^- = 1 - sigmoid(1) rounded to f32 as the JAX package
// computes it (kernels/ref.py: ALPHA_UNNORM carries the same bits).
constexpr float kAlphaUnnorm = 0x1.13656p-2f;

// beta * w_k into bw (see norm_weights); returns tot.
__device__ float beta_weights(const float* sizes, const float* keep,
                              bool keep_is_delayed, float beta, int K,
                              float* bw) {
  const float tot = norm_weights(sizes, keep, keep_is_delayed, K, bw);
  for (int k = 0; k < K; ++k) bw[k] = __fmul_rn(beta, bw[k]);
  return tot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
server_mix_kernel(const T* __restrict__ prev, const T* __restrict__ stacked,
                  const float* __restrict__ sizes,
                  const float* __restrict__ keep,
                  const float* __restrict__ coefs, T* __restrict__ out,
                  int K, long long N) {
  __shared__ float bw[kMaxK];
  __shared__ float a_eff;
  if (threadIdx.x == 0) {
    // coefs = [alpha0, eta, alpha_cap, t]
    const float alpha = alpha_schedule(coefs);
    const float beta = __fsub_rn(1.f, alpha);
    const float tot = beta_weights(sizes, keep, false, beta, K, bw);
    a_eff = tot > 0.f ? alpha : __fadd_rn(alpha, beta);
  }
  __syncthreads();
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float acc = __fmul_rn(ld(prev, i), a_eff);
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(ld(stacked, k * n + i), bw[k]));
    st(out, i, acc);
  }
}

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

constexpr int kVecRows = 8;  // client rows a thread loads before combining

// server_mix on 16-byte vectors: N a multiple of Vec16<T>::E, every
// pointer 16-byte aligned (the C entry checks). The same scalars and the
// same per-element op order as server_mix_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
server_mix_vec_kernel(const T* __restrict__ prev,
                      const T* __restrict__ stacked,
                      const float* __restrict__ sizes,
                      const float* __restrict__ keep,
                      const float* __restrict__ coefs, T* __restrict__ out,
                      int K, long long N) {
  using V = Vec16<T>;
  constexpr int E = V::E;
  __shared__ float bw[kMaxK];
  __shared__ float a_eff;
  if (threadIdx.x == 0) {
    const float alpha = alpha_schedule(coefs);
    const float beta = __fsub_rn(1.f, alpha);
    const float tot = beta_weights(sizes, keep, false, beta, K, bw);
    a_eff = tot > 0.f ? alpha : __fadd_rn(alpha, beta);
  }
  __syncthreads();
  const size_t nv = static_cast<size_t>(N) / E;
  const auto* pv = reinterpret_cast<const uint4*>(prev);
  const auto* sv = reinterpret_cast<const uint4*>(stacked);
  auto* ov = reinterpret_cast<uint4*>(out);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nv; i += stride) {
    float acc[E], x[E];
    V::unpack(__ldg(pv + i), acc);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], a_eff);
    for (int k0 = 0; k0 < K; k0 += kVecRows) {
      uint4 row[kVecRows];
#pragma unroll
      for (int q = 0; q < kVecRows; ++q)
        if (k0 + q < K) row[q] = __ldg(sv + (k0 + q) * nv + i);
#pragma unroll
      for (int q = 0; q < kVecRows; ++q) {
        if (k0 + q < K) {
          V::unpack(row[q], x);
          const float b = bw[k0 + q];
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], b));
        }
      }
    }
    ov[i] = V::pack(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
server_async_kernel(const T* __restrict__ prev, const T* __restrict__ stacked,
                    const float* __restrict__ qsum,
                    const float* __restrict__ qgamma,
                    const float* __restrict__ sizes,
                    const float* __restrict__ delayed,
                    const int* __restrict__ delays, const int* __restrict__ tq,
                    const float* __restrict__ hyp, T* __restrict__ out,
                    float* __restrict__ qsum_out,
                    float* __restrict__ qgamma_out, int K, int Q,
                    long long N) {
  __shared__ float onehot[kMaxK * kMaxQ];  // gamma^-_k where arrival_k == q
  __shared__ float bw[kMaxK];              // beta * w_k (on-time weights)
  __shared__ float sel[kMaxQ];             // pop mask, slot t % Q
  __shared__ float a_eff, gscale;
  const int t = tq[0], pop = tq[1];
  // hyp = [alpha0, eta, alpha_cap, staleness_b]
  for (int j = threadIdx.x; j < K * Q; j += blockDim.x) {
    const int k = j / Q, q = j % Q;
    // gamma^- = b * sigmoid(-d), with sigmoid(-d) = 1 / (1 + exp(d))
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf((float)delays[k])));
    const float g = __fmul_rn(__fmul_rn(hyp[3], sig), delayed[k]);
    const int arrival = (t + delays[k]) % Q;
    onehot[j] = __fmul_rn(arrival == q ? 1.f : 0.f, g);
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    sel[q] = q == pop ? 1.f : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float stale_gamma = 0.f;
    for (int q = 0; q < Q; ++q) {
      float s = onehot[q];
      for (int k = 1; k < K; ++k) s = __fadd_rn(s, onehot[k * Q + q]);
      const float qg = __fadd_rn(qgamma[q], s);
      if (blockIdx.x == 0) qgamma_out[q] = __fmul_rn(qg, __fsub_rn(1.f, sel[q]));
      const float term = __fmul_rn(qg, sel[q]);
      stale_gamma = q == 0 ? term : __fadd_rn(stale_gamma, term);
    }
    const float A = fminf(__fadd_rn(hyp[0], __fmul_rn(hyp[1], (float)t)), hyp[2]);
    const float beta = __fsub_rn(1.f, A);
    const float denom = __fadd_rn(kAlphaUnnorm, stale_gamma);
    const float alpha = __fmul_rn(__fdiv_rn(kAlphaUnnorm, denom), A);  // Eq. 10
    gscale = __fdiv_rn(A, denom);                                      // Eq. 11
    const float tot = beta_weights(sizes, delayed, true, beta, K, bw);
    a_eff = tot > 0.f ? alpha : __fadd_rn(alpha, beta);
  }
  __syncthreads();
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // on-time chain: acc = prev * a_eff, then + x_k * (beta * w_k)
    float acc = __fmul_rn(ld(prev, i), a_eff);
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(ld(stacked, k * n + i), bw[k]));
    // per-slot enqueue chains (k in order), then the pop sum from q = 0;
    // the client rows are re-read once per slot (from L1/L2)
    float stale = 0.f;
    for (int q = 0; q < Q; ++q) {
      float r = __ldg(qsum + q * n + i);
#pragma unroll 4
      for (int k = 0; k < K; ++k)
        r = __fadd_rn(r, __fmul_rn(ld(stacked, k * n + i), onehot[k * Q + q]));
      const float term = __fmul_rn(r, sel[q]);
      stale = q == 0 ? term : __fadd_rn(stale, term);
      qsum_out[q * n + i] = __fmul_rn(r, __fsub_rn(1.f, sel[q]));
    }
    st(out, i, __fadd_rn(acc, __fmul_rn(stale, gscale)));
  }
}

// launches of server_mix so far: [0] the per-element kernel, [1] the
// 16-byte vector kernel
long long g_mix_launches[2] = {0, 0};

template <typename T>
int launch_server_mix(const void* prev, const void* stacked,
                      const float* sizes, const float* keep,
                      const float* coefs, void* out, int K, long long N,
                      cudaStream_t s) {
  const auto* p = static_cast<const T*>(prev);
  const auto* x = static_cast<const T*>(stacked);
  auto* o = static_cast<T*>(out);
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (N % Vec16<T>::E == 0 && aligned(prev) && aligned(stacked) &&
      aligned(out)) {
    server_mix_vec_kernel<T><<<grid_for(N / Vec16<T>::E), kThreads, 0, s>>>(
        p, x, sizes, keep, coefs, o, K, N);
    ++g_mix_launches[1];
  } else {
    server_mix_kernel<T><<<grid_for(N), kThreads, 0, s>>>(p, x, sizes, keep,
                                                          coefs, o, K, N);
    ++g_mix_launches[0];
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (prev, stacked and out).
extern "C" int server_mix(int dtype, const void* prev, const void* stacked,
                          const void* sizes, const void* keep,
                          const void* coefs, void* out, int K, long long N,
                          void* stream) {
  if (K < 1 || K > kMaxK || N < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* kp = static_cast<const float*>(keep);
  const auto* cf = static_cast<const float*>(coefs);
  if (dtype == 0)
    return launch_server_mix<float>(prev, stacked, sz, kp, cf, out, K, N, s);
  if (dtype == 1)
    return launch_server_mix<__nv_bfloat16>(prev, stacked, sz, kp, cf, out,
                                            K, N, s);
  return cudaErrorInvalidValue;
}

// counts[design] = server_mix launches so far (0 per element, 1 vector)
extern "C" void server_mix_design_counts(long long* counts) {
  counts[0] = g_mix_launches[0];
  counts[1] = g_mix_launches[1];
}

extern "C" int server_async(int dtype, const void* prev, const void* stacked,
                            const void* qsum, const void* qgamma,
                            const void* sizes, const void* delayed,
                            const void* delays, const void* tq,
                            const void* hyp, void* out, void* qsum_out,
                            void* qgamma_out, int K, int Q, long long N,
                            void* stream) {
  if (K < 1 || K > kMaxK || Q < 1 || Q > kMaxQ || N < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qs = static_cast<const float*>(qsum);
  const auto* qg = static_cast<const float*>(qgamma);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* dl = static_cast<const float*>(delayed);
  const auto* ds = static_cast<const int*>(delays);
  const auto* tqp = static_cast<const int*>(tq);
  const auto* hp = static_cast<const float*>(hyp);
  auto* qso = static_cast<float*>(qsum_out);
  auto* qgo = static_cast<float*>(qgamma_out);
  if (dtype == 0) {
    server_async_kernel<float><<<grid_for(N), kThreads, 0, s>>>(
        static_cast<const float*>(prev), static_cast<const float*>(stacked),
        qs, qg, sz, dl, ds, tqp, hp, static_cast<float*>(out), qso, qgo, K,
        Q, N);
  } else if (dtype == 1) {
    server_async_kernel<__nv_bfloat16><<<grid_for(N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(prev),
        static_cast<const __nv_bfloat16*>(stacked), qs, qg, sz, dl, ds, tqp,
        hp, static_cast<__nv_bfloat16*>(out), qso, qgo, K, Q, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
