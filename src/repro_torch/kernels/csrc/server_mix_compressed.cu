// The sync server plane over compressed client deltas, for Hopper
// (sm_90a), bound with ctypes.
//
// server_mix_delta   replaces the JAX package's kernels/server_plane.py:
//                    server_mix_delta_flat (Pallas): the AMA / FedAvg mix
//                    over int8 / bf16 delta rows, de-quantized in-kernel:
//                    out = prev * (a_eff + beta * sum_k w_k)
//                          + sum_k (beta * w_k * rowscale_k) * d_k.
// server_mix_scatter replaces kernels/server_plane.py:
//                    server_mix_scatter_flat: the same mix over top-k
//                    (value, flat position) pairs.
//
// Both are bound by HBM bytes. server_mix_delta streams the compressed
// rows themselves (1 byte an element for int8), never a dense f32 copy:
// N·2·s + K·N·r bytes. Same design as the mix kernel (csrc/common.cuh).
//
// server_mix_scatter does NOT follow the Pallas design, where every tile
// reads the whole (K, kk) list: that is O(tiles·K·kk) reads, quadratic
// in N at a fixed density. Here one call is a short sequence of
// launches on the caller's stream: a dense pass writes the f32
// accumulator prev * (a_eff + beta * sum_k w_k) (and the K row
// coefficients beta * w_k), then one launch per client k = 0..K-1 adds
// its kk contributions, then (bf16 prev only) a cast pass. Positions
// are distinct within a row, so each scatter launch writes every
// position at most once with no atomics, and the launches run in
// stream order: every element receives its contributions in client
// order, exactly as the plain version's index_add_ per client. Bytes:
// 2·N·s + K·kk·8 plus the accumulator's round trip for bf16 prev.

#include "common.cuh"

namespace {

using namespace repro_torch;

// The round's coefficients: bw_k = beta * w_k, and prev's coefficient
// a_eff + beta * sum_k w_k (a_eff = 1 when nobody is kept). With
// rowscale, bw_k is further multiplied by rowscale_k.
__device__ float compressed_coefs(const float* sizes, const float* keep,
                                  const float* coefs, const float* rowscale,
                                  int K, float* bw) {
  const float alpha = alpha_schedule(coefs);
  const float beta = __fsub_rn(1.f, alpha);
  const float tot = norm_weights(sizes, keep, false, K, bw);
  float sumw = bw[0];
  for (int k = 1; k < K; ++k) sumw = __fadd_rn(sumw, bw[k]);
  for (int k = 0; k < K; ++k) {
    bw[k] = __fmul_rn(beta, bw[k]);
    if (rowscale != nullptr) bw[k] = __fmul_rn(bw[k], rowscale[k]);
  }
  const float a_eff = tot > 0.f ? alpha : 1.f;
  return __fadd_rn(a_eff, __fmul_rn(beta, sumw));
}

template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
server_mix_delta_kernel(const T* __restrict__ prev,
                        const R* __restrict__ dstacked,
                        const float* __restrict__ rowscale,
                        const float* __restrict__ sizes,
                        const float* __restrict__ keep,
                        const float* __restrict__ coefs, T* __restrict__ out,
                        int K, long long N) {
  __shared__ float rc[kMaxK];
  __shared__ float c;
  if (threadIdx.x == 0) c = compressed_coefs(sizes, keep, coefs, rowscale,
                                             K, rc);
  __syncthreads();
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float acc = __fmul_rn(ld(prev, i), c);
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(ld(dstacked, k * n + i), rc[k]));
    st(out, i, acc);
  }
}

// acc = prev * c over all N; block 0 also publishes bw for the scatters
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_dense_kernel(const T* __restrict__ prev,
                     const float* __restrict__ sizes,
                     const float* __restrict__ keep,
                     const float* __restrict__ coefs,
                     float* __restrict__ acc, float* __restrict__ bw_out,
                     int K, long long N) {
  __shared__ float bw[kMaxK];
  __shared__ float c;
  if (threadIdx.x == 0) {
    c = compressed_coefs(sizes, keep, coefs, nullptr, K, bw);
    if (blockIdx.x == 0)
      for (int k = 0; k < K; ++k) bw_out[k] = bw[k];
  }
  __syncthreads();
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    acc[i] = __fmul_rn(ld(prev, i), c);
}

// client k's kk pairs into acc; positions are distinct within the row,
// so no two threads of this launch touch one element
__global__ void __launch_bounds__(kThreads)
scatter_row_kernel(const float* __restrict__ vals,
                   const int* __restrict__ idx,
                   const float* __restrict__ bw, float* __restrict__ acc,
                   int k, long long kk, long long N) {
  const float bwk = bw[k];
  const size_t row = static_cast<size_t>(k) * static_cast<size_t>(kk);
  const size_t m = static_cast<size_t>(kk);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    const long long p = __ldg(idx + row + j);
    if (p < 0 || p >= N) continue;  // outside the vector: adds nothing
    acc[p] = __fadd_rn(acc[p], __fmul_rn(__ldg(vals + row + j), bwk));
  }
}

__global__ void __launch_bounds__(kThreads)
cast_bf16_kernel(const float* __restrict__ acc,
                 __nv_bfloat16* __restrict__ out, long long N) {
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = __float2bfloat16_rn(acc[i]);
}

template <typename T, typename R>
void launch_delta(const void* prev, const void* dstacked, const float* rs,
                  const float* sz, const float* kp, const float* cf,
                  void* out, int K, long long N, cudaStream_t s) {
  server_mix_delta_kernel<T, R><<<grid_for(N), kThreads, 0, s>>>(
      static_cast<const T*>(prev), static_cast<const R*>(dstacked), rs, sz,
      kp, cf, static_cast<T*>(out), K, N);
}

template <typename T>
void launch_delta_rows(int rows, const void* prev, const void* dstacked,
                       const float* rs, const float* sz, const float* kp,
                       const float* cf, void* out, int K, long long N,
                       cudaStream_t s) {
  if (rows == 0)
    launch_delta<T, float>(prev, dstacked, rs, sz, kp, cf, out, K, N, s);
  else if (rows == 1)
    launch_delta<T, __nv_bfloat16>(prev, dstacked, rs, sz, kp, cf, out, K,
                                   N, s);
  else
    launch_delta<T, int8_t>(prev, dstacked, rs, sz, kp, cf, out, K, N, s);
}

}  // namespace

// dtype: prev and out, 0 = float32, 1 = bfloat16; rows: the delta rows,
// 0 = float32, 1 = bfloat16, 2 = int8.
extern "C" int server_mix_delta(int dtype, int rows, const void* prev,
                                const void* dstacked, const void* rowscale,
                                const void* sizes, const void* keep,
                                const void* coefs, void* out, int K,
                                long long N, void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || rows < 0 || rows > 2)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rs = static_cast<const float*>(rowscale);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* kp = static_cast<const float*>(keep);
  const auto* cf = static_cast<const float*>(coefs);
  if (dtype == 0)
    launch_delta_rows<float>(rows, prev, dstacked, rs, sz, kp, cf, out, K, N,
                             s);
  else if (dtype == 1)
    launch_delta_rows<__nv_bfloat16>(rows, prev, dstacked, rs, sz, kp, cf,
                                     out, K, N, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// dtype: prev and out, 0 = float32, 1 = bfloat16. acc is an f32 (N,)
// accumulator (out itself when dtype is 0); bw is (K,) f32 scratch.
// 1 + K launches, plus one cast launch for bf16.
extern "C" int server_mix_scatter(int dtype, const void* prev,
                                  const void* vals, const void* idx,
                                  const void* sizes, const void* keep,
                                  const void* coefs, void* out, void* acc,
                                  void* bw, int K, long long kk, long long N,
                                  void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || kk < 0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* kp = static_cast<const float*>(keep);
  const auto* cf = static_cast<const float*>(coefs);
  auto* a = static_cast<float*>(acc);
  auto* b = static_cast<float*>(bw);
  if (dtype == 0)
    scatter_dense_kernel<float><<<grid_for(N), kThreads, 0, s>>>(
        static_cast<const float*>(prev), sz, kp, cf, a, b, K, N);
  else
    scatter_dense_kernel<__nv_bfloat16><<<grid_for(N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(prev), sz, kp, cf, a, b, K, N);
  int err = cudaGetLastError();
  if (err != 0) return err;
  if (kk > 0) {
    for (int k = 0; k < K; ++k) {
      scatter_row_kernel<<<grid_for(kk), kThreads, 0, s>>>(
          static_cast<const float*>(vals), static_cast<const int*>(idx), b,
          a, k, kk, N);
      err = cudaGetLastError();
      if (err != 0) return err;
    }
  }
  if (dtype == 1)
    cast_bf16_kernel<<<grid_for(N), kThreads, 0, s>>>(
        a, static_cast<__nv_bfloat16*>(out), N);
  return cudaGetLastError();
}
