// invariant_rmsnorm: RMSNorm of the serving steps, each row reduced in an
// order fixed by its width d alone, whatever the number of rows M.
//
// Replaces no Pallas kernel: it is the XLA reduction of the JAX package's
// models/layers.py: rmsnorm (:41) on the serving path. PyTorch's CUDA
// mean picks its threads per row by the number of rows, so a row's mean
// of squares, and at bf16 the normed row itself (up to 3.9e-3 apart at d
// 4,096 between M = 4 and 256), depended on how many rows came with it,
// and chunked prefill no longer matched the per-token loop.
//
// y = (x * rsqrt(mean(x^2) + eps)) * g in f32, cast to x's dtype, as
// kernels/ref.py: invariant_rmsnorm_ref. One block of 256 threads a row:
// thread t sums the squares of elements t, t + 256, ... in order, the
// 256 sums are folded by a fixed butterfly (lanes, then the 8 warps'
// sums), then every element is scaled. Every multiply and add rounds on
// its own. Bound: bytes (x read, y written once); a launch at M = 4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    invariant_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             T* __restrict__ y, int d, float eps) {
  __shared__ float part[kThreads / 32];
  __shared__ float scale;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f(xr[i]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = kThreads / 64; o; o >>= 1)
      w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, o));
    if (threadIdx.x == 0)
      scale = rsqrtf(__fadd_rn(__fdiv_rn(w, static_cast<float>(d)), eps));
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < d; i += kThreads)
    put(yr + i, __fmul_rn(__fmul_rn(to_f(xr[i]), r), to_f(g[i])));
}

}  // namespace

// dtype 0 f32, 1 bf16; x, y (M, d) contiguous, g (d); the wrapper
// (kernels/invariant_rmsnorm.py) checks shapes, dtypes and contiguity.
extern "C" int invariant_rmsnorm(int dtype, const void* x, const void* g,
                                 void* y, int M, int d, float eps,
                                 void* stream) {
  if (M < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    invariant_rmsnorm_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(y),
        d, eps);
  else if (dtype == 0)
    invariant_rmsnorm_kernel<float><<<M, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(y), d, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
