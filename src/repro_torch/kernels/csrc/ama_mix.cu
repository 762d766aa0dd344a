// The AMA parameter-mix kernel for Hopper (sm_90a), bound with ctypes.
//
// ama_mix replaces the JAX package's kernels/ama_mix.py: ama_mix_flat
// (Pallas): out = alpha * prev + sum_k w_k * stacked_k over one flat
// leaf, accumulated in f32, written in prev's dtype. It carries the
// legacy per-leaf server chain under --server-plane legacy --use-kernel
// (kernels/ops.py): K = 1 for the pairwise mix of ama, fedavg and
// fedprox and for fedopt's step (alpha = 1, w = [server_lr]); K = 2 for
// async AMA (the on-time aggregate and the popped stale sum, both f32).
//
// Bound by HBM bytes: per element it reads prev and K stacked values
// and writes one output, 2K+1 flops against (K+2)*N*s bytes for element
// size s, far below the card's ridge point. The design is server_mix's:
// alpha and w come from DEVICE pointers (the legacy chain computes them
// on the device, so a round reads nothing on the host) into shared
// memory, then one thread per element walks a grid-stride loop. Each
// output element is written by one thread and there are no atomics, so
// a launch is deterministic. Every multiply and add is rounded on its
// own (__fmul_rn / __fadd_rn, no contraction into FMA) in the op order
// of the plain version (kernels/ref.py: ama_mix_math), so the kernel
// equals it bit for bit.
//
// prev and stacked take f32 or bf16 independently: the async operand is
// f32 whatever the leaf dtype, as in the JAX package.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not 0.

#include "common.cuh"

namespace {

using namespace repro_torch;

template <typename TP, typename TS>
__global__ void __launch_bounds__(kThreads)
ama_mix_kernel(const TP* __restrict__ prev, const TS* __restrict__ stacked,
               const float* __restrict__ alpha,
               const float* __restrict__ weights, TP* __restrict__ out,
               int K, long long N) {
  __shared__ float w[kMaxK];
  __shared__ float a;
  for (int k = threadIdx.x; k < K; k += blockDim.x) w[k] = weights[k];
  if (threadIdx.x == 0) a = alpha[0];
  __syncthreads();
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float acc = __fmul_rn(ld(prev, i), a);
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(ld(stacked, k * n + i), w[k]));
    st(out, i, acc);
  }
}

template <typename TP, typename TS>
void launch(const void* prev, const void* stacked, const float* alpha,
            const float* weights, void* out, int K, long long N,
            cudaStream_t s) {
  ama_mix_kernel<TP, TS><<<grid_for(N), kThreads, 0, s>>>(
      static_cast<const TP*>(prev), static_cast<const TS*>(stacked), alpha,
      weights, static_cast<TP*>(out), K, N);
}

}  // namespace

// prev_dtype / stacked_dtype: 0 = float32, 1 = bfloat16; out has prev's.
extern "C" int ama_mix(int prev_dtype, int stacked_dtype, const void* prev,
                       const void* stacked, const void* alpha,
                       const void* weights, void* out, int K, long long N,
                       void* stream) {
  if (K < 1 || K > kMaxK || N < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(alpha);
  const auto* w = static_cast<const float*>(weights);
  using bf16 = __nv_bfloat16;
  switch (prev_dtype * 2 + stacked_dtype) {
    case 0: launch<float, float>(prev, stacked, a, w, out, K, N, s); break;
    case 1: launch<float, bf16>(prev, stacked, a, w, out, K, N, s); break;
    case 2: launch<bf16, float>(prev, stacked, a, w, out, K, N, s); break;
    case 3: launch<bf16, bf16>(prev, stacked, a, w, out, K, N, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
