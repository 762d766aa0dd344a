// The FedOpt server plane for Hopper (sm_90a), bound with ctypes.
//
// server_adam replaces the JAX package's kernels/server_plane.py:
//             server_adam_flat (Pallas): the weighted pseudo-gradient
//             agg - prev (0 when nobody is kept), one server-Adam moment
//             update with bias correction, and the model step
//             prev + lr * m_hat / (sqrt(v_hat) + tau), in one pass.
//
// Bound by HBM bytes: per element it reads K+1 rows in prev's dtype and
// the f32 moments m and v, and writes out, m and v: (K+2)·N·s + 16·N
// bytes for some twenty flops. The design is the mix kernel's
// (csrc/common.cuh): the block prologue computes the weights, tot and
// the bias corrections 1 - b1^step, 1 - b2^step once into shared memory
// (powf, the function PyTorch's CUDA pow calls for f32), and one thread
// per element runs the plain version's op order with every operation
// rounded on its own. m and v stay f32; out is cast to prev's dtype.

#include "common.cuh"

namespace {

using namespace repro_torch;

template <typename T>
__global__ void __launch_bounds__(kThreads)
server_adam_kernel(const T* __restrict__ prev, const T* __restrict__ stacked,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const float* __restrict__ sizes,
                   const float* __restrict__ keep,
                   const float* __restrict__ scalars, T* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ v_out,
                   int K, long long N) {
  __shared__ float w[kMaxK];
  __shared__ float tot, b1, b2, omb1, omb2, lr, tau, bc1, bc2;
  if (threadIdx.x == 0) {
    // scalars = [b1, b2, lr, tau, step] (step already incremented)
    tot = norm_weights(sizes, keep, false, K, w);
    b1 = scalars[0];
    b2 = scalars[1];
    lr = scalars[2];
    tau = scalars[3];
    omb1 = __fsub_rn(1.f, b1);
    omb2 = __fsub_rn(1.f, b2);
    bc1 = __fsub_rn(1.f, powf(b1, scalars[4]));
    bc2 = __fsub_rn(1.f, powf(b2, scalars[4]));
  }
  __syncthreads();
  const bool kept = tot > 0.f;
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float agg = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      agg = __fadd_rn(agg, __fmul_rn(ld(stacked, k * n + i), w[k]));
    const float p = ld(prev, i);
    const float delta = kept ? __fsub_rn(agg, p) : 0.f;
    const float nm = __fadd_rn(__fmul_rn(b1, __ldg(m + i)),
                               __fmul_rn(omb1, delta));
    const float nv = __fadd_rn(__fmul_rn(b2, __ldg(v + i)),
                               __fmul_rn(__fmul_rn(omb2, delta), delta));
    const float update =
        __fdiv_rn(__fdiv_rn(nm, bc1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(nv, bc2)), tau));
    m_out[i] = nm;
    v_out[i] = nv;
    st(out, i, __fadd_rn(p, __fmul_rn(lr, update)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (prev, stacked and out).
extern "C" int server_adam(int dtype, const void* prev, const void* stacked,
                           const void* m, const void* v, const void* sizes,
                           const void* keep, const void* scalars, void* out,
                           void* m_out, void* v_out, int K, long long N,
                           void* stream) {
  if (K < 1 || K > kMaxK || N < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* mp = static_cast<const float*>(m);
  const auto* vp = static_cast<const float*>(v);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* kp = static_cast<const float*>(keep);
  const auto* sc = static_cast<const float*>(scalars);
  auto* mo = static_cast<float*>(m_out);
  auto* vo = static_cast<float*>(v_out);
  if (dtype == 0) {
    server_adam_kernel<float><<<grid_for(N), kThreads, 0, s>>>(
        static_cast<const float*>(prev), static_cast<const float*>(stacked),
        mp, vp, sz, kp, sc, static_cast<float*>(out), mo, vo, K, N);
  } else if (dtype == 1) {
    server_adam_kernel<__nv_bfloat16><<<grid_for(N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(prev),
        static_cast<const __nv_bfloat16*>(stacked), mp, vp, sz, kp, sc,
        static_cast<__nv_bfloat16*>(out), mo, vo, K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
