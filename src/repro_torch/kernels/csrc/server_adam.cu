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
// bytes for some twenty flops. Each thread runs the plain version's op
// order with every operation rounded on its own; m and v stay f32, out
// is cast to prev's dtype. Bias corrections 1 - b1^step and 1 - b2^step
// come from powf, the function PyTorch's CUDA pow calls for f32.
//
// Two kernels, one op order, picked by the C entry by the operands'
// layout alone. Where N is a multiple of prev's 16-byte vector (4 f32 or
// 8 bf16 elements) and all seven operands start on a 16-byte boundary,
// server_adam_vec_kernel gives a thread one vector: prev's word, m's and
// v's (1 or 2 words), and the words of up to kVecRows client rows are
// all loaded before any is combined, and out, m and v are stored as
// whole words; its blocks are one warp (kVecThreads), so that the capped
// grid is resident in one wave at large N. Otherwise server_adam_kernel
// takes kUnroll elements of a grid-stride loop a thread at once. At the
// paper CNN's shape (K 5, N 54,784 f32, 2.4 MB) a call is latency: one
// element a thread on 4-byte loads, after thread 0 alone had read the
// scalars from device memory and formed both powf, ran at 5.8x its
// bound (PERF.md). Here adam_prologue stages the scalars into shared
// memory in one wait, two lanes form the two powf side by side, and the
// rest is formed behind two barriers; the vector kernel issues a
// thread's first loads before it, so that one wait covers both.
// server_adam_design_counts reads the launches of each kernel.

#include "common.cuh"

namespace {

using namespace repro_torch;

// The round's scalars in shared memory.
struct AdamScalars {
  float prod[kMaxK];                   // sizes_k keep_k, staged
  float sc[5];                         // staged: [b1, b2, lr, tau, step],
                                       // step already incremented
  float omb[2], bc[2];                 // 1 - b, 1 - b^step for b1, b2
  float w[kMaxK];                      // w_k
};

// Forms the scalars with the whole block behind two barriers: the
// operands staged into shared memory, one element a thread, in one wait
// for device memory (the K products formed in the same pass; the two
// bias corrections and 1 - b by the block's last two threads side by
// side, from their own loads); then each thread takes tot from k = 0 up
// itself (broadcast reads) and thread k forms w_k. Returns tot.
__device__ float adam_prologue(AdamScalars& sh,
                               const float* __restrict__ sizes,
                               const float* __restrict__ keep,
                               const float* __restrict__ scalars, int K) {
  for (int j = threadIdx.x; j < K + 5; j += blockDim.x) {
    if (j < K) sh.prod[j] = __fmul_rn(sizes[j], keep[j]);
    else sh.sc[j - K] = scalars[j - K];
  }
  if (threadIdx.x >= blockDim.x - 2) {  // two lanes of one warp, at once
    const int b = threadIdx.x - (blockDim.x - 2);
    sh.omb[b] = __fsub_rn(1.f, scalars[b]);
    sh.bc[b] = __fsub_rn(1.f, powf(scalars[b], scalars[4]));
  }
  __syncthreads();
  float tot = sh.prod[0];
  for (int k = 1; k < K; ++k) tot = __fadd_rn(tot, sh.prod[k]);
  const float denom = fmaxf(tot, 1e-9f);
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    sh.w[k] = __fdiv_rn(sh.prod[k], denom);
  __syncthreads();
  return tot;
}

// One element's step from its weighted client sum agg: new m and v into
// m and v, the new model value returned (before the cast to prev's
// dtype). The plain version's op order (kernels/ref.py:
// server_adam_math).
__device__ __forceinline__ float adam_step(const AdamScalars& sh, bool kept,
                                           float p, float agg, float& m,
                                           float& v) {
  const float delta = kept ? __fsub_rn(agg, p) : 0.f;
  m = __fadd_rn(__fmul_rn(sh.sc[0], m), __fmul_rn(sh.omb[0], delta));
  v = __fadd_rn(__fmul_rn(sh.sc[1], v),
                __fmul_rn(__fmul_rn(sh.omb[1], delta), delta));
  const float update =
      __fdiv_rn(__fdiv_rn(m, sh.bc[0]),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v, sh.bc[1])), sh.sc[3]));
  return __fadd_rn(p, __fmul_rn(sh.sc[2], update));
}

#define ADAM_PARAMS                                                       \
  const T *__restrict__ prev, const T *__restrict__ stacked,              \
      const float *__restrict__ m, const float *__restrict__ v,           \
      const float *__restrict__ sizes, const float *__restrict__ keep,    \
      const float *__restrict__ scalars, T *__restrict__ out,             \
      float *__restrict__ m_out, float *__restrict__ v_out, int K,        \
      long long N
#define ADAM_ARGS \
  prev, stacked, m, v, sizes, keep, scalars, out, m_out, v_out, K, N

// Any N and layout: kUnroll elements of the grid-stride loop a thread at
// once, so that their loads are in flight together (the loop over the
// rows unrolled by 2: 58 registers a thread where it took 80 rolled).
template <typename T>
__global__ void __launch_bounds__(kThreads) server_adam_kernel(ADAM_PARAMS) {
  __shared__ AdamScalars sh;
  const bool kept = adam_prologue(sh, sizes, keep, scalars, K) > 0.f;
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += kUnroll * stride) {
    float p[kUnroll], mm[kUnroll], vv[kUnroll], agg[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const size_t j = i + r * stride;
      if (j < n) {
        p[r] = ld(prev, j);
        mm[r] = __ldg(m + j);
        vv[r] = __ldg(v + j);
        agg[r] = 0.f;
      }
    }
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float wk = sh.w[k];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const size_t j = i + r * stride;
        if (j < n)
          agg[r] = __fadd_rn(agg[r], __fmul_rn(ld(stacked, k * n + j), wk));
      }
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const size_t j = i + r * stride;
      if (j < n) {
        const float o = adam_step(sh, kept, p[r], agg[r], mm[r], vv[r]);
        m_out[j] = mm[r];
        v_out[j] = vv[r];
        st(out, j, o);
      }
    }
  }
}

// N a multiple of Vec16<T>::E and every operand 16-byte aligned (the C
// entry checks): a thread owns one vector of prev's dtype, E elements,
// and moves it in whole 16-byte words. Its first vector's words are
// loaded before the prologue.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
server_adam_vec_kernel(ADAM_PARAMS) {
  constexpr int E = Vec16<T>::E;
  __shared__ AdamScalars sh;
  const size_t n = static_cast<size_t>(N), nv = n / E;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Words<T, E> pw = {}, x[kVecRows] = {};
  Words<float, E> mw = {}, vw = {};
  if (i < nv) {
    pw = ld_words<T, E>(prev, i);
    mw = ld_words<float, E>(m, i);
    vw = ld_words<float, E>(v, i);
    ld_row_batch(stacked, n, i, 0, K, x);
  }
  const bool kept = adam_prologue(sh, sizes, keep, scalars, K) > 0.f;
  while (i < nv) {
    float agg[E], xe[E];
#pragma unroll
    for (int e = 0; e < E; ++e) agg[e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kVecRows) {
      if (k0 > 0) ld_row_batch(stacked, n, i, k0, K, x);
#pragma unroll
      for (int q = 0; q < kVecRows; ++q) {
        if (k0 + q < K) {
          unpack_words(x[q], xe);
          const float wk = sh.w[k0 + q];
#pragma unroll
          for (int e = 0; e < E; ++e)
            agg[e] = __fadd_rn(agg[e], __fmul_rn(xe[e], wk));
        }
      }
    }
    float p[E], mm[E], vv[E], o[E];
    unpack_words(pw, p);
    unpack_words(mw, mm);
    unpack_words(vw, vv);
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[e] = adam_step(sh, kept, p[e], agg[e], mm[e], vv[e]);
    st_words<T, E>(out, i, o);
    st_words<float, E>(m_out, i, mm);
    st_words<float, E>(v_out, i, vv);
    i += stride;
    if (i < nv) {
      pw = ld_words<T, E>(prev, i);
      mw = ld_words<float, E>(m, i);
      vw = ld_words<float, E>(v, i);
      ld_row_batch(stacked, n, i, 0, K, x);
    }
  }
}

// launches of server_adam so far: [0] per element, [1] vector
long long g_adam_launches[2] = {0, 0};

template <typename T>
int launch_adam(ADAM_PARAMS, cudaStream_t s) {
  if (N % Vec16<T>::E == 0 && aligned16(prev) && aligned16(stacked) &&
      aligned16(m) && aligned16(v) && aligned16(out) && aligned16(m_out) &&
      aligned16(v_out)) {
    const int grid = grid_for(N / Vec16<T>::E, kVecThreads);
    server_adam_vec_kernel<T><<<grid, kVecThreads, 0, s>>>(ADAM_ARGS);
    ++g_adam_launches[1];
  } else {
    server_adam_kernel<T><<<grid_for(N), kThreads, 0, s>>>(ADAM_ARGS);
    ++g_adam_launches[0];
  }
  return cudaGetLastError();
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
  if (dtype == 0)
    return launch_adam<float>(
        static_cast<const float*>(prev), static_cast<const float*>(stacked),
        mp, vp, sz, kp, sc, static_cast<float*>(out), mo, vo, K, N, s);
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return launch_adam<bf16>(
        static_cast<const bf16*>(prev), static_cast<const bf16*>(stacked),
        mp, vp, sz, kp, sc, static_cast<bf16*>(out), mo, vo, K, N, s);
  return cudaErrorInvalidValue;
}

// counts[design] = server_adam launches so far (0 per element, 1 vector)
extern "C" void server_adam_design_counts(long long* counts) {
  counts[0] = g_adam_launches[0];
  counts[1] = g_adam_launches[1];
}
