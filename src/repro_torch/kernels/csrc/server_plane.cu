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
// Each has two such kernels, and its C entry picks one by the operands'
// layout. Where N is a multiple of the 16-byte vector (4 f32 or 8 bf16
// elements) and every operand starts on a 16-byte boundary, every row
// (which starts at element k N, or q N in the ring) is vector-aligned at
// every vector index, and the _vec_ kernel moves whole 16-byte vectors;
// otherwise the per-element kernel takes one element a thread. The
// per-element op order is the same in both, so both equal the plain
// version bit for bit. server_mix_design_counts and
// server_async_design_counts read the launches of each.
//
// server_mix_vec_kernel: each thread loads prev's vector and the vectors
// of up to kVecRows client rows before it combines them, so a thread has
// 16 (kVecRows + 1) bytes in flight where the per-element kernel had 2 or
// 4 bytes a stream. At the LLM paths' N (bf16, K = 2) the per-element
// kernel reached 42% of HBM peak (PERF.md).
//
// server_async moves (K+2) N s + 2 Q N 4 bytes: the client rows and prev
// in, out, and the f32 ring of Q slots read and written. Its per-element
// kernel (any K, any layout) reads each client value again for every
// slot, Q + 1 times, on 4-byte loads; before this design thread 0 of
// every block also formed the whole prologue alone (the K x Q one-hot
// table's slot sums, the pop sum and the weights), and at the paper
// CNN's shape (K 5, Q 11, N 54,784, f32) it ran at 18% of its bound.
// server_async_vec_kernel (K <= kVecRows) loads prev and the K client
// vectors into registers once and walks the slots over them several at a
// time: every byte moves once, on 16-byte loads. Both kernels share a
// prologue that the block forms in parallel (async_prologue), its small
// operands staged into shared memory in one wait; only the Q-term pop
// sum and the K weights stay serial, in one thread. At small N the
// kernel is bound by latency, not bytes (the CNN's 6.4 MB take 1.9 us at
// HBM rate): the vector kernel loads a thread's first vectors and first
// ring slots before the prologue, so that one wait covers them all.
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

// The async plane's round scalars in shared memory. ROWS bounds K (the
// one-hot table is ROWS x kMaxQ).
template <int ROWS>
struct AsyncScalars {
  // gamma^-_k where arrival_k == q, else 0, at [q ROWS + k]: a slot's K
  // weights side by side (16-byte loads in the vector kernel)
  alignas(16) float onehot[kMaxQ * ROWS];
  float sizes[ROWS], delayed[ROWS];  // the round's operands, staged
  int delays[ROWS];
  float qgamma[kMaxQ], hyp[4];
  int t, pop;
  float bw[ROWS];              // beta * w_k (on-time weights)
  float sel[kMaxQ];            // pop mask, slot t % Q
  float term[kMaxQ];           // slot q's gamma sum times sel[q]
  float a_eff, gscale;
};

// Forms the round's scalars with the whole block. The small operands
// are staged into shared memory first, one element a thread, so the
// prologue waits for device memory once. Then the K x Q one-hot table,
// one entry a thread; each slot's sum over k (k ascending) by its own
// thread, with its new qgamma (block 0 writes it) and its pop term; then
// thread 0 alone folds the Q pop terms from q = 0 (stale_gamma), alpha,
// gscale and the K weights. Ends with the block synchronised.
template <int ROWS>
__device__ void async_prologue(AsyncScalars<ROWS>& sh,
                               const float* __restrict__ qgamma,
                               const float* __restrict__ sizes,
                               const float* __restrict__ delayed,
                               const int* __restrict__ delays,
                               const int* __restrict__ tq,
                               const float* __restrict__ hyp,
                               float* __restrict__ qgamma_out, int K, int Q) {
  for (int j = threadIdx.x; j < 3 * K + Q + 6; j += blockDim.x) {
    if (j < K) sh.sizes[j] = sizes[j];
    else if (j < 2 * K) sh.delayed[j - K] = delayed[j - K];
    else if (j < 3 * K) sh.delays[j - 2 * K] = delays[j - 2 * K];
    else if (j < 3 * K + Q) sh.qgamma[j - 3 * K] = qgamma[j - 3 * K];
    else if (j < 3 * K + Q + 4) sh.hyp[j - 3 * K - Q] = hyp[j - 3 * K - Q];
    else if (j == 3 * K + Q + 4) sh.t = tq[0];
    else sh.pop = tq[1];
  }
  __syncthreads();
  // hyp = [alpha0, eta, alpha_cap, staleness_b]
  for (int j = threadIdx.x; j < K * Q; j += blockDim.x) {
    const int k = j / Q, q = j % Q;
    // gamma^- = b * sigmoid(-d), with sigmoid(-d) = 1 / (1 + exp(d))
    const float sig =
        __fdiv_rn(1.f, __fadd_rn(1.f, expf((float)sh.delays[k])));
    const float g = __fmul_rn(__fmul_rn(sh.hyp[3], sig), sh.delayed[k]);
    const int arrival = (sh.t + sh.delays[k]) % Q;
    sh.onehot[q * ROWS + k] = __fmul_rn(arrival == q ? 1.f : 0.f, g);
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    sh.sel[q] = q == sh.pop ? 1.f : 0.f;
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float s = sh.onehot[q * ROWS];
    for (int k = 1; k < K; ++k) s = __fadd_rn(s, sh.onehot[q * ROWS + k]);
    const float qg = __fadd_rn(sh.qgamma[q], s);
    if (blockIdx.x == 0)
      qgamma_out[q] = __fmul_rn(qg, __fsub_rn(1.f, sh.sel[q]));
    sh.term[q] = __fmul_rn(qg, sh.sel[q]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float stale_gamma = sh.term[0];
    for (int q = 1; q < Q; ++q)
      stale_gamma = __fadd_rn(stale_gamma, sh.term[q]);
    const float A = fminf(
        __fadd_rn(sh.hyp[0], __fmul_rn(sh.hyp[1], (float)sh.t)), sh.hyp[2]);
    const float beta = __fsub_rn(1.f, A);
    const float denom = __fadd_rn(kAlphaUnnorm, stale_gamma);
    const float alpha = __fmul_rn(__fdiv_rn(kAlphaUnnorm, denom), A);  // Eq. 10
    sh.gscale = __fdiv_rn(A, denom);                                   // Eq. 11
    const float tot =
        beta_weights(sh.sizes, sh.delayed, true, beta, K, sh.bw);
    sh.a_eff = tot > 0.f ? alpha : __fadd_rn(alpha, beta);
  }
  __syncthreads();
}

#define ASYNC_PARAMS                                                        \
  const T *__restrict__ prev, const T *__restrict__ stacked,                \
      const float *__restrict__ qsum, const float *__restrict__ qgamma,     \
      const float *__restrict__ sizes, const float *__restrict__ delayed,   \
      const int *__restrict__ delays, const int *__restrict__ tq,           \
      const float *__restrict__ hyp, T *__restrict__ out,                   \
      float *__restrict__ qsum_out, float *__restrict__ qgamma_out, int K,  \
      int Q, long long N
#define ASYNC_ARGS                                                          \
  prev, stacked, qsum, qgamma, sizes, delayed, delays, tq, hyp, out,        \
      qsum_out, qgamma_out, K, Q, N

// One element a thread, any K <= kMaxK and any layout: each client value
// is read again for every ring slot (from L1/L2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
server_async_kernel(ASYNC_PARAMS) {
  __shared__ AsyncScalars<kMaxK> sh;
  async_prologue(sh, qgamma, sizes, delayed, delays, tq, hyp, qgamma_out, K,
                 Q);
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // on-time chain: acc = prev * a_eff, then + x_k * (beta * w_k)
    float acc = __fmul_rn(ld(prev, i), sh.a_eff);
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(ld(stacked, k * n + i), sh.bw[k]));
    // per-slot enqueue chains (k in order), then the pop sum from q = 0
    float stale = 0.f;
    for (int q = 0; q < Q; ++q) {
      float r = __ldg(qsum + q * n + i);
#pragma unroll 4
      for (int k = 0; k < K; ++k)
        r = __fadd_rn(r, __fmul_rn(ld(stacked, k * n + i),
                                   sh.onehot[q * kMaxK + k]));
      const float term = __fmul_rn(r, sh.sel[q]);
      stale = q == 0 ? term : __fadd_rn(stale, term);
      qsum_out[q * n + i] = __fmul_rn(r, __fsub_rn(1.f, sh.sel[q]));
    }
    st(out, i, __fadd_rn(acc, __fmul_rn(stale, sh.gscale)));
  }
}

constexpr int kAsyncVecThreads = 128;  // more, smaller blocks at small N
constexpr int kSlotWords = 4;  // 16-byte words of ring slots loaded at once

// prev's vector i and the K client rows' (row k starts at vector k nv)
__device__ __forceinline__ void load_rows(const uint4* __restrict__ pv,
                                          const uint4* __restrict__ sv,
                                          size_t nv, size_t i, int K,
                                          uint4& p, uint4 (&x)[kVecRows]) {
  p = __ldg(pv + i);
#pragma unroll
  for (int k = 0; k < kVecRows; ++k)
    if (k < K) x[k] = __ldg(sv + k * nv + i);
}

// the f32 vectors i of ring slots q0 .. q0 + B - 1 (those below Q)
template <int E, int B>
__device__ __forceinline__ void load_slots(const float* __restrict__ qsum,
                                           size_t n, size_t i, int q0, int Q,
                                           Words<float, E> (&slot)[B]) {
#pragma unroll
  for (int j = 0; j < B; ++j)
    if (q0 + j < Q) slot[j] = ld_words<float, E>(qsum + (q0 + j) * n, i);
}

// server_async on 16-byte vectors: K <= kVecRows, N a multiple of
// Vec16<T>::E, every pointer 16-byte aligned (the C entry checks). A
// thread holds prev's vector and its K client vectors in registers, forms
// the on-time chain, then walks the ring slots B at a time (8 f32
// vectors under f32 prev, 4 pairs under bf16): each slot's f32 vector
// takes the K client terms from registers, k ascending, folds into the
// pop sum in q order and is stored. A thread's first vectors and first
// slots are loaded before the prologue, so their latency overlaps it.
// Every zero one-hot term and unselected slot is still multiplied and
// added, as in the plain version (r + x * 0 turns a -0.0 into +0.0; a
// NaN propagates). Each byte of the function moves once: (K+2) N s +
// 2 Q N 4.
template <typename T>
__global__ void __launch_bounds__(kAsyncVecThreads)
server_async_vec_kernel(ASYNC_PARAMS) {
  using V = Vec16<T>;
  constexpr int E = V::E;
  constexpr int B = kSlotWords / Words<float, E>::n;
  __shared__ AsyncScalars<kVecRows> sh;
  const size_t n = static_cast<size_t>(N), nv = n / E;
  const auto* pv = reinterpret_cast<const uint4*>(prev);
  const auto* sv = reinterpret_cast<const uint4*>(stacked);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint4 p = {}, x[kVecRows] = {};
  Words<float, E> slot[B] = {};
  if (i < nv) {
    load_rows(pv, sv, nv, i, K, p, x);
    load_slots(qsum, n, i, 0, Q, slot);
  }
  async_prologue(sh, qgamma, sizes, delayed, delays, tq, hyp, qgamma_out, K,
                 Q);
  while (i < nv) {
    float acc[E], v[E], r[E], stale[E] = {};
    V::unpack(p, acc);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], sh.a_eff);
#pragma unroll
    for (int k = 0; k < kVecRows; ++k) {
      if (k < K) {
        V::unpack(x[k], v);
        const float b = sh.bw[k];
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], b));
      }
    }
    for (int q0 = 0; q0 < Q; q0 += B) {
      if (q0 > 0) load_slots(qsum, n, i, q0, Q, slot);
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int q = q0 + j;
        if (q < Q) {
          unpack_words(slot[j], r);
          static_assert(kVecRows == 8, "two float4 a slot's weights");
          const auto* oh = reinterpret_cast<const float4*>(
              sh.onehot + q * kVecRows);
          const float4 o0 = oh[0], o1 = oh[1];
          const float ohq[kVecRows] = {o0.x, o0.y, o0.z, o0.w,
                                       o1.x, o1.y, o1.z, o1.w};
#pragma unroll
          for (int k = 0; k < kVecRows; ++k) {
            if (k < K) {
              V::unpack(x[k], v);
              const float o = ohq[k];
#pragma unroll
              for (int e = 0; e < E; ++e)
                r[e] = __fadd_rn(r[e], __fmul_rn(v[e], o));
            }
          }
          const float sq = sh.sel[q], keep = __fsub_rn(1.f, sq);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float term = __fmul_rn(r[e], sq);
            stale[e] = q == 0 ? term : __fadd_rn(stale[e], term);
            r[e] = __fmul_rn(r[e], keep);
          }
          st_words<float, E>(qsum_out + q * n, i, r);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(stale[e], sh.gscale));
    reinterpret_cast<uint4*>(out)[i] = V::pack(acc);
    i += stride;
    if (i < nv) {
      load_rows(pv, sv, nv, i, K, p, x);
      load_slots(qsum, n, i, 0, Q, slot);
    }
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
  if (N % Vec16<T>::E == 0 && aligned16(prev) && aligned16(stacked) &&
      aligned16(out)) {
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

// launches of server_async so far: [0] per element, [1] vector
long long g_async_launches[2] = {0, 0};

template <typename T>
int launch_server_async(ASYNC_PARAMS, cudaStream_t s) {
  if (K <= kVecRows && N % Vec16<T>::E == 0 && aligned16(prev) &&
      aligned16(stacked) && aligned16(qsum) && aligned16(out) &&
      aligned16(qsum_out)) {
    const int grid = grid_for(N / Vec16<T>::E, kAsyncVecThreads);
    server_async_vec_kernel<T><<<grid, kAsyncVecThreads, 0, s>>>(ASYNC_ARGS);
    ++g_async_launches[1];
  } else {
    server_async_kernel<T><<<grid_for(N), kThreads, 0, s>>>(ASYNC_ARGS);
    ++g_async_launches[0];
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
  if (dtype == 0)
    return launch_server_async<float>(
        static_cast<const float*>(prev), static_cast<const float*>(stacked),
        qs, qg, sz, dl, ds, tqp, hp, static_cast<float*>(out), qso, qgo, K,
        Q, N, s);
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return launch_server_async<bf16>(
        static_cast<const bf16*>(prev), static_cast<const bf16*>(stacked),
        qs, qg, sz, dl, ds, tqp, hp, static_cast<bf16*>(out), qso, qgo, K, Q,
        N, s);
  return cudaErrorInvalidValue;
}

// counts[design] = server_async launches so far (0 per element, 1 vector)
extern "C" void server_async_design_counts(long long* counts) {
  counts[0] = g_async_launches[0];
  counts[1] = g_async_launches[1];
}
