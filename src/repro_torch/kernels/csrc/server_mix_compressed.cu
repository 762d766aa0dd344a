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
// N·2·s + K·N·r bytes. It has two kernels, one op order, and its C entry
// picks one by the operands' layout alone. Where N is a multiple of the
// 16-byte unit E (16 elements under int8 rows, 8 where rows or prev are
// bf16, else 4) and prev, the rows and out start on a 16-byte boundary,
// server_mix_delta_vec_kernel gives a thread E consecutive elements:
// prev's words (4 of them for f32 prev under int8 rows) and one word of
// each of up to kVecRows client rows are loaded before any is combined,
// the int8 lanes widened exactly to f32 (Vec16<int8_t>); its blocks are
// one warp (kVecThreads), so that the CNN's 3,424 vectors spread over
// 107 SMs and the capped grid is resident in one wave at large N.
// Otherwise server_mix_delta_kernel takes kUnroll elements of a
// grid-stride loop a thread at once. One element a thread, as this
// kernel first was, issued one dependent 1-byte load a row an element
// and reached 52% of HBM peak at N 33,554,437 (K 10, int8 rows;
// PERF.md). At the paper CNN's 0.71 MB (K 5, N 54,784) a call is
// latency: thread 0 alone read the round's scalars from device memory
// while the block waited. Here delta_prologue stages them into shared
// memory in one wait and forms the rest behind two barriers, the vector
// kernel issuing a thread's first loads before it, so that one wait
// covers both; a call at N 54,784 then takes within half a microsecond
// of one at N 16 (PERF.md). server_mix_delta_design_counts reads the
// launches of each kernel.
//
// server_mix_scatter does NOT follow the Pallas design, where every tile
// reads the whole (K, kk) list: that is O(tiles·K·kk) reads, quadratic
// in N at a fixed density. Here one call is ONE cooperative launch
// (cudaLaunchCooperativeKernel) whose grid walks K + 1 phases (K + 2 for
// bf16 prev), separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()): a dense phase writes the f32
// accumulator prev * (a_eff + beta * sum_k w_k), then one phase per
// client k = 0..K-1 adds its kk contributions, then (bf16 prev only) a
// cast phase writes out. Every block computes the K row coefficients
// beta * w_k itself, in the plain version's op order, so no phase waits
// for them. Positions are distinct within a row, so a scatter phase
// writes every position at most once with no atomics, and the barriers
// order the phases: every element receives its contributions in client
// order, exactly as the plain version's index_add_ per client.
//
// Bound: bytes, 2·N·s + K·kk·8 (plus the accumulator's round trip for
// bf16 prev). The grid is a block for every 2048 elements of max(N, kk),
// at least one block an SM and at most the blocks resident at once (the
// cooperative launch's condition: the card refuses more, the C entry
// returns the error and the wrapper raises). At large N the phases
// stream bytes as the 1 + K launch design did. At the paper CNN's shape
// (K 5, N 54,784, kk 547) every phase is a few hundred nanoseconds of
// work and the call is latency: each client phase pays a grid barrier
// (a fence, one atomic arrival a block, a spin on the grid's counter)
// and a dependent read-modify-write of acc in L2, together about 1.5 us
// on an H100, about what a launch gap cost the 1 + K design. One
// launch therefore saves only the launch itself there, and index_add's
// one atomic pass stays faster (PERF.md). grid.sync() needs no
// relocatable device code (-rdc) since CUDA 11; the build's flags are
// unchanged, and the card runs it at the build's -gencode sm_90a.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro_torch;

// The scatter's round coefficients in one thread: bw_k = beta * w_k,
// and prev's coefficient a_eff + beta * sum_k w_k (a_eff = 1 when nobody
// is kept).
__device__ float compressed_coefs(const float* sizes, const float* keep,
                                  const float* coefs, int K, float* bw) {
  const float alpha = alpha_schedule(coefs);
  const float beta = __fsub_rn(1.f, alpha);
  const float tot = norm_weights(sizes, keep, false, K, bw);
  float sumw = bw[0];
  for (int k = 1; k < K; ++k) sumw = __fadd_rn(sumw, bw[k]);
  for (int k = 0; k < K; ++k) bw[k] = __fmul_rn(beta, bw[k]);
  const float a_eff = tot > 0.f ? alpha : 1.f;
  return __fadd_rn(a_eff, __fmul_rn(beta, sumw));
}

// The round's scalars of server_mix_delta in shared memory.
struct DeltaScalars {
  float prod[kMaxK];      // sizes_k keep_k, staged
  float rowscale[kMaxK];  // staged
  float coefs[4];         // staged: [alpha0, eta, alpha_cap, t]
  float w[kMaxK];         // w_k
  float rc[kMaxK];        // the row coefficients beta w_k rowscale_k
};

// compressed_coefs formed by the whole block behind two barriers: the
// operands staged into shared memory, one element a thread, in one wait
// for device memory (the K products formed in the same pass); then each
// thread takes tot from k = 0 up itself (broadcast reads) and thread k
// forms w_k and row k's coefficient; then each thread takes sum_k w_k
// from k = 0 up and returns prev's coefficient c = a_eff + beta sum_k w_k
// (a_eff = 1 when nobody is kept).
__device__ float delta_prologue(DeltaScalars& sh,
                                const float* __restrict__ sizes,
                                const float* __restrict__ keep,
                                const float* __restrict__ coefs,
                                const float* __restrict__ rowscale, int K) {
  for (int j = threadIdx.x; j < 2 * K + 4; j += blockDim.x) {
    if (j < K) sh.prod[j] = __fmul_rn(sizes[j], keep[j]);
    else if (j < 2 * K) sh.rowscale[j - K] = rowscale[j - K];
    else sh.coefs[j - 2 * K] = coefs[j - 2 * K];
  }
  __syncthreads();
  float tot = sh.prod[0];
  for (int k = 1; k < K; ++k) tot = __fadd_rn(tot, sh.prod[k]);
  const float alpha = alpha_schedule(sh.coefs);
  const float beta = __fsub_rn(1.f, alpha);
  const float denom = fmaxf(tot, 1e-9f);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float wk = __fdiv_rn(sh.prod[k], denom);
    sh.w[k] = wk;
    sh.rc[k] = __fmul_rn(__fmul_rn(beta, wk), sh.rowscale[k]);
  }
  __syncthreads();
  float sumw = sh.w[0];
  for (int k = 1; k < K; ++k) sumw = __fadd_rn(sumw, sh.w[k]);
  return __fadd_rn(tot > 0.f ? alpha : 1.f, __fmul_rn(beta, sumw));
}

#define DELTA_PARAMS                                                      \
  const T *__restrict__ prev, const R *__restrict__ dstacked,             \
      const float *__restrict__ rowscale, const float *__restrict__ sizes, \
      const float *__restrict__ keep, const float *__restrict__ coefs,    \
      T *__restrict__ out, int K, long long N

// Any N and layout: kUnroll elements of the grid-stride loop a thread at
// once, so that their loads are in flight together.
template <typename T, typename R>
__global__ void __launch_bounds__(kThreads)
server_mix_delta_kernel(DELTA_PARAMS) {
  __shared__ DeltaScalars sh;
  const float c = delta_prologue(sh, sizes, keep, coefs, rowscale, K);
  const size_t n = static_cast<size_t>(N);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += kUnroll * stride) {
    float acc[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
      if (i + r * stride < n)
        acc[r] = __fmul_rn(ld(prev, i + r * stride), c);
    for (int k = 0; k < K; ++k) {
      const float rc = sh.rc[k];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r)
        if (i + r * stride < n)
          acc[r] = __fadd_rn(
              acc[r], __fmul_rn(ld(dstacked, k * n + i + r * stride), rc));
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
      if (i + r * stride < n) st(out, i + r * stride, acc[r]);
  }
}

// N a multiple of E and prev, the rows and out 16-byte aligned (the C
// entry checks): a thread owns E consecutive elements, every row's
// vector i one word (E is 16 bytes of the narrower operand). The rows
// come kVecRows at a time; a thread's first words are loaded before
// the prologue.
template <typename T, typename R>
__global__ void __launch_bounds__(kVecThreads)
server_mix_delta_vec_kernel(DELTA_PARAMS) {
  constexpr int E = unit_elems<T, R>();
  __shared__ DeltaScalars sh;
  const size_t n = static_cast<size_t>(N), nv = n / E;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Words<T, E> pw = {};
  Words<R, E> x[kVecRows] = {};
  if (i < nv) {
    pw = ld_words<T, E>(prev, i);
    ld_row_batch(dstacked, n, i, 0, K, x);
  }
  const float c = delta_prologue(sh, sizes, keep, coefs, rowscale, K);
  while (i < nv) {
    float acc[E], d[E];
    unpack_words(pw, acc);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], c);
    for (int k0 = 0; k0 < K; k0 += kVecRows) {
      if (k0 > 0) ld_row_batch(dstacked, n, i, k0, K, x);
#pragma unroll
      for (int q = 0; q < kVecRows; ++q) {
        if (k0 + q < K) {
          unpack_words(x[q], d);
          const float rc = sh.rc[k0 + q];
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(d[e], rc));
        }
      }
    }
    st_words<T, E>(out, i, acc);
    i += stride;
    if (i < nv) {
      pw = ld_words<T, E>(prev, i);
      ld_row_batch(dstacked, n, i, 0, K, x);
    }
  }
}

// The whole scatter mix in one cooperative launch: acc = prev * c, then
// client k's kk pairs into acc for k = 0..K-1, then (bf16) out = acc,
// each phase after a grid barrier. acc is out itself for f32 prev.
template <typename T>
__global__ void __launch_bounds__(kThreads)
server_mix_scatter_kernel(const T* __restrict__ prev,
                          const float* __restrict__ vals,
                          const int* __restrict__ idx,
                          const float* __restrict__ sizes,
                          const float* __restrict__ keep,
                          const float* __restrict__ coefs, T* out,
                          float* acc, int K, long long kk, long long N) {
  __shared__ float bw[kMaxK];
  __shared__ float c;
  if (threadIdx.x == 0)
    c = compressed_coefs(sizes, keep, coefs, K, bw);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const size_t n = static_cast<size_t>(N);
  const size_t m = static_cast<size_t>(kk);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = first; i < n; i += stride)
    acc[i] = __fmul_rn(ld(prev, i), c);
  for (int k = 0; k < K && m > 0; ++k) {
    grid.sync();  // every earlier phase's writes are visible
    const float bwk = bw[k];
    const size_t row = static_cast<size_t>(k) * m;
    for (size_t j = first; j < m; j += stride) {
      const long long p = __ldg(idx + row + j);
      if (p < 0 || p >= N) continue;  // outside the vector: adds nothing
      acc[p] = __fadd_rn(acc[p], __fmul_rn(__ldg(vals + row + j), bwk));
    }
  }
  if constexpr (!std::is_same_v<T, float>) {
    grid.sync();
    for (size_t i = first; i < n; i += stride) st(out, i, acc[i]);
  }
}

// One cooperative launch of server_mix_scatter_kernel<T>: a block for
// every kScatterPerBlock elements of max(N, kk), at least one block an SM
// (a phase's cost is its latency, not its bytes, below that), at most the
// blocks resident at once.
constexpr long long kScatterPerBlock = 8LL * kThreads;

template <typename T>
int launch_scatter(const void* prev, const void* vals, const void* idx,
                   const float* sz, const float* kp, const float* cf,
                   void* out, float* acc, int K, long long kk, long long N,
                   cudaStream_t s) {
  const auto kernel = server_mix_scatter_kernel<T>;
  int dev = 0, sms = 0, per_sm = 0;
  int err = cudaGetDevice(&dev);
  if (err == 0)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != 0) return err;
  const long long work = N > kk ? N : kk;
  const long long resident = static_cast<long long>(per_sm) * sms;
  long long want = (work + kScatterPerBlock - 1) / kScatterPerBlock;
  if (want < sms) want = sms;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  auto* p = static_cast<const T*>(prev);
  auto* v = static_cast<const float*>(vals);
  auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<T*>(out);
  void* args[] = {&p, &v, &ix, &sz, &kp, &cf, &o, &acc, &K, &kk, &N};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    s);
  return err != 0 ? err : cudaGetLastError();
}

// launches of server_mix_delta so far: [0] per element, [1] vector
long long g_delta_launches[2] = {0, 0};

template <typename T, typename R>
int launch_delta(const void* prev, const void* dstacked, const float* rs,
                 const float* sz, const float* kp, const float* cf,
                 void* out, int K, long long N, cudaStream_t s) {
  constexpr int E = unit_elems<T, R>();
  const auto* p = static_cast<const T*>(prev);
  const auto* d = static_cast<const R*>(dstacked);
  auto* o = static_cast<T*>(out);
  if (N % E == 0 && aligned16(prev) && aligned16(dstacked) &&
      aligned16(out)) {
    server_mix_delta_vec_kernel<T, R>
        <<<grid_for(N / E, kVecThreads), kVecThreads, 0, s>>>(
            p, d, rs, sz, kp, cf, o, K, N);
    ++g_delta_launches[1];
  } else {
    server_mix_delta_kernel<T, R><<<grid_for(N), kThreads, 0, s>>>(
        p, d, rs, sz, kp, cf, o, K, N);
    ++g_delta_launches[0];
  }
  return cudaGetLastError();
}

template <typename T>
int launch_delta_rows(int rows, const void* prev, const void* dstacked,
                      const float* rs, const float* sz, const float* kp,
                      const float* cf, void* out, int K, long long N,
                      cudaStream_t s) {
  if (rows == 0)
    return launch_delta<T, float>(prev, dstacked, rs, sz, kp, cf, out, K, N,
                                  s);
  if (rows == 1)
    return launch_delta<T, __nv_bfloat16>(prev, dstacked, rs, sz, kp, cf,
                                          out, K, N, s);
  return launch_delta<T, int8_t>(prev, dstacked, rs, sz, kp, cf, out, K, N,
                                 s);
}

}  // namespace

// dtype: prev and out, 0 = float32, 1 = bfloat16; rows: the delta rows,
// 0 = float32, 1 = bfloat16, 2 = int8.
extern "C" int server_mix_delta(int dtype, int rows, const void* prev,
                                const void* dstacked, const void* rowscale,
                                const void* sizes, const void* keep,
                                const void* coefs, void* out, int K,
                                long long N, void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || rows < 0 || rows > 2 ||
      rowscale == nullptr)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rs = static_cast<const float*>(rowscale);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* kp = static_cast<const float*>(keep);
  const auto* cf = static_cast<const float*>(coefs);
  if (dtype == 0)
    return launch_delta_rows<float>(rows, prev, dstacked, rs, sz, kp, cf,
                                    out, K, N, s);
  if (dtype == 1)
    return launch_delta_rows<__nv_bfloat16>(rows, prev, dstacked, rs, sz,
                                            kp, cf, out, K, N, s);
  return cudaErrorInvalidValue;
}

// counts[design] = server_mix_delta launches so far (0 per element, 1
// vector)
extern "C" void server_mix_delta_design_counts(long long* counts) {
  counts[0] = g_delta_launches[0];
  counts[1] = g_delta_launches[1];
}

// dtype: prev and out, 0 = float32, 1 = bfloat16. acc is an f32 (N,)
// accumulator (out itself when dtype is 0). One cooperative launch; a
// launch the card refuses returns its error.
extern "C" int server_mix_scatter(int dtype, const void* prev,
                                  const void* vals, const void* idx,
                                  const void* sizes, const void* keep,
                                  const void* coefs, void* out, void* acc,
                                  int K, long long kk, long long N,
                                  void* stream) {
  if (K < 1 || K > kMaxK || N < 1 || kk < 0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sz = static_cast<const float*>(sizes);
  const auto* kp = static_cast<const float*>(keep);
  const auto* cf = static_cast<const float*>(coefs);
  auto* a = static_cast<float*>(acc);
  if (dtype == 0)
    return launch_scatter<float>(prev, vals, idx, sz, kp, cf, out, a, K, kk,
                                 N, s);
  return launch_scatter<__nv_bfloat16>(prev, vals, idx, sz, kp, cf, out, a,
                                       K, kk, N, s);
}
