// The AMA parameter-mix kernel for Hopper (sm_90a), bound with ctypes.
//
// ama_mix replaces the JAX package's kernels/ama_mix.py: ama_mix_flat
// (Pallas): out = alpha * prev + sum_k w_k * stacked_k over a flat leaf,
// accumulated in f32, written in prev's dtype. It carries the legacy
// server chain under --server-plane legacy --use-kernel (kernels/ops.py):
// K = 1 for the pairwise mix of ama, fedavg and fedprox and for fedopt's
// step (alpha = 1, w = [server_lr]); K = 2 for async AMA (the on-time
// aggregate and the popped stale sum, both f32).
//
// What bounds it. Per element it reads prev and K stacked values and
// writes one output: 2K+1 flops against (K+2)*N*s bytes for element size
// s, far below the card's ridge point. But the chain mixes every leaf of
// the model each round, and the paper CNN's 8 leaves hold 10 to 38,400
// elements (54,784 in all, 657 KB at K = 1 in f32: 0.2 us of HBM time).
// One launch a leaf cost ~2.5 us each, so a round paid for launches and
// host calls, not bytes.
//
// The design: ONE launch covers many leaves. The leaf table (each leaf's
// prev / stacked / out pointers, N, first block and vector flag, up to
// kMaxLeaves leaves) is a kernel parameter passed by value
// (__grid_constant__, under the 4 KB parameter limit), so a round copies
// nothing to the device and a CUDA graph captures it as it is. Each block
// finds its leaf by a binary search over the first-block prefix and
// walks that leaf with the leaf's other blocks in a grid-stride loop (a
// leaf takes at most kMaxBlocks blocks), kThreads units at a time:
// 16-byte loads (a unit of 8 elements where either operand is bf16, else
// 4) where the leaf's N is a multiple of the unit and its three pointers
// are 16-byte aligned, one element a unit otherwise. The host decides
// that per leaf and the C entry checks the table against it. A vector
// thread loads prev and up to kMixRows client rows before it combines
// them; a per-element thread takes kUnroll of its grid-stride elements
// at once, so that their loads are in flight together (one at a time, a
// ragged leaf of 33,554,437 elements ran 1.2-1.7x slower than a
// one-leaf kernel with its own grid, PERF.md). The Python wrapper
// (kernels/ama_mix.py: leaf_launches) groups leaves by (prev dtype,
// stacked dtype), one launch a group, and splits a group beyond
// kMaxLeaves in leaf order, as PyTorch's multi_tensor_apply does.
//
// alpha and w come from DEVICE pointers (the legacy chain computes them
// on the device, so a round reads nothing on the host) into shared
// memory. Each output element is written by one thread and there are no
// atomics, so a launch is deterministic. Every multiply and add is
// rounded on its own (__fmul_rn / __fadd_rn, no contraction into FMA) in
// the op order of the plain version (kernels/ref.py: ama_mix_math:
// acc = prev * alpha, then acc += x_k * w_k for k ascending), so both
// paths equal it bit for bit.
//
// prev and stacked take f32 or bf16 independently: the async operand is
// f32 whatever the leaf dtype, as in the JAX package.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not 0.

#include <algorithm>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kMaxLeaves = 64;  // ama_mix.py: MAX_LEAVES
constexpr int kMixRows = 4;     // client rows a vector thread loads at once

// ama_mix.py: _LeafTable, field for field
struct LeafTable {
  const void* prev[kMaxLeaves];
  const void* stacked[kMaxLeaves];
  void* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_block[kMaxLeaves + 1];  // first_block[count]: the grid
  int vec[kMaxLeaves];
  int count;
};
// with alpha, weights and K, the kernel's parameters stay under 4 KB
static_assert(sizeof(LeafTable) + 32 <= 4096, "leaf table over 4 KB");

template <typename TP, typename TS>
__global__ void __launch_bounds__(kThreads)
ama_mix_leaves_kernel(const __grid_constant__ LeafTable t,
                      const float* __restrict__ alpha,
                      const float* __restrict__ weights, int K) {
  constexpr int E = unit_elems<TP, TS>();
  __shared__ float w[kMaxK];
  __shared__ float a;
  for (int k = threadIdx.x; k < K; k += blockDim.x) w[k] = weights[k];
  if (threadIdx.x == 0) a = alpha[0];
  // this block's leaf: the last j with first_block[j] <= blockIdx.x
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const size_t n = static_cast<size_t>(t.n[lo]);
  // the leaf's blocks walk it in a grid-stride loop of their own
  const size_t stride = static_cast<size_t>(t.first_block[lo + 1] -
                                            t.first_block[lo]) * kThreads;
  const size_t u0 = static_cast<size_t>(b - t.first_block[lo]) * kThreads +
                    threadIdx.x;
  const TP* __restrict__ prev = static_cast<const TP*>(t.prev[lo]);
  const TS* __restrict__ stacked = static_cast<const TS*>(t.stacked[lo]);
  TP* __restrict__ out = static_cast<TP*>(t.out[lo]);
  __syncthreads();
  if (t.vec[lo]) {
    for (size_t u = u0; u < n / E; u += stride) {
      float acc[E], x[E];
      unpack_words(ld_words<TP, E>(prev, u), acc);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], a);
      for (int k0 = 0; k0 < K; k0 += kMixRows) {
        Words<TS, E> row[kMixRows];
#pragma unroll
        for (int q = 0; q < kMixRows; ++q)
          if (k0 + q < K)
            row[q] = ld_words<TS, E>(stacked + (k0 + q) * n, u);
#pragma unroll
        for (int q = 0; q < kMixRows; ++q) {
          if (k0 + q < K) {
            unpack_words(row[q], x);
            const float wk = w[k0 + q];
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], wk));
          }
        }
      }
      st_words<TP, E>(out, u, acc);
    }
  } else {
    for (size_t u = u0; u < n; u += kUnroll * stride) {
      float acc[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r)
        if (u + r * stride < n)
          acc[r] = __fmul_rn(ld(prev, u + r * stride), a);
      for (int k = 0; k < K; ++k) {
        const float wk = w[k];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r)
          if (u + r * stride < n)
            acc[r] = __fadd_rn(
                acc[r], __fmul_rn(ld(stacked, k * n + u + r * stride), wk));
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r)
        if (u + r * stride < n) st(out, u + r * stride, acc[r]);
    }
  }
}

// The table as the kernel reads it: leaf j has first_block[j+1] -
// first_block[j] = min(ceil(units / kThreads), kMaxBlocks) blocks, a
// unit being E elements where vec[j] (N a multiple of E, every pointer
// 16-byte aligned) and one element otherwise.
template <typename TP, typename TS>
bool table_ok(const LeafTable& t) {
  constexpr int E = unit_elems<TP, TS>();
  if (t.count < 1 || t.count > kMaxLeaves || t.first_block[0] != 0)
    return false;
  for (int j = 0; j < t.count; ++j) {
    const long long n = t.n[j];
    if (n < 1) return false;
    if (t.vec[j] && (n % E != 0 || !aligned16(t.prev[j]) ||
                     !aligned16(t.stacked[j]) || !aligned16(t.out[j])))
      return false;
    const long long units = t.vec[j] ? n / E : n;
    const long long blocks =
        std::min((units + kThreads - 1) / kThreads, kMaxBlocks);
    if (t.first_block[j + 1] - static_cast<long long>(t.first_block[j]) !=
        blocks)
      return false;
  }
  return true;
}

template <typename TP, typename TS>
int launch(const LeafTable& t, const float* alpha, const float* weights,
           int K, cudaStream_t s) {
  if (!table_ok<TP, TS>(t)) return cudaErrorInvalidValue;
  ama_mix_leaves_kernel<TP, TS><<<t.first_block[t.count], kThreads, 0, s>>>(
      t, alpha, weights, K);
  return cudaGetLastError();
}

}  // namespace

// prev_dtype / stacked_dtype: 0 = float32, 1 = bfloat16, for every leaf
// of the table (outputs in prev's). table: a host LeafTable of
// table_bytes bytes, copied into the launch's parameters.
extern "C" int ama_mix_leaves(int prev_dtype, int stacked_dtype,
                              const void* table, long long table_bytes,
                              const void* alpha, const void* weights, int K,
                              void* stream) {
  if (table_bytes != static_cast<long long>(sizeof(LeafTable)) || K < 1 ||
      K > kMaxK)
    return cudaErrorInvalidValue;
  const auto& t = *static_cast<const LeafTable*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(alpha);
  const auto* w = static_cast<const float*>(weights);
  using bf16 = __nv_bfloat16;
  switch (prev_dtype * 2 + stacked_dtype) {
    case 0: return launch<float, float>(t, a, w, K, s);
    case 1: return launch<float, bf16>(t, a, w, K, s);
    case 2: return launch<bf16, float>(t, a, w, K, s);
    case 3: return launch<bf16, bf16>(t, a, w, K, s);
    default: return cudaErrorInvalidValue;
  }
}
