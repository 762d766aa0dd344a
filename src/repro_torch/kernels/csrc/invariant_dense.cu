// invariant_dense: y = x @ w (+ b) for the serving projections, with every
// output element summed over K in an order fixed by K and N alone,
// whatever the number of rows M.
//
// Replaces no Pallas kernel: it is the XLA dot of the JAX package's
// models/layers.py: dense (:22) on the serving path. cuBLAS picks its
// tiling and its split of K by M, so on the card a row of a 256-row
// prefill chunk and the same row of a 4-row decode step came out of
// different sums (w_out, K = 16,384: up to 1.56e-2 apart), and chunked
// prefill no longer served the per-token loop's tokens. The JAX package's
// serving contract (chunked == per token, paged == dense, bit for bit)
// needs a product whose rows do not depend on their neighbours.
//
// x (M, K) and w (K, N) row-major (w in the JAX layout, d_in x d_out), b
// (N) or null, y (M, N) in x's dtype; f32 accumulation.
//
// bf16, on the tensor cores (wgmma m64n64k16, both operands in shared
// memory in the 128-byte swizzle: x K-major, w MN-major as it lies): a
// block, one warpgroup, owns a 64 x 64 tile of y and walks its K range in
// steps of 64 through a 3-deep cp.async ring, the four k16 products of a
// step in order; rows past M are zero and never loaded (an element
// of a product is its own dot product, so a row's bits do not depend on
// the rows beside it or on where it sits in the tile).
// K is cut into S equal ranges, S from (K, N) alone (the wrapper's
// split_k): the first power of two that gives 256 blocks over the n tiles
// or leaves ranges of 512. Each range writes an f32 partial; the last
// block of a tile to arrive (an integer counter, no float atomics) sums
// the S partials in range order and writes y. One launch a call.
//
// f32, on the CUDA cores: a thread owns a column and 8 rows, one fmaf a
// k in K order. No split.
//
// Bound: at decode (M = 4) the weights' bytes (minitron-8b's w_out, 128
// MB, is 0.040 ms at 3.35 TB/s): the split puts 256 blocks on the 132
// SMs, each with two 8 KB w tiles in flight. At a 256-row prefill chunk
// w_in (4096 x 16384) is 34.4 GFLOP, 0.035 ms at 989 TFLOP/s: one
// warpgroup a block keeps one step's products in flight while it waits
// for the last and refills its stage; no producer warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"
#include "sm90.cuh"

namespace {

using repro_torch::mma::cp16;
using repro_torch::mma::cp_commit;
using repro_torch::mma::cp_wait;
using repro_torch::sm90::desc;
using repro_torch::sm90::fence_regs;
using repro_torch::sm90::wgmma_commit;
using repro_torch::sm90::wgmma_fence;
using repro_torch::sm90::wgmma_ss;
using repro_torch::sm90::wgmma_wait;

// the tile of y a block owns (BM x BN: one warpgroup's m64 x n64 wgmma),
// its K step and the cp.async ring's stages
constexpr int BM = 64, BN = 64, BK = 64, STAGES = 3;
constexpr int kThreads = 128;                // one warpgroup
constexpr int kRow = 128;                    // bytes of a tile row (64 bf16)
constexpr int kTileA = BM * kRow;            // x: BM rows of BK
constexpr int kTileB = BK * kRow * (BN / 64);  // w: BN / 64 blocks of BK rows
constexpr int kStage = kTileA + kTileB;
constexpr int kSmem = STAGES * kStage + 1024;  // + room to align to 1 KB
static_assert(BN % 64 == 0 && BN <= 128, "n64 or n128");

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const __nv_bfloat16* b;   // or null
  __nv_bfloat16* y;
  float* part;              // (S, M, N) when S > 1
  int* count;               // one a tile (zero between launches)
  int M, N, K, S;
};

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRow + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st,
                                           int m0, int n0, int k0) {
  // x: rows past M are never loaded (zeroed once at the start)
  for (int e = threadIdx.x; e < BM * 8; e += kThreads) {
    const int row = e >> 3, ch = e & 7, m = m0 + row, k = k0 + ch * 8;
    if (m >= a.M) continue;
    const bool ok = k < a.K;
    cp16(st + swz(row, ch), ok ? a.x + static_cast<size_t>(m) * a.K + k : a.x,
         ok);
  }
  // w: BN / 64 column blocks of BK rows (n contiguous: MN-major B)
  for (int e = threadIdx.x; e < BK * 8 * (BN / 64); e += kThreads) {
    const int cb = e / (BK * 8), row = (e >> 3) % BK, ch = e & 7;
    const int k = k0 + row, n = n0 + cb * 64 + ch * 8;
    const bool ok = k < a.K && n < a.N;
    cp16(st + kTileA + cb * BK * kRow + swz(row, ch),
         ok ? a.w + static_cast<size_t>(k) * a.N + n : a.w, ok);
  }
}

__device__ __forceinline__ void store2(const Args& a, int m, int n, float v0,
                                       float v1) {
  if (a.b) {   // (x @ w) in the model dtype, then + b (layers.dense)
    v0 = __bfloat162float(__float2bfloat16_rn(v0)) +
         __bfloat162float(a.b[n]);
    v1 = __bfloat162float(__float2bfloat16_rn(v1)) +
         __bfloat162float(a.b[n + 1]);
  }
  *reinterpret_cast<__nv_bfloat162*>(a.y + static_cast<size_t>(m) * a.N +
                                     n) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    invariant_dense_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ int last;

  const int split = blockIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int range = a.K / a.S;                 // a multiple of BK, or K
  const int kb = split * range;
  const int steps = (range + BK - 1) / BK;
  const int live = min(BM, a.M - m0);          // rows of M in this tile

  if (live < BM)                               // the padding rows: zeros
    for (int s = 0; s < STAGES; ++s)
      for (int e = threadIdx.x; e < (BM - live) * 8; e += kThreads)
        *reinterpret_cast<uint4*>(smem + s * kStage +
                                  (live + (e >> 3)) * kRow + ((e & 7) << 4)) =
            make_uint4(0, 0, 0, 0);

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(a, smem + s * kStage, m0, n0, kb + s * BK);
    cp_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_wait<STAGES - 2>();
    fence_async_smem();               // the copies, seen by wgmma
    __syncthreads();                  // stage it landed
    const unsigned char* A = smem + (it % STAGES) * kStage;
    const unsigned char* B = A + kTileA;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)      // the k16 steps in order
      wgmma_ss<BN, 1>(acc, desc(A + kc * 32, 16, 1024),
                      desc(B + kc * 16 * kRow, BK * kRow, 1024), 1);
    wgmma_commit();
    // step it's products run on while step it - 1's are waited for, and
    // its stage refilled with step it + STAGES - 1
    wgmma_wait<1>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < steps)
      load_stage(a, smem + (nxt % STAGES) * kStage, m0, n0, kb + nxt * BK);
    cp_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_wait<0>();

  // acc[4 c + {0, 1}]: row 16 warp + lane / 4, columns 8 c + 2 (lane % 4)
  // + {0, 1}; acc[4 c + {2, 3}]: the same columns 8 rows down
  const int r_lo = m0 + 16 * warp + (lane >> 2);
  const int c_lo = n0 + 2 * (lane & 3);
  if (a.S == 1) {
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r_lo + 8 * h, n = c_lo + 8 * c;
        if (m < a.M && n < a.N)
          store2(a, m, n, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      }
    return;
  }
  // S > 1: this range's partial, then the tile's last block sums them
  float* part = a.part + static_cast<size_t>(split) * a.M * a.N;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r_lo + 8 * h, n = c_lo + 8 * c;
      if (m < a.M && n < a.N)
        *reinterpret_cast<float2*>(part + static_cast<size_t>(m) * a.N + n) =
            make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  __threadfence();
  __syncthreads();
  int* cnt = a.count + blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt, 1) == a.S - 1;
    if (last) *cnt = 0;                 // every range has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < live * BN / 2; e += kThreads) {
    const int m = m0 + e / (BN / 2), n = n0 + (e % (BN / 2)) * 2;
    if (n >= a.N) continue;
    const float* pe = a.part + static_cast<size_t>(m) * a.N + n;
    const size_t stride = static_cast<size_t>(a.M) * a.N;
    float2 v = __ldcg(reinterpret_cast<const float2*>(pe));
    for (int s0 = 1; s0 < a.S; s0 += 8) {  // 8 ranges' loads in flight
      float2 p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < a.S)
          p[j] = __ldcg(reinterpret_cast<const float2*>(pe + (s0 + j) *
                                                        stride));
#pragma unroll
      for (int j = 0; j < 8; ++j)        // the ranges in K order
        if (s0 + j < a.S) {
          v.x += p[j].x;
          v.y += p[j].y;
        }
    }
    store2(a, m, n, v.x, v.y);
  }
}

constexpr int kRowsF32 = 8;

__global__ void __launch_bounds__(128)
    invariant_dense_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ b,
                               float* __restrict__ y, int M, int N, int K) {
  const int n = blockIdx.x * 128 + threadIdx.x;
  const int m0 = blockIdx.y * kRowsF32;
  if (n >= N) return;
  const int rows = min(kRowsF32, M - m0);
  float acc[kRowsF32];
#pragma unroll
  for (int r = 0; r < kRowsF32; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; ++k) {         // K order, one fmaf a k
    const float wk = __ldg(w + static_cast<size_t>(k) * N + n);
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r)
      if (r < rows)
        acc[r] = fmaf(__ldg(x + static_cast<size_t>(m0 + r) * K + k), wk,
                      acc[r]);
  }
  for (int r = 0; r < rows; ++r)
    y[static_cast<size_t>(m0 + r) * N + n] = b ? acc[r] + b[n] : acc[r];
}

}  // namespace

// dtype 0 f32, 1 bf16; x (M, K), w (K, N), b (N) or null, y (M, N), all
// contiguous; S the split of K (bf16 only: kernels/invariant_dense.py
// split_k; K % (S * 64) == 0 when S > 1); part (S, M, N) f32 scratch and
// count (one int a 128 x 64 tile, zero) when S > 1. The wrapper checks
// shapes, dtypes, contiguity, 16-byte alignment and K, N % 8 == 0.
extern "C" int invariant_dense(int dtype, const void* x, const void* w,
                               const void* b, void* y, void* part,
                               void* count, int M, int N, int K, int S,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const dim3 grid((N + 127) / 128, (M + kRowsF32 - 1) / kRowsF32);
    invariant_dense_f32_kernel<<<grid, 128, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || S < 1 || (S > 1 && (K % (S * BK) || !part || !count)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        invariant_dense_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(w),
               static_cast<const __nv_bfloat16*>(b),
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
               static_cast<int*>(count), M, N, K, S};
  const dim3 grid(S, (M + BM - 1) / BM, (N + BN - 1) / BN);
  invariant_dense_bf16_kernel<<<grid, kThreads, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
