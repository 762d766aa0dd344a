// invariant_dense: y = x @ w (+ b) for the serving projections, with every
// output element summed over K in an order fixed by K and N alone,
// whatever the number of rows M; one launch for a group of projections
// that share x (wq|wk|wv, w_in|w_gate).
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
// The sum of an element (bf16, tensor cores). Every product is a wgmma
// m64n128k16 (both operands in shared memory in the 128-byte swizzle: x
// K-major, w MN-major as it lies) whose 64-row tile starts at a multiple
// of 64, so row m always sits at row m % 64 of its instruction. The
// block's n tile is one n128 instruction wide whatever M is. K is cut into
// S equal ranges, S = split_k(K, N) (kernels/invariant_dense.py; a power
// of two <= 8): a range is walked in steps of 64, the four k16 products of
// a step in K order into one f32 accumulator. With S > 1 the S ranges of a
// tile are S neighbouring blocks of one thread-block cluster (the launch's
// cluster is the largest S of its problems); each puts its f32 partial in
// its own shared memory and, after the cluster's barrier, sums 1/S of the
// tile's rows over the S partials in range order, read through the
// cluster's distributed shared memory: no partial leaves the SMs, no
// counter, no atomic. What M chooses is only how many 64-row tiles a block
// carries, its ring's depth and how many blocks run (the form, chosen by
// the wrapper):
//   decode  (form 0, M <= 64): one consumer warpgroup, one 64-row tile of
//           which only the M live rows are loaded (the rest of the tile is
//           never stored);
//   prefill (M > 64): two consumer warpgroups, each carrying 1 (form 1,
//           128 rows a block) or 2 (form 2, 256 rows) 64-row tiles.
// The ring fills the shared memory: forms 0 and 1 run one block an SM
// with 8 or 6 stages where every cluster of the launch fits the card at
// once (cudaOccupancyMaxActiveClusters), else two an SM with 4 or 3;
// form 2 one block an SM with 4.
// Every form: one producer warp whose one thread issues TMA loads of the x
// tiles and the w tile of each k step into the ring (mbarriers: `full`
// completes on the bytes, `empty` on one arrival per consumer warpgroup);
// the consumers keep one step's products in flight while they issue the
// next and hand a stage back when its products are done.
//
// Bounds (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16) and what the design
// does about each.
//  * Decode (M 4) is bytes: the weights once (w_out, 128 MB: 0.040 ms).
//    A block streams its range of one n128 column tile, only the live
//    rows of x beside it; split_k gives 64 blocks a projection (S 2 for
//    wq, wo, w_out; 8 for wk, wv), each on its own SM with 8 stages of
//    16 KB of w, 128 KB in flight; a group puts wq, wk and wv (192 blocks)
//    in one launch, two blocks an SM.
//  * Prefill (M 256) is bytes and flops near the ridge: w_in is 34.4
//    GFLOP (0.035 ms) against 145 MB (0.043 ms). Each n tile re-reads x
//    and each m tile w from L2: 64 x 64 tiles move 1,024 blocks x (512 KB
//    of x + 512 KB of w) = 1.07 GB at w_in (~0.16 ms at L2's rate); form
//    2's 256 x 128 tiles move 128 x 2 MB of x + 134 MB of w = 0.40 GB,
//    and a TMA issues each step's 48 KB without the consumers' threads.
//    What then holds the main loop is the weights' stream from device
//    memory: a block of form 2 has 64 KB of w in flight (x fills the rest
//    of its ring), and w_in reads its weights at 65-68% of HBM peak
//    whether the products run or not (scripts/invariant_dense_breakdown.py
//    cuts them out); a cluster that multicast x to neighbouring n tiles,
//    half the traffic from L2, was no faster.
//  * A split K costs a fold: the S - 1 partials of a tile cross between
//    SMs through distributed shared memory, and the clusters must fit the
//    card at once. So split_k stops at 64 blocks, a split
//    problem takes 128-row blocks at M 256 (form 1: 128 blocks, one an SM
//    with a 6-stage ring), and a launch whose clusters do not fit in one
//    wave takes the two-an-SM rings instead.
//
// f32, on the CUDA cores (the MoE routers, N 16 or 8, and the reduced f32
// checks): a warp owns a column and 8 rows; lane l sums k = l, l + 32, ...
// in K order, one fmaf a k, then the lanes' sums fold in a fixed butterfly
// and lane 0 writes: an order fixed by K alone. A group is one launch over
// its problems' column blocks. At N 16 one thread a column would leave
// the card one block and a serial chain of K dependent loads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

using namespace repro_torch::sm90;
using bf16 = __nv_bfloat16;

constexpr int kMaxProblems = 4;  // kernels/invariant_dense.py: MAX_GROUP
constexpr int BK = 64;           // k step
constexpr int WN = 128;          // the wgmma n width and a block's n tile
constexpr int kRow = 128;        // bytes of a tile row (64 bf16)
constexpr int kXTile = 64 * kRow;             // x: 64 rows of BK
constexpr int kWTile = BK * kRow * (WN / 64);  // w: 2 column blocks of BK

struct Problem {
  CUtensorMap w;        // (K, N) bf16 in boxes of 64 n x 64 k
  const bf16* b;        // or null
  bf16* y;
  int N, S, n_tiles;
  int first;            // its first block in the grid (a multiple of C)
};

struct Args {
  CUtensorMap x;        // (M, K) bf16 in boxes of 64 k x xrows rows
  Problem p[kMaxProblems];
  int P, M, K, xrows;
  int C;                // blocks a cluster: the largest S of the launch
};

// a tile's partial in shared memory (f32): rows of WN + 8 floats, so the
// accumulator's float2 writes (4 rows a half-warp) fall in distinct banks
constexpr int kPartRow = WN + 8;

// the address of `local` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(local)), "r"(rank));
  return a;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// CONS consumer warpgroups, each carrying MT 64-row tiles, a ring of
// STAGES and BPS blocks an SM; the block owns (64 CONS MT) x WN of y
template <int CONS, int MT, int STAGES, int BPS>
struct Form {
  static constexpr int kBM = 64 * CONS * MT;
  static constexpr int kXBytes = CONS * MT * kXTile;
  static constexpr int kStage = kXBytes + kWTile;
  static constexpr int kThreads = 128 * CONS + 32;   // + the producer warp
  static constexpr int kSmem = STAGES * kStage + 1024 + 2 * STAGES * 8;
  static_assert(kSmem * BPS <= 227 * 1024, "shared memory");
  static_assert(kBM * kPartRow * 4 <= STAGES * kStage, "partial tile");
};

__device__ __forceinline__ float bias_add(float v, const bf16* b, int n) {
  // (x @ w) in the model dtype, then + b (layers.dense)
  return __bfloat162float(__float2bfloat16_rn(v)) + __bfloat162float(b[n]);
}

__device__ __forceinline__ void store2(const Problem& p, int m, int n,
                                       float v0, float v1) {
  if (p.b) {
    v0 = bias_add(v0, p.b, n);
    v1 = bias_add(v1, p.b, n + 1);
  }
  *reinterpret_cast<__nv_bfloat162*>(p.y + static_cast<size_t>(m) * p.N +
                                     n) = __floats2bfloat162_rn(v0, v1);
}

// rows [r0, r1) of a tile summed over its S ranges' partials, which lie
// in the shared memory of the cluster's blocks base .. base + S - 1, in
// range order, into y (+ b). 4 columns an element (N % 8 == 0: a group of
// 4 is all in or all out); a thread keeps 16 partials' loads in flight.
template <int S, int THREADS>
__device__ __forceinline__ void fold_rows(const Problem& pr, const float* tile,
                                          int base, int m0, int n0, int r0,
                                          int r1, int tid) {
  constexpr int U = 16 / S;
  uint32_t src[S];
#pragma unroll
  for (int s = 0; s < S; ++s) src[s] = cluster_addr(tile, base + s);
  const int quads = min(WN, pr.N - n0) / 4;
  const int total = (r1 - r0) * quads;
  for (int e0 = tid; e0 < total; e0 += U * THREADS) {
    float4 p[U][S];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < total) {
        const uint32_t off =
            4 * ((r0 + e / quads) * kPartRow + 4 * (e % quads));
#pragma unroll
        for (int s = 0; s < S; ++s) p[u][s] = ld_cluster(src[s] + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e >= total) break;
      float4 v = p[u][0];
#pragma unroll
      for (int s = 1; s < S; ++s) {     // the ranges in K order
        v.x += p[u][s].x;
        v.y += p[u][s].y;
        v.z += p[u][s].z;
        v.w += p[u][s].w;
      }
      const int m = m0 + r0 + e / quads, n = n0 + 4 * (e % quads);
      store2(pr, m, n, v.x, v.y);
      store2(pr, m, n + 2, v.z, v.w);
    }
  }
}

template <int CONS, int MT, int STAGES, int BPS>
__global__ void __launch_bounds__(Form<CONS, MT, STAGES, BPS>::kThreads, BPS)
    invariant_dense_tc(const __grid_constant__ Args a) {
  using F = Form<CONS, MT, STAGES, BPS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * F::kStage);
  uint64_t* empty = full + STAGES;

  // this block's problem, tile and K range (split fastest, then the m
  // block, then the n tile: a tile's ranges and the m blocks that share a
  // w tile run side by side)
  int pi = 0;
#pragma unroll
  for (int q = 1; q < kMaxProblems; ++q)
    if (q < a.P && static_cast<int>(blockIdx.x) >= a.p[q].first) pi = q;
  const Problem& pr = a.p[pi];
  const int S = pr.S;
  const int i = blockIdx.x - pr.first;
  const int mb = (a.M + F::kBM - 1) / F::kBM;
  const int split = i % S, m_blk = (i / S) % mb, n_t = i / S / mb;
  const int m0 = m_blk * F::kBM, n0 = n_t * WN;
  const int range = a.K / S;          // a multiple of BK when S > 1
  const int kb = split * range;
  const int steps = (range + BK - 1) / BK;
  const int live = min(F::kBM, a.M - m0);    // rows of M in this tile
  const int tiles = (live + 63) / 64;        // 64-row tiles holding them
  // a block past the problem's tiles (its blocks padded to whole
  // clusters) only meets the cluster's barriers
  const bool work = i < mb * pr.n_tiles * S;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  float acc[MT][WN / 2];
  if (!work) {
  } else if (wg == CONS) {
    // the producer: one thread keeps the ring full
    if (tid == CONS * 128) {
      const CUtensorMap* wmap = &pr.w;
      const uint32_t bytes = tiles * a.xrows * kRow + kWTile;
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        uint8_t* st = sm + s * F::kStage;
        const int k = kb + it * BK;
        mbar_expect_tx(&full[s], bytes);
        for (int j = 0; j < tiles; ++j)
          tma_load_2d(st + j * kXTile, &a.x, &full[s], k, m0 + 64 * j);
#pragma unroll
        for (int c = 0; c < WN / 64; ++c)
          tma_load_2d(st + F::kXBytes + c * BK * kRow, wmap, &full[s],
                      n0 + 64 * c, k);
      }
    }
  } else {
    // a consumer: tiles t * CONS + wg of the block (both warpgroups busy
    // from M = 65 on). Every tile's products are issued, live or not (a
    // product under a branch would be serialised): a tile without rows of
    // M reads a stage's stale x and is never stored.
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[t][e] = 0.f;
    for (int it = 0; it < steps; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* st = sm + s * F::kStage;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)       // the k16 steps in order
#pragma unroll
        for (int t = 0; t < MT; ++t)
            wgmma_ss<WN, 1>(
                acc[t],
                desc(st + (t * CONS + wg) * kXTile + kc * 32, 16, 1024),
                desc(st + F::kXBytes + kc * 16 * kRow, BK * kRow, 1024), 1);
      wgmma_commit();
      // step it's products run on while step it - 1's are waited for;
      // then its stage goes back to the producer
      wgmma_wait<1>();
#pragma unroll
      for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
      if (it > 0 && tid % 128 == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MT; ++t) fence_regs(acc[t]);
  }

  // acc[t][4 c + {0, 1}]: row 16 warp + lane / 4 of tile t CONS + wg,
  // columns 8 c + 2 (lane % 4) + {0, 1}; acc[t][4 c + {2, 3}]: the same
  // columns 8 rows down
  const int warp = (tid % 128) / 32, lane = tid % 32;
  if (work && S == 1 && wg < CONS) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int r_lo = m0 + 64 * (t * CONS + wg) + 16 * warp + (lane >> 2);
#pragma unroll
      for (int c = 0; c < WN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_lo + 8 * h, n = n0 + 8 * c + 2 * (lane & 3);
          if (m < a.M && n < pr.N)
            store2(pr, m, n, acc[t][4 * c + 2 * h], acc[t][4 * c + 2 * h + 1]);
        }
    }
  }
  if (a.C == 1) return;
  // S > 1: the tile's S ranges are S neighbouring blocks of the cluster.
  // Each writes its partial into its own shared memory (the ring, now
  // idle); after the cluster's barrier each folds 1/S of the tile's rows,
  // reading the S partials in range order; a second barrier keeps every
  // block's shared memory alive until the others have read it.
  float* tile = reinterpret_cast<float*>(sm);
  const bool fold = work && S > 1;
  __syncthreads();                      // both consumers done with the ring
  if (fold && wg < CONS) {
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int r = 64 * (t * CONS + wg) + 16 * warp + (lane >> 2);
#pragma unroll
      for (int c = 0; c < WN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(tile + (r + 8 * h) * kPartRow + 8 * c +
                                     2 * (lane & 3)) =
              make_float2(acc[t][4 * c + 2 * h], acc[t][4 * c + 2 * h + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (fold) {
    const int base = static_cast<int>(cluster.block_rank()) - split;
    const int r0 = live * split / S, r1 = live * (split + 1) / S;
    if (S == 2)
      fold_rows<2, F::kThreads>(pr, tile, base, m0, n0, r0, r1, tid);
    else if (S == 4)
      fold_rows<4, F::kThreads>(pr, tile, base, m0, n0, r0, r1, tid);
    else
      fold_rows<8, F::kThreads>(pr, tile, base, m0, n0, r0, r1, tid);
  }
  cluster.sync();
}

constexpr int kRowsF32 = 8;
constexpr int kWarpsF32 = 4;   // columns a block

struct F32Problem {
  const float* w;
  const float* b;       // or null
  float* y;
  int N, first;         // first: its first column block in the grid
};

struct F32Args {
  const float* x;
  F32Problem p[kMaxProblems];
  int P, M, K;
};

__global__ void __launch_bounds__(32 * kWarpsF32)
    invariant_dense_f32_kernel(const __grid_constant__ F32Args a) {
  int pi = 0;
#pragma unroll
  for (int q = 1; q < kMaxProblems; ++q)
    if (q < a.P && static_cast<int>(blockIdx.x) >= a.p[q].first) pi = q;
  const F32Problem& p = a.p[pi];
  const int lane = threadIdx.x & 31;
  const int n = (blockIdx.x - p.first) * kWarpsF32 + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kRowsF32;
  if (n >= p.N) return;                 // a whole warp: n is the warp's
  const int rows = min(kRowsF32, a.M - m0);
  float acc[kRowsF32];
#pragma unroll
  for (int r = 0; r < kRowsF32; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k = lane; k < a.K; k += 32) {   // the lane's k in K order
    const float wk = __ldg(p.w + static_cast<size_t>(k) * p.N + n);
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r)
      if (r < rows)
        acc[r] = fmaf(__ldg(a.x + static_cast<size_t>(m0 + r) * a.K + k), wk,
                      acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRowsF32; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0)
    for (int r = 0; r < rows; ++r)
      p.y[static_cast<size_t>(m0 + r) * p.N + n] =
          p.b ? acc[r] + p.b[n] : acc[r];
}

// TMA map of a row-major (rows, cols) bf16 matrix read in boxes of 64
// columns x box_rows rows, 128-byte swizzle; reads past the edges are zeros
bool matrix_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the weights' maps, by (pointer, K, N): everything a map depends on
struct WKey {
  const void* ptr;
  int K, N;
  bool operator==(const WKey& o) const {
    return ptr == o.ptr && K == o.K && N == o.N;
  }
};
struct WKeyHash {
  size_t operator()(const WKey& k) const {
    return std::hash<const void*>()(k.ptr) ^
           (static_cast<size_t>(k.K) << 32 | static_cast<size_t>(k.N));
  }
};

bool weight_map(CUtensorMap* map, const void* w, int K, int N) {
  static std::mutex mu;
  static std::unordered_map<WKey, CUtensorMap, WKeyHash> cache;
  const WKey key{w, K, N};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!matrix_map(map, w, K, N, BK)) return false;
  cache.emplace(key, *map);
  return true;
}

// the launch of a form over `blocks` blocks in clusters of C
template <int CONS, int MT, int STAGES, int BPS>
struct Launch {
  using F = Form<CONS, MT, STAGES, BPS>;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg{};
  cudaError_t ready;

  Launch(int blocks, int C, cudaStream_t st) {
    static const cudaError_t set = cudaFuncSetAttribute(
        invariant_dense_tc<CONS, MT, STAGES, BPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    ready = set;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(F::kThreads);
    cfg.dynamicSmemBytes = F::kSmem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }

  // clusters of C the card holds at once (cached per C)
  int capacity(int C) {
    static int cap[9] = {};
    if (cap[C] == 0 && ready == cudaSuccess &&
        cudaOccupancyMaxActiveClusters(
            &cap[C], invariant_dense_tc<CONS, MT, STAGES, BPS>, &cfg) !=
            cudaSuccess)
      cap[C] = -1;
    return cap[C];
  }

  cudaError_t run(const Args& a) {
    if (ready != cudaSuccess) return ready;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, invariant_dense_tc<CONS, MT, STAGES, BPS>,
                           a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

}  // namespace

// dtype 0 f32, 1 bf16; x (M, K) contiguous and 16-byte aligned; P problems
// (1 <= P <= 4), each five int64 in `table`: w (K, N), b (N) or 0, y (M,
// N), N and S (the split of K: kernels/invariant_dense.py split_k, a power
// of two <= 8; 1 for f32; K % (S * 64) == 0 when S > 1). form (bf16): 0
// decode (one 64-row tile a block, M <= 64), 1 prefill (128 rows a block),
// 2 prefill (256 rows). The wrapper checks shapes, dtypes, contiguity,
// 16-byte alignment, K % 8 == 0 and, in bf16, N % 8 == 0.
extern "C" int invariant_dense(int dtype, const void* x, int M, int K, int P,
                               const long long* table, int form,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || K % 8 || P < 1 || P > kMaxProblems)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    F32Args a{};
    a.x = static_cast<const float*>(x);
    a.P = P, a.M = M, a.K = K;
    int blocks = 0;
    for (int q = 0; q < P; ++q) {
      const long long* row = table + 5 * q;
      const int N = static_cast<int>(row[3]);   // any N: one column a thread
      if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
      a.p[q] = F32Problem{reinterpret_cast<const float*>(row[0]),
                          reinterpret_cast<const float*>(row[1]),
                          reinterpret_cast<float*>(row[2]), N, blocks};
      blocks += (N + kWarpsF32 - 1) / kWarpsF32;
    }
    const dim3 grid(blocks, (M + kRowsF32 - 1) / kRowsF32);
    invariant_dense_f32_kernel<<<grid, 32 * kWarpsF32, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || form < 0 || form > 2 || (form == 0) != (M <= 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bm = form == 0 ? 64 : form == 1 ? 128 : 256;
  const int mb = (M + bm - 1) / bm;
  Args a{};
  a.P = P, a.M = M, a.K = K;
  a.xrows = M < 64 ? M : 64;
  a.C = 1;
  for (int q = 0; q < P; ++q) {
    const int S = static_cast<int>(table[5 * q + 4]);
    if (S < 1 || S > 8 || (S & (S - 1)) || (S > 1 && K % (S * BK)))
      return static_cast<int>(cudaErrorInvalidValue);
    a.C = S > a.C ? S : a.C;
  }
  if (!matrix_map(&a.x, x, M, K, a.xrows))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  for (int q = 0; q < P; ++q) {
    const long long* row = table + 5 * q;
    const int N = static_cast<int>(row[3]), S = static_cast<int>(row[4]);
    if (N < 1 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
    Problem& p = a.p[q];
    if (!weight_map(&p.w, reinterpret_cast<const void*>(row[0]), K, N))
      return static_cast<int>(cudaErrorInvalidValue);
    p.b = reinterpret_cast<const bf16*>(row[1]);
    p.y = reinterpret_cast<bf16*>(row[2]);
    p.N = N, p.S = S, p.n_tiles = (N + WN - 1) / WN, p.first = blocks;
    blocks += (mb * p.n_tiles * S + a.C - 1) / a.C * a.C;
  }
  // forms 0 and 1: one block an SM with a ring twice as deep where every
  // cluster of the launch fits the card at once, else two an SM
  cudaError_t e;
  if (form == 0) {
    Launch<1, 1, 8, 1> deep(blocks, a.C, st);
    e = blocks / a.C <= deep.capacity(a.C)
            ? deep.run(a)
            : Launch<1, 1, 4, 2>(blocks, a.C, st).run(a);
  } else if (form == 1) {
    Launch<2, 1, 6, 1> deep(blocks, a.C, st);
    e = blocks / a.C <= deep.capacity(a.C)
            ? deep.run(a)
            : Launch<2, 1, 3, 2>(blocks, a.C, st).run(a);
  } else {
    e = Launch<2, 2, 4, 1>(blocks, a.C, st).run(a);
  }
  return static_cast<int>(e);
}
