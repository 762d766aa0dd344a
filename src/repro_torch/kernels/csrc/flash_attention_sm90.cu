// Flash attention on Hopper's tensor cores (sm_90a), bf16, forward and
// backward: the kernels that flash_attention.cu's C entries launch for
// bf16 inputs (f32 inputs keep that file's CUDA-core kernels).
//
// flash_fwd_sm90 replaces the JAX package's kernels/flash_attention.py:
// flash_attention (Pallas, src/repro/kernels/flash_attention.py:76, its
// pallas_call at :93); flash_bwd_dq_sm90 and flash_bwd_dkdv_sm90 replace
// what the TPU path has no kernel for, the XLA autodiff of
// models/attention.py: chunked_attention (src/repro/models/attention.py:44).
// Semantics are flash_attention.cu's (kernels/ref.py: flash_attention_ref,
// flash_bwd_dq_ref, flash_bwd_dkdv_ref): causal, sliding-window or
// non-causal online-softmax attention over q (B, Sq, H, hd) and k, v
// (B, Skv, Hkv, hd), H % Hkv == 0, query head h reading kv head
// h / (H / Hkv) (GQA without repeating kv), Sq != Skv (cross-attention)
// only without causal mask or window; the forward writes out and lse =
// m + log(l) (f32, (B, H, Sq)); flash_bwd_dq writes D = rowsum(dO * O)
// and dQ, flash_bwd_dkdv reads D and writes dK and dV at Hkv heads. Any
// length: the TMA fills rows past Sq or Skv with zeros, the tiles that
// reach past them take the masked path (edge), and every store of out,
// lse, D, dq, dk and dv is predicated on its row.
// Every output element is written by one block and summed in a fixed
// order, so each launch is deterministic. The one atomic is a shared-
// memory counter that picks which warpgroup refills a freed stage; no
// result depends on its order.
//
// Numerics (FlashAttention's): the products take the bf16 operands as
// they are and accumulate in f32 (wgmma ...f32.bf16.bf16); a product of
// two bf16 is exact in f32, so only the order of the sums differs from
// the plain version. The scale multiplies the f32 scores after Q K^T.
// The online softmax (m, l, the correction) runs in f32 registers, in
// base 2 (exp2 of s * scale * log2 e). P is rounded to bf16 as the
// register A operand of the forward's P V, as FlashAttention rounds it.
// dV = P^T dO takes P as two bf16 parts, hi = bf16(P) and lo = bf16(P -
// hi): with P rounded once, dV broke chip_smoke.py's error rule (2x the
// plain version's own bf16 error) at B 1, S 200, 4 heads of 96 (2.19x).
// Nor is dS rounded once: dQ = dS K and dK = dS^T Q sum dS with
// cancellation (a row of dS sums to zero), and one bf16 rounding of dS,
// FlashAttention's, breaks the same rule in about 1 of 20 small draws
// (scripts/flash_ds_rounding.py). So dS goes in as two bf16 parts too,
// hi = bf16(dS) and lo = bf16(dS - hi), two products into the same
// accumulator (sm90.cuh: pack_a_split): about 16 significant bits, for
// one more product a step.
//
// Bound: operations. With n = B * H * (visible query-key pairs) * hd the
// forward needs 4n flops (Q K^T, P V), flash_bwd_dq 6n (s, dP, dQ) and
// flash_bwd_dkdv 8n (s, dP, dV, dK), at 989 TFLOP/s (bf16 tensor cores,
// dense); the bytes (q, out, dO, dq once at H heads, k, v, dk, dv at Hkv
// heads, lse and D) are two orders of magnitude below the card's ridge
// point (chip_smoke.py: time_flash counts both). So the design spends
// everything on keeping the tensor cores fed:
//   * every product is a warpgroup MMA (wgmma m64nNk16) reading its B
//     operand (and a shared-memory A) straight from the swizzled tiles the
//     TMA wrote, no copy through registers; the second product of each
//     step (P V, dS K, P^T dO, dS^T Q) takes its A operand from the
//     registers that hold the first product's accumulator (sm90.cuh);
//   * tiles arrive by TMA (one thread issues a whole tile) into a ring of
//     two stages, completing on mbarriers, so the next tiles load while
//     this one is multiplied; tiles are rows of 64 bf16 (128 bytes) with
//     the 128-byte swizzle, which wgmma reads without bank conflicts;
//   * two warpgroups a block (64 rows each) that never wait for each
//     other: the second one done with a stage issues its refill (the
//     forward keeps K and V in separate rings, so K runs two tiles ahead);
//   * the forward overlaps the softmax with the tensor cores twice over:
//     within a warpgroup, Q K^T of tile j and P V of tile j - 1 are issued
//     together and the softmax of tile j runs under P V (FlashAttention-3's
//     intra-warpgroup pipeline); across the two, they take turns at issuing
//     (named barriers), so one's products run under the other's softmax;
//   * causal blocks are launched longest first (the diagonal's far end),
//     so the short ones fill the tail of the grid.
// Tiles: forward 128 queries (2 x 64) x 128 keys, 2 products a step; dq
// 128 queries x 64 keys (dQ, S and dP in registers), 4 products a step
// (S, dP, dS hi K, dS lo K); dkdv 128 keys (2 x 64) x 64 queries, 6 a
// step (S^T, dP^T, P^T hi dO, P^T lo dO, dS^T hi Q, dS^T lo Q),
// looping over the H / Hkv query heads of its kv head and their q tiles,
// dK and dV accumulating in registers. hd in {64, 96, 128}; 96 is padded
// to two column blocks, whose upper half the TMA fills with zeros.
//
// The host side encodes the TMA descriptors per launch (sm90.cuh:
// encode_tiled); the entries return cudaGetLastError().

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace repro_torch {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreadsTC = 256;             // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;           // the JAX package's NEG_INF
constexpr uint32_t kRow = 128;              // bytes of a tile row (64 bf16)

template <int HD>
struct Head {
  static constexpr int kCB = HD > 64 ? 2 : 1;   // 64-wide column blocks
  static constexpr int kHDP = 64 * kCB;         // hd padded to them
  static constexpr int kSteps = HD / 16;        // k16 steps over hd
  // bytes of a tile of `rows` rows
  __host__ __device__ static constexpr uint32_t tile(int rows) {
    return kCB * rows * kRow;
  }
};

// query row qp may attend to key kp (rows past Sq are never stored)
__device__ __forceinline__ bool visible(int qp, int kp, int Skv, int causal,
                                        int window) {
  return kp < Skv && (!causal || kp <= qp) && (!window || kp > qp - window);
}

// some pair of the (q0 + [0, bm)) x (k0 + [0, bn)) block is masked
__device__ __forceinline__ bool edge(int q0, int bm, int k0, int bn, int Sq,
                                     int Skv, int causal, int window) {
  return k0 + bn > Skv || q0 + bm > Sq || (causal && k0 + bn - 1 > q0) ||
         (window && k0 <= q0 + bm - 1 - window);
}

// kv tiles of bn keys [lo, hi) seen by the queries q0 + [0, bm) (causal
// or a window only where Sq == Skv)
__device__ __forceinline__ void kv_tiles(int q0, int bm, int bn, int Skv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  const int key_hi = causal ? min(Skv, q0 + bm) : Skv;   // exclusive
  const int key_lo = window ? max(0, q0 - window + 1) : 0;
  *lo = key_lo / bn;
  *hi = (key_hi + bn - 1) / bn;
}

// q tiles of bm queries [lo, hi) that see the keys k0 + [0, bn)
__device__ __forceinline__ void q_tiles(int k0, int bn, int bm, int Sq,
                                        int causal, int window, int* lo,
                                        int* hi) {
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq, k0 + bn - 1 + window) : Sq;   // excl.
  *lo = q_lo / bm;
  *hi = (q_hi + bm - 1) / bm;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Loads the `rows` x hd tile at (row r0, head h, batch b) of a (B, S, Hx,
// hd) tensor, one TMA box per column block.
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int rows, int h,
                                          int r0, int b) {
#pragma unroll
  for (int c = 0; c < Head<HD>::kCB; ++c)
    tma_load_4d(dst + c * rows * kRow, m, bar, 64 * c, h, r0, b);
}

// Stores the f32 accumulator tile d (rows row0 + {0, 8} of this thread,
// hd columns) times mul[r] into a (B, S, Hx, hd) bf16 tensor.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, const float* d,
                                           int row0, int S, size_t base,
                                           size_t rs, const float (&mul)[2],
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* p = dst + base + static_cast<size_t>(row) * rs;
#pragma unroll
    for (int c = 0; c < Head<HD>::kHDP / 8; ++c) {
      const int col = 8 * c + 2 * (lane & 3);
      if (col < HD)
        *reinterpret_cast<uint32_t*>(p + col) =
            pack_bf16(d[4 * c + 2 * r] * mul[r], d[4 * c + 2 * r + 1] * mul[r]);
    }
  }
}

// ---------------------------------------------------------------- forward

constexpr int kFwdM = 128;   // queries a block
constexpr int kFwdN = 128;   // keys a tile

template <int HD>
struct FwdSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kKV = Head<HD>::tile(kFwdN);
  static constexpr uint32_t kK = kQ + Head<HD>::tile(kFwdM);
  static constexpr uint32_t kV = kK + 2 * kKV;
  static constexpr uint32_t kBar = kV + 2 * kKV;   // q, k[2], v[2]
  static constexpr uint32_t kRel = kBar + 5 * 8;   // k[2], v[2]
  static constexpr size_t kBytes = kRel + 4 * 4 + 1024;
};

// The online softmax of one tile of scores s (f32, this thread's two rows
// row0 and row0 + 8, keys k0 + [0, kFwdN)), in place: s becomes P (f32),
// the running max m and sum l are updated (l per thread; the quad's
// partial sums are added at the end), corr is the old accumulator's
// correction.
__device__ __forceinline__ void softmax_tile(
    float (&s)[kFwdN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    int row0, int k0, int q0, int Sq, int Skv, int causal, int window,
    float sl2, int lane) {
  const bool masked = edge(q0, kFwdM, k0, kFwdN, Sq, Skv, causal, window);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kFwdN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * sl2;
    if (masked &&
        !visible(row0 + 8 * r, k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1),
                 Skv, causal, window))
      x = -INFINITY;
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    corr[r] = exp2_approx(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < kFwdN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(s[i] - m[r]);
    ls[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int Sq, int Skv, int H, int n_rep, int causal,
                      int window, float scale) {
  using L = FwdSmem<HD>;
  using Hd = Head<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sQ = sm + L::kQ;
  uint8_t* sK = sm + L::kK;
  uint8_t* sV = sm + L::kV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint32_t* rel = reinterpret_cast<uint32_t*>(sm + L::kRel);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdM;   // longest first
  int lo, hi;
  kv_tiles(q0, kFwdM, kFwdN, Skv, causal, window, &lo, &hi);
  const int n = hi - lo;

  const CUtensorMap *mk = &tk, *mv = &tv;
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    for (int i = 0; i < 4; ++i) rel[i] = 0;
    fence_mbar_init();
  }
  __syncthreads();
  auto issue_k = [&](int i) {   // kv tile lo + i's K into stage i % 2
    const int st = i & 1;
    mbar_expect_tx(&bars[1 + st], L::kKV);
    load_tile<HD>(sK + st * L::kKV, mk, &bars[1 + st], kFwdN, hk,
                  (lo + i) * kFwdN, b);
  };
  auto issue_v = [&](int i) {
    const int st = i & 1;
    mbar_expect_tx(&bars[3 + st], L::kKV);
    load_tile<HD>(sV + st * L::kKV, mv, &bars[3 + st], kFwdN, hk,
                  (lo + i) * kFwdN, b);
  };
  // This warpgroup is done with stage i % 2 of K (or V); the second of the
  // two warpgroups to be done refills it with tile i + 2, so neither waits
  // for the other.
  auto release = [&](int i, bool is_k) {
    wg_sync(wg);
    if (tid % 128 == 0 && (atomicAdd(&rel[2 * !is_k + (i & 1)], 1u) & 1) &&
        i + 2 < n) {
      if (is_k)
        issue_k(i + 2);
      else
        issue_v(i + 2);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], Hd::tile(kFwdM));
    load_tile<HD>(sQ, &tq, &bars[0], kFwdM, h, q0, b);
    for (int i = 0; i < 2 && i < n; ++i) {
      issue_k(i);
      issue_v(i);
    }
  }

  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // and row0 + 8
  const float sl2 = scale * kLog2e;
  float o[Hd::kHDP / 2], s[kFwdN / 2];
  uint32_t p[kFwdN / 16][4];
  zero(o);
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
  auto scores = [&](int it) {   // S = Q K^T of tile it, committed
#pragma unroll
    for (int kk = 0; kk < Hd::kSteps; ++kk) {
      const int c = kk / 4, kc = kk % 4;
      wgmma_ss<kFwdN, 0>(
          s, desc(sQ + c * kFwdM * kRow + wg * 64 * kRow + kc * 32, 16, 1024),
          desc(sK + (it & 1) * L::kKV + c * kFwdN * kRow + kc * 32, 16, 1024),
          1);
    }
    wgmma_commit();
  };
  auto pv = [&](int it) {       // O += P V of tile it, committed
#pragma unroll
    for (int t = 0; t < kFwdN / 16; ++t)
      wgmma_rs<Hd::kHDP, 1>(
          o, p[t],
          desc(sV + (it & 1) * L::kKV + t * 16 * kRow, kFwdN * kRow, 1024),
          1);
    wgmma_commit();
  };
  auto wait_k = [&](int it) { mbar_wait(&bars[1 + (it & 1)], (it >> 1) & 1); };
  auto wait_v = [&](int it) { mbar_wait(&bars[3 + (it & 1)], (it >> 1) & 1); };

  // Intra-warpgroup pipeline: the scores of tile it are multiplied while
  // P V of tile it - 1 runs, and its softmax overlaps that product. Both
  // are issued after one fence; P of tile it is packed into the A
  // operands only once P V of tile it - 1 is done, so no register of a
  // product in flight is written (else ptxas serializes the products).
  mbar_wait(&bars[0], 0);
  zero(s);
  wait_k(0);
  fence_regs(s);
  if (wg == 1) turn_pass(wg);   // warpgroup 0 issues first
  turn_wait(wg);
  wgmma_fence();
  scores(0);
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  release(0, true);
  softmax_tile(s, m, l, corr, row0, lo * kFwdN, q0, Sq, Skv, causal, window,
               sl2, lane);
#pragma unroll
  for (int t = 0; t < kFwdN / 16; ++t) pack_a(p[t], s, t);
  for (int it = 1; it < n; ++it) {
    zero(s);
    wait_k(it);
    wait_v(it - 1);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    turn_wait(wg);
    wgmma_fence();
    scores(it);
    pv(it - 1);
    turn_pass(wg);
    wgmma_wait<1>();            // the scores are in; P V may still run
    fence_regs(s);
    release(it, true);
    softmax_tile(s, m, l, corr, row0, (lo + it) * kFwdN, q0, Sq, Skv,
                 causal, window, sl2, lane);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release(it - 1, false);
#pragma unroll
    for (int i = 0; i < Hd::kHDP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int t = 0; t < kFwdN / 16; ++t) pack_a(p[t], s, t);
  }
  wait_v(n - 1);
  fence_regs(o);
  fence_regs(p);
  turn_wait(wg);
  wgmma_fence();
  pv(n - 1);
  if (wg == 0) turn_pass(wg);   // the last turn is warpgroup 1's
  wgmma_wait<0>();
  fence_regs(o);

  float one[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    one[r] = 1.f;
    const int row = row0 + 8 * r;
    if (row < Sq && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * Sq + row] = m[r] * kLn2 + logf(l[r]);
  }
  // out = acc / max(l, 1e-30), divided, not multiplied by a reciprocal
#pragma unroll
  for (int i = 0; i < Hd::kHDP / 2; ++i)
    o[i] = __fdiv_rn(o[i], fmaxf(l[(i >> 1) & 1], 1e-30f));
  store_rows<HD>(out, o, row0, Sq,
                 (static_cast<size_t>(b) * Sq * H + h) * HD,
                 static_cast<size_t>(H) * HD, one, lane);
}

// ----------------------------------------------------------- backward, dQ

constexpr int kDqM = 128;    // queries a block
constexpr int kDqN = 64;     // keys a tile

template <int HD>
struct DqSmem {
  static constexpr uint32_t kQT = Head<HD>::tile(kDqM);
  static constexpr uint32_t kKV = Head<HD>::tile(kDqN);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = kQ + kQT;
  static constexpr uint32_t kK = kDO + kQT;
  static constexpr uint32_t kV = kK + 2 * kKV;
  static constexpr uint32_t kLD = kV + 2 * kKV;        // lse, D: 2 x kDqM
  static constexpr uint32_t kBar = kLD + 2 * kDqM * 4; // q+dO, k[2], v[2]
  static constexpr uint32_t kRel = kBar + 5 * 8;        // stage[2]
  static constexpr size_t kBytes = kRel + 2 * 4 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const bf16* __restrict__ dout,
                         const bf16* __restrict__ out,
                         const float* __restrict__ lse, bf16* __restrict__ dq,
                         float* __restrict__ delta, int Sq, int Skv, int H,
                         int n_rep, int causal, int window, float scale) {
  using L = DqSmem<HD>;
  using Hd = Head<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sQ = sm + L::kQ;
  uint8_t* sDO = sm + L::kDO;
  uint8_t* sK = sm + L::kK;
  uint8_t* sV = sm + L::kV;
  float* sL = reinterpret_cast<float*>(sm + L::kLD);
  float* sD = sL + kDqM;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint32_t* rel = reinterpret_cast<uint32_t*>(sm + L::kRel);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqM;    // longest first
  int lo, hi;
  kv_tiles(q0, kDqM, kDqN, Skv, causal, window, &lo, &hi);
  const int n = hi - lo;
  const size_t qbase = (static_cast<size_t>(b) * Sq * H + h) * HD;
  const size_t qrs = static_cast<size_t>(H) * HD;

  const CUtensorMap *mk = &tk, *mv = &tv;
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    rel[0] = rel[1] = 0;
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int i) {   // kv tile lo + i into stage i % 2
    const int st = i & 1, k0 = (lo + i) * kDqN;
    mbar_expect_tx(&bars[1 + st], L::kKV);
    load_tile<HD>(sK + st * L::kKV, mk, &bars[1 + st], kDqN, hk, k0, b);
    mbar_expect_tx(&bars[3 + st], L::kKV);
    load_tile<HD>(sV + st * L::kKV, mv, &bars[3 + st], kDqN, hk, k0, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * L::kQT);
    load_tile<HD>(sQ, &tq, &bars[0], kDqM, h, q0, b);
    load_tile<HD>(sDO, &tdo, &bars[0], kDqM, h, q0, b);
    for (int i = 0; i < 2 && i < n; ++i) issue(i);
  }

  // prologue, under the loads: D = rowsum(dO * O) of the block's rows, two
  // threads a row, 16-byte loads; D and lse (in base 2) into shared memory
  {
    const int r = tid / 2, half = tid & 1, row = q0 + r;
    float part = 0.f;
    if (row < Sq) {
      const size_t e = qbase + static_cast<size_t>(row) * qrs + half * (HD / 2);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + e);
      const uint4* po = reinterpret_cast<const uint4*>(out + e);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        const uint4 x = pd[j], y = po[j];
        const bf16* xa = reinterpret_cast<const bf16*>(&x);
        const bf16* ya = reinterpret_cast<const bf16*>(&y);
#pragma unroll
        for (int e2 = 0; e2 < 8; ++e2)
          part = fmaf(__bfloat162float(xa[e2]), __bfloat162float(ya[e2]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const size_t e = static_cast<size_t>(bh) * Sq + row;
      sD[r] = part;
      sL[r] = row < Sq ? lse[e] * kLog2e : 0.f;
      if (row < Sq) delta[e] = part;
    }
  }
  __syncthreads();

  const int lrow = wg * 64 + warp * 16 + lane / 4;   // and lrow + 8
  const int row0 = q0 + lrow;
  const float sl2 = scale * kLog2e;
  const float Lr[2] = {sL[lrow], sL[lrow + 8]};
  const float Dr[2] = {sD[lrow], sD[lrow + 8]};
  float acc[Hd::kHDP / 2];
  zero(acc);
  mbar_wait(&bars[0], 0);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    const uint32_t ph = (it >> 1) & 1;
    const int k0 = (lo + it) * kDqN;
    float s[kDqN / 2], dp[kDqN / 2];
    zero(s);
    zero(dp);
    mbar_wait(&bars[1 + st], ph);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Hd::kSteps; ++kk) {
      const int c = kk / 4, kc = kk % 4;
      wgmma_ss<kDqN, 0>(
          s, desc(sQ + c * kDqM * kRow + wg * 64 * kRow + kc * 32, 16, 1024),
          desc(sK + st * L::kKV + c * kDqN * kRow + kc * 32, 16, 1024), 1);
    }
    wgmma_commit();
    mbar_wait(&bars[3 + st], ph);
#pragma unroll
    for (int kk = 0; kk < Hd::kSteps; ++kk) {
      const int c = kk / 4, kc = kk % 4;
      wgmma_ss<kDqN, 0>(
          dp, desc(sDO + c * kDqM * kRow + wg * 64 * kRow + kc * 32, 16, 1024),
          desc(sV + st * L::kKV + c * kDqN * kRow + kc * 32, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(s - lse), dS = P (dP - D), into s
    const bool masked = edge(q0, kDqM, k0, kDqN, Sq, Skv, causal, window);
#pragma unroll
    for (int i = 0; i < kDqN / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(s[i] * sl2 - Lr[r]);
      if (masked &&
          !visible(row0 + 8 * r, k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1),
                   Skv, causal, window))
        p = 0.f;
      s[i] = p * (dp[i] - Dr[r]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kDqN / 16; ++t) {
      uint32_t hi[4], lo[4];
      pack_a_split(hi, lo, s, t);
      const uint64_t db =
          desc(sK + st * L::kKV + t * 16 * kRow, kDqN * kRow, 1024);
      wgmma_rs<Hd::kHDP, 1>(acc, hi, db, 1);
      wgmma_rs<Hd::kHDP, 1>(acc, lo, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // the second warpgroup to be done with stage st refills it
    wg_sync(wg);
    if (tid % 128 == 0 && (atomicAdd(&rel[st], 1u) & 1) && it + 2 < n)
      issue(it + 2);
  }
  const float mul[2] = {scale, scale};
  store_rows<HD>(dq, acc, row0, Sq, qbase, qrs, mul, lane);
}

// --------------------------------------------------------- backward, dK dV

constexpr int kKvN = 128;    // keys a block
constexpr int kKvM = 64;     // queries a tile

template <int HD>
struct DkdvSmem {
  static constexpr uint32_t kKT = Head<HD>::tile(kKvN);
  static constexpr uint32_t kQT = Head<HD>::tile(kKvM);
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKT;
  static constexpr uint32_t kQ = kV + kKT;             // 2 stages
  static constexpr uint32_t kDO = kQ + 2 * kQT;        // 2 stages
  // lse and D of a step's queries, [warpgroup][2 stages][lse, D][64]
  static constexpr uint32_t kLD = kDO + 2 * kQT;
  static constexpr uint32_t kBar = kLD + 2 * 2 * 2 * kKvM * 4;   // kv, q[2]
  static constexpr uint32_t kRel = kBar + 3 * 8;                 // stage[2]
  static constexpr size_t kBytes = kRel + 2 * 4 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Sq, int Skv, int Hkv, int n_rep, int causal,
                           int window, float scale) {
  using L = DkdvSmem<HD>;
  using Hd = Head<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* sK = sm + L::kK;
  uint8_t* sV = sm + L::kV;
  uint8_t* sQ = sm + L::kQ;
  uint8_t* sDO = sm + L::kDO;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint32_t* rel = reinterpret_cast<uint32_t*>(sm + L::kRel);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int warp = (tid % 128) / 32, wtid = tid % 128;
  float* sLD = reinterpret_cast<float*>(sm + L::kLD) + wg * 2 * 2 * kKvM;
  const int H = Hkv * n_rep;
  const int bk = blockIdx.x, b = bk / Hkv, hk = bk % Hkv;
  const int k0 = blockIdx.y * kKvN;              // the long ones first
  int lo, hi;
  q_tiles(k0, kKvN, kKvM, Sq, causal, window, &lo, &hi);
  const int nq = hi - lo, n = n_rep * nq;       // (head, q tile) steps

  // lse (base 2) and D of step i's query rows into this warpgroup's stage
  // i % 2: thread wtid loads lse (wtid < 64) or D of row wtid % 64
  auto load_ld = [&](int i) {
    const int h = hk * n_rep + i / nq;
    const int row = (lo + i % nq) * kKvM + wtid % kKvM;
    const size_t e = (static_cast<size_t>(b) * H + h) * Sq + row;
    sLD[(i & 1) * 2 * kKvM + wtid] =
        row >= Sq ? 0.f : wtid < kKvM ? lse[e] * kLog2e : delta[e];
  };
  if (n > 0) load_ld(0);
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    rel[0] = rel[1] = 0;
    fence_mbar_init();
  }
  __syncthreads();
  const CUtensorMap *mq = &tq, *mdo = &tdo;
  auto issue = [&](int i) {   // step i's q and dO tiles into stage i % 2
    const int st = i & 1, h = hk * n_rep + i / nq;
    const int q0 = (lo + i % nq) * kKvM;
    mbar_expect_tx(&bars[1 + st], 2 * L::kQT);
    load_tile<HD>(sQ + st * L::kQT, mq, &bars[1 + st], kKvM, h, q0, b);
    load_tile<HD>(sDO + st * L::kQT, mdo, &bars[1 + st], kKvM, h, q0, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * L::kKT);
    load_tile<HD>(sK, &tk, &bars[0], kKvN, hk, k0, b);
    load_tile<HD>(sV, &tv, &bars[0], kKvN, hk, k0, b);
    for (int i = 0; i < 2 && i < n; ++i) issue(i);
  }

  const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;   // and key0 + 8
  const float sl2 = scale * kLog2e;
  float adk[Hd::kHDP / 2], adv[Hd::kHDP / 2];
  zero(adk);
  zero(adv);
  mbar_wait(&bars[0], 0);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    const uint32_t ph = (it >> 1) & 1;
    const int q0 = (lo + it % nq) * kKvM;
    float s[kKvM / 2], dp[kKvM / 2];   // S^T and dP^T: rows keys, cols queries
    zero(s);
    zero(dp);
    mbar_wait(&bars[1 + st], ph);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Hd::kSteps; ++kk) {
      const int c = kk / 4, kc = kk % 4;
      const uint32_t a_off = c * kKvN * kRow + wg * 64 * kRow + kc * 32;
      const uint32_t b_off = st * L::kQT + c * kKvM * kRow + kc * 32;
      wgmma_ss<kKvM, 0>(s, desc(sK + a_off, 16, 1024),
                        desc(sQ + b_off, 16, 1024), 1);
      wgmma_ss<kKvM, 0>(dp, desc(sV + a_off, 16, 1024),
                        desc(sDO + b_off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(s - lse) into s, dS^T = P^T (dP^T - D) into dp
    const float* Ls = sLD + st * 2 * kKvM;
    const float* Ds = Ls + kKvM;
    const bool masked = edge(q0, kKvM, k0, kKvN, Sq, Skv, causal, window);
#pragma unroll
    for (int i = 0; i < kKvM / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float p = exp2_approx(s[i] * sl2 - Ls[col]);
      if (masked && (q0 + col >= Sq ||
                     !visible(q0 + col, key0 + 8 * ((i >> 1) & 1), Skv,
                              causal, window)))
        p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - Ds[col]);
    }
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kKvM / 16; ++t) {
      uint32_t hi[4], lo[4];
      pack_a_split(hi, lo, s, t);
      const uint64_t bdo =
          desc(sDO + st * L::kQT + t * 16 * kRow, kKvM * kRow, 1024);
      wgmma_rs<Hd::kHDP, 1>(adv, hi, bdo, 1);
      wgmma_rs<Hd::kHDP, 1>(adv, lo, bdo, 1);
      pack_a_split(hi, lo, dp, t);
      const uint64_t bq =
          desc(sQ + st * L::kQT + t * 16 * kRow, kKvM * kRow, 1024);
      wgmma_rs<Hd::kHDP, 1>(adk, hi, bq, 1);
      wgmma_rs<Hd::kHDP, 1>(adk, lo, bq, 1);
    }
    wgmma_commit();
    if (it + 1 < n) load_ld(it + 1);
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
    // the second warpgroup to be done with stage st refills it; the
    // barrier also orders this warpgroup's lse / D stages
    wg_sync(wg);
    if (wtid == 0 && (atomicAdd(&rel[st], 1u) & 1) && it + 2 < n)
      issue(it + 2);
  }
  const size_t base = (static_cast<size_t>(b) * Skv * Hkv + hk) * HD;
  const size_t rs = static_cast<size_t>(Hkv) * HD;
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<HD>(dv, adv, key0, Skv, base, rs, one, lane);
  store_rows<HD>(dk, adk, key0, Skv, base, rs, mul, lane);
}

// ------------------------------------------------------------- launchers

// TMA descriptor of a (B, S, Hx, hd) bf16 tensor read in boxes of 64
// columns x `rows` rows of one head, 128-byte swizzle; rows past S and
// columns past hd read as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int Hx,
                int hd, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(Hx),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * Hx, row * Hx * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  *done = e == cudaSuccess;
  return e;
}

unsigned tiles(int S, int t) { return static_cast<unsigned>((S + t - 1) / t); }

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const FlashGeo& G) {
  auto kernel = flash_fwd_sm90_kernel<HD>;
  constexpr size_t smem = FwdSmem<HD>::kBytes;
  static bool ready = false;
  if (cudaError_t e = prepare(kernel, smem, &ready)) return e;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, G.B, G.Sq, G.H, HD, kFwdM) ||
      !tensor_map(&mk, k, G.B, G.Skv, G.Hkv, HD, kFwdN) ||
      !tensor_map(&mv, v, G.B, G.Skv, G.Hkv, HD, kFwdN))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(G.B * G.H), tiles(G.Sq, kFwdM));
  kernel<<<grid, kThreadsTC, smem, G.stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, G.Sq, G.Skv, G.H,
      G.H / G.Hkv, G.causal, G.window, G.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dq(const void* dout, const void* q, const void* k,
                   const void* v, const void* out, const float* lse, void* dq,
                   float* delta, const FlashGeo& G) {
  auto kernel = flash_bwd_dq_sm90_kernel<HD>;
  constexpr size_t smem = DqSmem<HD>::kBytes;
  static bool ready = false;
  if (cudaError_t e = prepare(kernel, smem, &ready)) return e;
  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, q, G.B, G.Sq, G.H, HD, kDqM) ||
      !tensor_map(&mk, k, G.B, G.Skv, G.Hkv, HD, kDqN) ||
      !tensor_map(&mv, v, G.B, G.Skv, G.Hkv, HD, kDqN) ||
      !tensor_map(&mdo, dout, G.B, G.Sq, G.H, HD, kDqM))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(G.B * G.H), tiles(G.Sq, kDqM));
  kernel<<<grid, kThreadsTC, smem, G.stream>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), lse, static_cast<bf16*>(dq), delta,
      G.Sq, G.Skv, G.H, G.H / G.Hkv, G.causal, G.window, G.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dkdv(const void* dout, const void* q, const void* k,
                     const void* v, const float* lse, const float* delta,
                     void* dk, void* dv, const FlashGeo& G) {
  auto kernel = flash_bwd_dkdv_sm90_kernel<HD>;
  constexpr size_t smem = DkdvSmem<HD>::kBytes;
  static bool ready = false;
  if (cudaError_t e = prepare(kernel, smem, &ready)) return e;
  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map(&mq, q, G.B, G.Sq, G.H, HD, kKvM) ||
      !tensor_map(&mk, k, G.B, G.Skv, G.Hkv, HD, kKvN) ||
      !tensor_map(&mv, v, G.B, G.Skv, G.Hkv, HD, kKvN) ||
      !tensor_map(&mdo, dout, G.B, G.Sq, G.H, HD, kKvM))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(G.B * G.Hkv), tiles(G.Skv, kKvN));
  kernel<<<grid, kThreadsTC, smem, G.stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), G.Sq, G.Skv, G.Hkv, G.H / G.Hkv, G.causal,
      G.window, G.scale);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_FLASH_SM90_DISPATCH(FN, ...)      \
  switch (hd) {                                 \
    case 64: return FN<64>(__VA_ARGS__);        \
    case 96: return FN<96>(__VA_ARGS__);        \
    case 128: return FN<128>(__VA_ARGS__);      \
    default: return cudaErrorInvalidValue;      \
  }

cudaError_t flash_fwd_sm90(int hd, const void* q, const void* k,
                           const void* v, void* out, float* lse,
                           const FlashGeo& G) {
  REPRO_FLASH_SM90_DISPATCH(fwd, q, k, v, out, lse, G)
}

cudaError_t flash_bwd_dq_sm90(int hd, const void* dout, const void* q,
                              const void* k, const void* v, const void* out,
                              const float* lse, void* dq, float* delta,
                              const FlashGeo& G) {
  REPRO_FLASH_SM90_DISPATCH(bwd_dq, dout, q, k, v, out, lse, dq, delta, G)
}

cudaError_t flash_bwd_dkdv_sm90(int hd, const void* dout, const void* q,
                                const void* k, const void* v,
                                const float* lse, const float* delta,
                                void* dk, void* dv, const FlashGeo& G) {
  REPRO_FLASH_SM90_DISPATCH(bwd_dkdv, dout, q, k, v, lse, delta, dk, dv, G)
}

}  // namespace repro_torch
