// serve_attention: the attention core of serving, decode and chunked
// prefill alike, over a dense ring cache or a paged block pool.
//
// Replaces no Pallas kernel: the JAX package computes this with XLA
// einsums in models/attention.py (attention_decode :166,
// attention_prefill :238, attention_decode_paged :354,
// attention_prefill_paged :389). There, kv heads are repeated to the
// query heads in f32 and a prefill chunk that wraps the ring builds a
// (B, c, L, H, hd) f32 copy of V so that each query row sees exactly the
// ring state the per-token loop would see. At minitron-8b's serving shape
// (window 4096, H 32, 8 kv heads, hd 128) that copy is 4.29 GB per
// request and layer for a 64-row chunk. This kernel reads the cache once,
// in the model dtype, through the block table, and selects per query row
// as it goes.
//
// What it computes (kernels/ref.py: serve_attention_ref, the plain
// version): query row i of a chunk sees logical slot s as chunk row j's
// k, v and position when a real row j <= i writes s (slots consecutive
// from the chunk's first position modulo the row's ring), else as the
// slot's contents before the chunk; a slot of an unmapped block (table
// entry 0 of a paged pool) reads as empty. Scores q.k in f32 (q arrives
// pre-scaled), masked to -1e30 where pos < 0, pos > position_i or
// (window > 0) pos <= position_i - window; softmax; sum of a.v in f32,
// cast to the model dtype. A row that sees no slot at all (a pad row
// under a window) gets the plain mean of every slot's v, as the plain
// version's softmax of all -1e30 gives.
//
// Design (the second; the first walked the whole ring in one block per 8
// query rows, 32 blocks for minitron's decode, all on the CUDA cores):
//  - The logical ring is cut into spans of kSpan = 256 slots, by slot
//    index alone (never by c, B, bs, mb or the grid). A block owns (span,
//    group of up to 64 query rows, kv head, batch row): every query row
//    of the kv head, c x n_rep of them, shares each K/V tile the block
//    loads, so at prefill the ring is read once a span per 64 rows, not
//    once per 8. Decode at minitron's shape is 16 spans x 8 kv heads x 4
//    rows = 512 blocks.
//  - The span is walked in tiles of 32 slots, two tiles in flight
//    (cp.async, 16-byte copies in the model dtype through the block
//    table; an unmapped block reads the null block, as the plain version
//    does). bf16 scores are mma.sync m16n8k16 products of the rows' q
//    and the tile's keys (an element is its own hd-long dot, the same
//    bits wherever its row and slot sit in the tile), S_old against the
//    cached keys and, when the tile holds slots the chunk writes,
//    S_new against those chunk rows' keys; each (row, slot) then takes
//    S_new only where its chunk row j <= i. The score of a key written
//    by the chunk equals, bit for bit, its score at c = 1 where the key
//    already sits in the cache. f32 scores are fmaf dots over hd in
//    order on the CUDA cores, fresh or old alike.
//  - A warp owns its rows' online softmax (lane = slot of the tile) and
//    their P.V: one fmaf a (row, slot, element) in slot order on the CUDA
//    cores, each slot's v the chunk row's or the cache's for that row, so
//    every slot's term sits in the same place of the same sum whatever
//    c is. A term whose weight is exactly 0 (a masked slot once the row
//    has seen a visible one) is skipped, and the rescale of a row that
//    meets its first visible slot sets its sums to 0, so no value of a
//    masked slot (an unmapped block may hold anything) reaches a row
//    that sees a slot.
//  - Each span writes its rows' partial (m, l, acc) in f32 to scratch;
//    the last block of a (row group, kv head, batch row) to arrive (an
//    integer counter, reset by it) folds the spans in span order: M =
//    max m, then w_s = exp(m_s - M), L and acc summed by fmaf in span
//    order with w_s = 0 spans skipped (a span that saw no visible slot
//    has m = -1e30 and weighs exactly 0). One launch a call. A one-span
//    ring folds its one partial in registers by the same arithmetic.
// Every output is thus reduced in an order fixed by the slot index and
// hd alone: a row of a c-row chunk equals that row computed at c = 1,
// and a paged pool equals the dense cache it maps, bit for bit.
//
// The cross form (serve_cross_attention, the encoder-decoder family's
// decoder): the JAX package's cross_attention_decode
// (models/attention.py:200), q rows against a fixed K/V (B, L, KH, hd),
// the encoder's, read as a dense cache of one L-slot block a row with
// every slot visible: no positions, no ring, no chunk rows merged in,
// nothing written. The same kernel with a flag (Args::cross): the slots'
// positions read as 0 and the rows' as 0, so the mask lets every slot
// through, and no slot has a chunk row as its source. The reduction
// order is the self-attention form's, fixed by slot index and hd, so a
// row of a c-row chunk equals that row at c = 1 bit for bit; pad rows of
// a chunk compute like any row and the caller drops them. At whisper's
// shape (L 1500, 16 heads of 64, bf16) it reads 24.6 MB of K/V a layer
// at B 4: bound by bytes, 7.3 us at 3.35 TB/s.
//
// Bound: decode is bound by bytes (the ring read once: B 4, ring 4096, 8
// kv heads, hd 128 in bf16 is 67.1 MB, 0.020 ms at 3.35 TB/s); a 64-row
// prefill chunk by its operations (17.2 GFLOP at B 4: half on the tensor
// cores, 0.009 ms at 989 TFLOP/s, half, P.V, on the CUDA cores, 0.128 ms
// at 67 TFLOP/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

using repro_torch::mma::cp16;
using repro_torch::mma::cp_commit;
using repro_torch::mma::cp_wait;
using repro_torch::mma::mma_bf16;

constexpr int kTile = 32;            // slots a tile: one a lane
constexpr int kSpan = 256;           // slots a span: the unit of the split
constexpr int kStages = 2;           // tiles in flight
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPadFloor = 1 << 29;
constexpr float kNegInf = -1e30f;    // a masked slot's score

struct Args {
  const void* q;          // (B, c, H, hd), pre-scaled
  const void* k;          // (B, c, KH, hd), the chunk's new keys
  const void* v;          // (B, c, KH, hd)
  const int* positions;   // (B, c)
  const void* ck;         // (NB, bs, KH, hd), before the chunk's write
  const void* cv;
  const int* cpos;        // (NB, bs)
  const int* table;       // (B, mb) or null (dense: row b is block b)
  const int* ring;        // (B,) or null (dense: the ring is bs)
  void* out;              // (B, c, H, hd)
  float* part;            // (B, KH, c n_rep, spans, hd + 4) when spans > 1
  int* count;             // (B, KH, groups), zero between launches
  int B, c, H, KH, NB, bs, mb, window, spans, groups;
  int cross;              // 1: every slot visible, no chunk rows merged
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared-memory layout of one instantiation (dynamic part)
template <typename T, int HD, int RPW>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRows = kWarps * RPW;          // query rows a block
  static constexpr int kQRows = kRows < 16 ? 16 : kRows;
  static constexpr int KLD = HD + 16 / sizeof(T);     // a K row, padded
  static constexpr int QLD = kBf16 ? HD + 8 : HD;
  static constexpr int SLD = kTile + 1;
  static constexpr size_t kK = size_t(kStages) * kTile * KLD * sizeof(T);
  static constexpr size_t kV = size_t(kStages) * kTile * HD * sizeof(T);
  static constexpr size_t kQ = size_t(kQRows) * QLD * sizeof(T);
  static constexpr size_t kS = kBf16 ? 2ull * kQRows * SLD * 4 : 0;
  static constexpr size_t kP = size_t(kWarps) * kTile * RPW * 4;
  static constexpr size_t kBytes = kK + kV + kQ + kS + kP;
};

// floats a row's partial takes: m, l, two pads, acc (16-byte aligned)
template <int HD>
constexpr int kPartWidth = HD + 4;

// E consecutive elements of a row, widened to f32 (16-, 8- or 4-byte
// loads where E allows; the wrapper checks the operands' alignment)
template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&v)[E]) {
  if constexpr (E == 8) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + 4);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else if constexpr (E == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (E == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = p[e];
  }
}
template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[E]) {
  if constexpr (E == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  } else if constexpr (E == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(x << 16);
    v[1] = __uint_as_float(x & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __bfloat162float(p[e]);
  }
}

// true if any of the 16 bytes at p holds an Inf or NaN of T
__device__ __forceinline__ bool nonfinite16(const float* p) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) bad |= (w[i] & 0x7f800000u) == 0x7f800000u;
  return bad;
}
__device__ __forceinline__ bool nonfinite16(const __nv_bfloat16* p) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    bad |= (w[i] & 0x7f80u) == 0x7f80u ||
           (w[i] & 0x7f800000u) == 0x7f800000u;
  return bad;
}

// out = A / L of one row from its spans' partials, folded in span order
template <int E>
__device__ __forceinline__ void fold(float M, float m_s, float l_s,
                                     const float (&a_s)[E], float& L,
                                     float (&A)[E]) {
  const float w = expf(__fsub_rn(m_s, M));
  if (w != 0.f) {
    L = fmaf(w, l_s, L);
#pragma unroll
    for (int e = 0; e < E; ++e) A[e] = fmaf(w, a_s[e], A[e]);
  }
}

template <typename T, int HD, int RPW>
__global__ void __launch_bounds__(kThreads, RPW == 1 ? 4 : 2)
    serve_attention_kernel(const Args a) {
  using L_ = Smem<T, HD, RPW>;
  constexpr int E = HD / 32;                // output elements a lane
  constexpr int CH = HD * sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int VPT = 16 / sizeof(T);       // elements a chunk
  constexpr int kRows = L_::kRows;
  constexpr int PW = kPartWidth<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + L_::kK);
  T* Qs = reinterpret_cast<T*>(smem + L_::kK + L_::kV);
  float* So = reinterpret_cast<float*>(smem + L_::kK + L_::kV + L_::kQ);
  float* Sn = So + L_::kQRows * L_::SLD;
  // this warp's weights of the tile: Ps[slot][row k], RPW a slot
  float* Ps = reinterpret_cast<float*>(smem + L_::kK + L_::kV + L_::kQ +
                                       L_::kS) +
              (threadIdx.x >> 5) * kTile * RPW;
  __shared__ int pos_s[kSpan], src_s[kSpan], row_s[kSpan];
  __shared__ int last;

  const T* q = static_cast<const T*>(a.q);
  const T* kn = static_cast<const T*>(a.k);
  const T* vn = static_cast<const T*>(a.v);
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  const int span = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y % a.KH, grp = blockIdx.y / a.KH;
  const int n_rep = a.H / a.KH, rows_total = a.c * n_rep;
  const int r0 = grp * kRows, R = min(kRows, rows_total - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* pos_b =
      a.cross ? nullptr : a.positions + static_cast<size_t>(b) * a.c;
  const int* trow = a.table ? a.table + static_cast<size_t>(b) * a.mb
                            : nullptr;
  const int ring = a.ring ? a.ring[b] : a.bs;
  const int first = a.cross ? 0 : pos_b[0] % ring;
  const int n_slots = a.mb * a.bs;
  const int s0 = span * kSpan, span_n = min(kSpan, n_slots - s0);
  const int tiles = (span_n + kTile - 1) / kTile;

  // the span's cache rows first (the copies need them), positions and
  // chunk rows while the first copies fly
  for (int t = threadIdx.x; t < kSpan; t += kThreads) {
    const int s = s0 + t;
    int rw = 0;
    if (t < span_n) {
      const int phys = trow ? min(max(trow[s / a.bs], 0), a.NB - 1) : b;
      rw = phys * a.bs + s % a.bs;
    }
    row_s[t] = rw;
  }
  __syncthreads();

  // a tile's K and V into stage tt % kStages (slots past the span: zeros)
  auto issue_tile = [&](int tt) {
    T* kd = Ks + (tt % kStages) * kTile * L_::KLD;
    T* vd = Vs + (tt % kStages) * kTile * HD;
    for (int e = threadIdx.x; e < kTile * CH; e += kThreads) {
      const int sl = e / CH, c16 = e % CH, ls = tt * kTile + sl;
      const bool ok = ls < span_n;
      const size_t off =
          (static_cast<size_t>(ok ? row_s[ls] : 0) * a.KH + kh) * HD +
          c16 * VPT;
      cp16(kd + sl * L_::KLD + c16 * VPT, ck + off, ok);
      cp16(vd + sl * HD + c16 * VPT, cv + off, ok);
    }
  };
  // the block's query rows (rows beyond R zero) with the first tile
  for (int e = threadIdx.x; e < L_::kQRows * CH; e += kThreads) {
    const int rl = e / CH, c16 = e % CH, r = r0 + rl;
    const bool ok = rl < R;
    const int i = ok ? r / n_rep : 0, h = kh * n_rep + (ok ? r % n_rep : 0);
    cp16(Qs + rl * L_::QLD + c16 * VPT,
         q + ((static_cast<size_t>(b) * a.c + i) * a.H + h) * HD + c16 * VPT,
         ok);
  }
  for (int tt = 0; tt < kStages - 1; ++tt) {   // q rides with tile 0
    if (tt < tiles) issue_tile(tt);
    cp_commit();
  }
  for (int t = threadIdx.x; t < kSpan; t += kThreads) {
    // old position (-1: past the span or an unmapped block) and the
    // chunk row that writes the slot (-1: none)
    const int s = s0 + t;
    int p = -1, src = -1;
    if (t < span_n && (!trow || trow[s / a.bs] > 0)) {
      p = a.cross ? 0 : a.cpos[row_s[t]];
      if (!a.cross && s < ring) {
        int j = s - first;
        if (j < 0) j += ring;
        if (j < a.c && pos_b[j] < kPadFloor) src = j;
      }
    }
    pos_s[t] = p;
    src_s[t] = src;
  }

  // this warp's rows: local rows warp + 8 k
  int ri[RPW], pi[RPW];
  float m[RPW], l[RPW], acc[RPW][E];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int rl = warp + kWarps * k;
    ri[k] = rl < R ? (r0 + rl) / n_rep : -1;   // -1: no row here
    pi[k] = rl < R && !a.cross ? pos_b[ri[k]] : 0;
    m[k] = kNegInf;
    l[k] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.f;
  }
  const int m_frags = (R + 15) / 16;

  for (int tt = 0; tt < tiles; ++tt) {
    if (tt + kStages - 1 < tiles) issue_tile(tt + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();
    const T* Kt = Ks + (tt % kStages) * kTile * L_::KLD;
    const T* Vt = Vs + (tt % kStages) * kTile * HD;
    bool bad = false;                      // this thread's V chunks
    for (int e = threadIdx.x; e < kTile * CH; e += kThreads)
      bad |= nonfinite16(Vt + (e / CH) * HD + (e % CH) * VPT);
    // tile tt (and q) landed for every thread; any value of V not finite
    const bool clean = !__syncthreads_or(bad);
    const int ls0 = tt * kTile;
    const int ls = ls0 + lane;
    const bool fresh_tile =
        __any_sync(0xffffffffu, ls < span_n && src_s[ls] >= 0);

    if constexpr (L_::kBf16) {             // S_old, S_new on the tensor cores
      const int g = lane >> 2, t = lane & 3;
      for (int p = warp; p < m_frags * 4; p += kWarps) {
        const int mf = p >> 2, nf = p & 3;
        const T* qa = Qs + (mf * 16 + g) * L_::QLD + 2 * t;
        const T* kb = Kt + (nf * 8 + g) * L_::KLD + 2 * t;
        const int sn = ls0 + nf * 8 + g;   // slot of this lane's B column
        const int src = sn < span_n ? src_s[sn] : -1;
        const T* kr = kn + ((static_cast<size_t>(b) * a.c + max(src, 0)) *
                                a.KH + kh) * HD + 2 * t;
        float d_old[4] = {0.f, 0.f, 0.f, 0.f};
        float d_new[4] = {0.f, 0.f, 0.f, 0.f};
        // the same products of S_old either way; the branch sits outside
        // the k16 loop so its loads and products interleave
        auto k16 = [&](int kk, bool fresh) {
          const uint32_t af[4] = {
              *reinterpret_cast<const uint32_t*>(qa + kk),
              *reinterpret_cast<const uint32_t*>(qa + 8 * L_::QLD + kk),
              *reinterpret_cast<const uint32_t*>(qa + kk + 8),
              *reinterpret_cast<const uint32_t*>(qa + 8 * L_::QLD + kk + 8)};
          mma_bf16(d_old, af, *reinterpret_cast<const uint32_t*>(kb + kk),
                   *reinterpret_cast<const uint32_t*>(kb + kk + 8));
          if (fresh) {
            const uint32_t b0 =
                src >= 0 ? *reinterpret_cast<const uint32_t*>(kr + kk) : 0u;
            const uint32_t b1 =
                src >= 0 ? *reinterpret_cast<const uint32_t*>(kr + kk + 8)
                         : 0u;
            mma_bf16(d_new, af, b0, b1);
          }
        };
        if (fresh_tile) {
#pragma unroll
          for (int kk = 0; kk < HD; kk += 16) k16(kk, true);
        } else {
#pragma unroll
          for (int kk = 0; kk < HD; kk += 16) k16(kk, false);
        }
        float* so = So + (mf * 16 + g) * L_::SLD + nf * 8 + 2 * t;
        float* sn_ = Sn + (mf * 16 + g) * L_::SLD + nf * 8 + 2 * t;
        so[0] = d_old[0];
        so[1] = d_old[1];
        so[8 * L_::SLD] = d_old[2];
        so[8 * L_::SLD + 1] = d_old[3];
        if (fresh_tile) {
          sn_[0] = d_new[0];
          sn_[1] = d_new[1];
          sn_[8 * L_::SLD] = d_new[2];
          sn_[8 * L_::SLD + 1] = d_new[3];
        }
      }
      __syncthreads();
    }

    // the warp's rows' online softmax: lane = slot of the tile
    const bool exists = ls < span_n;
    const int src = exists ? src_s[ls] : -1;
    const int p_old = exists ? pos_s[ls] : -1;
    const int p_new = src >= 0 ? pos_b[src] : -1;
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      float pr = 0.f;
      if (ri[k] >= 0) {                    // warp-uniform
        const int rl = warp + kWarps * k;
        const bool fresh = src >= 0 && src <= ri[k];
        float dot;
        if constexpr (L_::kBf16) {
          dot = fresh ? Sn[rl * L_::SLD + lane] : So[rl * L_::SLD + lane];
        } else {
          const float* qr = reinterpret_cast<const float*>(Qs) + rl * HD;
          const float* kr =
              fresh ? reinterpret_cast<const float*>(kn) +
                          ((static_cast<size_t>(b) * a.c + src) * a.KH +
                           kh) * HD
                    : reinterpret_cast<const float*>(Kt) + lane * L_::KLD;
          dot = 0.f;
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        }
        const int p = fresh ? p_new : p_old;
        const bool ok = p >= 0 && p <= pi[k] &&
                        (a.window == 0 || p > pi[k] - a.window);
        const float sc = !exists ? -INFINITY : ok ? dot : kNegInf;
        float tmax = sc;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(m[k], tmax);
        const float corr = expf(__fsub_rn(m[k], m_new));
        pr = expf(__fsub_rn(sc, m_new));
        float tsum = pr;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          tsum = __fadd_rn(tsum, __shfl_xor_sync(0xffffffffu, tsum, o));
        // every op rounded on its own: the two row-group widths are two
        // instantiations, and no contraction may differ between them
        l[k] = __fadd_rn(__fmul_rn(l[k], corr), tsum);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[k][e] = corr == 0.f ? 0.f : __fmul_rn(acc[k][e], corr);
        m[k] = m_new;
      }
      Ps[lane * RPW + k] = pr;             // a row not here weighs 0
    }
    __syncwarp();

    // P.V on the CUDA cores, the tile's slots in order (slots past the
    // span hold v = 0 and weigh 0)
    if (clean && !fresh_tile) {
      // every v finite and no chunk row's: fmaf(0, v, acc) == acc (up to
      // the sign of a zero), so a term of weight 0 needs no test
#pragma unroll 8
      for (int sl = 0; sl < kTile; ++sl) {
        float v[E], pw[RPW];
        load_row<E>(Vt + sl * HD + lane * E, v);
        load_row<RPW>(Ps + sl * RPW, pw);
#pragma unroll
        for (int k = 0; k < RPW; ++k)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[k][e] = fmaf(pw[k], v[e], acc[k][e]);
      }
    } else {
      for (int sl = 0; sl < kTile && ls0 + sl < span_n; ++sl) {
        const int s_src = src_s[ls0 + sl];  // block-uniform
        float vo[E], vf[E], pw[RPW];
        load_row<E>(Vt + sl * HD + lane * E, vo);
        load_row<RPW>(Ps + sl * RPW, pw);
        if (s_src >= 0)
          load_row<E>(vn + ((static_cast<size_t>(b) * a.c + s_src) * a.KH +
                            kh) * HD + lane * E, vf);
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          if (pw[k] == 0.f) continue;       // warp-uniform: an exact zero
          const bool fresh = s_src >= 0 && s_src <= ri[k];
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[k][e] = fmaf(pw[k], fresh ? vf[e] : vo[e], acc[k][e]);
        }
      }
    }
    __syncthreads();                       // the stage, S and P are free
  }

  auto out_row = [&](int k, float L, const float (&A)[E]) {
    const int r = r0 + warp + kWarps * k;
    const int i = r / n_rep, h = kh * n_rep + r % n_rep;
    T* o = static_cast<T*>(a.out) +
           ((static_cast<size_t>(b) * a.c + i) * a.H + h) * HD + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = from_f<T>(__fdiv_rn(A[e], L));
  };
  if (a.spans == 1) {                      // fold the one partial
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      if (ri[k] < 0) continue;
      float L = 0.f, A[E];
#pragma unroll
      for (int e = 0; e < E; ++e) A[e] = 0.f;
      fold<E>(m[k], m[k], l[k], acc[k], L, A);
      out_row(k, L, A);
    }
    return;
  }
  // this span's partials: (m, l, -, -, acc[hd]) a row
  const size_t row0 =
      (static_cast<size_t>(b) * a.KH + kh) * rows_total + r0;  // first row
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    if (ri[k] < 0) continue;
    float* pp = a.part + ((row0 + warp + kWarps * k) * a.spans + span) * PW;
    if (lane == 0) {
      pp[0] = m[k];
      pp[1] = l[k];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) pp[4 + lane * E + e] = acc[k][e];
  }
  __threadfence();
  __syncthreads();
  int* cnt = a.count + (static_cast<size_t>(b) * a.KH + kh) * a.groups + grp;
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt, 1) == a.spans - 1;
    if (last) *cnt = 0;                    // every span has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kBatch = 8;                // spans whose loads fly at once
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    if (ri[k] < 0) continue;
    const float* pp = a.part + (row0 + warp + kWarps * k) * a.spans * PW;
    float M = kNegInf;                     // max is exact: lanes in parallel
    for (int s = lane; s < a.spans; s += 32) M = fmaxf(M, __ldcg(pp + s * PW));
#pragma unroll
    for (int o = 16; o; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f, A[E];
#pragma unroll
    for (int e = 0; e < E; ++e) A[e] = 0.f;
    for (int sb = 0; sb < a.spans; sb += kBatch) {
      float ms[kBatch], lsum[kBatch], as[kBatch][E];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (sb + j >= a.spans) break;
        const float* ps = pp + (sb + j) * PW;
        ms[j] = __ldcg(ps);
        lsum[j] = __ldcg(ps + 1);
#pragma unroll
        for (int e = 0; e < E; ++e) as[j][e] = __ldcg(ps + 4 + lane * E + e);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {   // the spans in slot order
        if (sb + j >= a.spans) break;
        fold<E>(M, ms[j], lsum[j], as[j], L, A);
      }
    }
    out_row(k, L, A);
  }
}

template <typename T, int HD, int RPW>
int launch(const Args& a, cudaStream_t stream) {
  using L_ = Smem<T, HD, RPW>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        serve_attention_kernel<T, HD, RPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L_::kBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const dim3 grid(a.spans, a.KH * a.groups, a.B);
  serve_attention_kernel<T, HD, RPW>
      <<<grid, kThreads, L_::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rows(int rpw, const Args& a, cudaStream_t stream) {
  return rpw == 1 ? launch<T, HD, 1>(a, stream) : launch<T, HD, 8>(a, stream);
}

template <typename T>
int dispatch(int hd, int rpw, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return by_rows<T, 32>(rpw, a, stream);
    case 64: return by_rows<T, 64>(rpw, a, stream);
    case 96: return by_rows<T, 96>(rpw, a, stream);
    case 128: return by_rows<T, 128>(rpw, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0 f32, 1 bf16; q, out: (B, c, H, hd); k, v: (B, c, KH, hd);
// positions (B, c) int32; ck, cv: (NB, bs, KH, hd); cpos (NB, bs) int32;
// table (B, mb) int32 and ring (B,) int32 of a paged pool, or both null
// for a dense cache (NB == B, mb == 1, the ring bs). rpw: query rows a
// warp, 1 when c * H / KH <= 8 (groups of 8 rows) else 8 (groups of 64);
// spans = ceil(mb * bs / 256), groups = ceil(c * H / KH / (8 rpw)); part
// (B, KH, c H / KH, spans, hd + 4) f32 and count (B, KH, groups) int32,
// zero, when spans > 1. The wrapper (kernels/serve_attention.py) checks
// shapes, dtypes, contiguity, 16-byte alignment and c <= ring.
extern "C" int serve_attention(int dtype, int hd, const void* q,
                               const void* k, const void* v,
                               const void* positions, const void* ck,
                               const void* cv, const void* cpos,
                               const void* table, const void* ring,
                               void* out, void* part, void* count, int B,
                               int c, int H, int KH, int NB, int bs, int mb,
                               int window, int rpw, void* stream) {
  if (B < 1 || c < 1 || KH < 1 || H % KH || NB < 1 || bs < 1 || mb < 1 ||
      window < 0 || (rpw != 1 && rpw != 8) ||
      (table == nullptr) != (ring == nullptr) ||
      (table == nullptr && (NB != B || mb != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_slots = static_cast<long long>(mb) * bs;
  const int spans = static_cast<int>((n_slots + kSpan - 1) / kSpan);
  const int rows = c * (H / KH);
  const int groups = (rows + kWarps * rpw - 1) / (kWarps * rpw);
  if (spans > 1 && (part == nullptr || count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(positions), ck, cv,
               static_cast<const int*>(cpos), static_cast<const int*>(table),
               static_cast<const int*>(ring), out,
               static_cast<float*>(part), static_cast<int*>(count), B, c, H,
               KH, NB, bs, mb, window, spans, groups, 0};
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(hd, rpw, a, st)
         : dtype == 0 ? dispatch<float>(hd, rpw, a, st)
                      : static_cast<int>(cudaErrorInvalidValue);
}

// The cross form: q, out (B, c, H, hd), pre-scaled q; ck, cv (B, L, KH,
// hd), the fixed K/V every row sees in full; rpw, part and count as for
// serve_attention with mb 1 and bs L (spans = ceil(L / 256)).
extern "C" int serve_cross_attention(int dtype, int hd, const void* q,
                                     const void* ck, const void* cv,
                                     void* out, void* part, void* count,
                                     int B, int c, int H, int KH, int L,
                                     int rpw, void* stream) {
  if (B < 1 || c < 1 || KH < 1 || H % KH || L < 1 ||
      (rpw != 1 && rpw != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int spans = (L + kSpan - 1) / kSpan;
  const int rows = c * (H / KH);
  const int groups = (rows + kWarps * rpw - 1) / (kWarps * rpw);
  if (spans > 1 && (part == nullptr || count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // no chunk keys: k and v stand in as ck and cv, never read
  const Args a{q, ck, cv, nullptr, ck, cv, nullptr, nullptr, nullptr, out,
               static_cast<float*>(part), static_cast<int*>(count), B, c, H,
               KH, B, L, 1, 0, spans, groups, 1};
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(hd, rpw, a, st)
         : dtype == 0 ? dispatch<float>(hd, rpw, a, st)
                      : static_cast<int>(cudaErrorInvalidValue);
}
