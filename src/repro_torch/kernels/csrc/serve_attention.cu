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
// in registers.
//
// What it computes (kernels/ref.py: serve_attention_ref, the plain
// version): query row i of a chunk sees logical slot s as chunk row j's
// k, v and position when a real row j <= i writes s (slots consecutive
// from the chunk's first position modulo the row's ring), else as the
// slot's contents before the chunk; a slot of an unmapped block (table
// entry 0 of a paged pool) reads as empty. Scores q.k in f32 (q arrives
// pre-scaled), masked to -1e30 where pos < 0, pos > position_i or
// (window > 0) pos <= position_i - window; softmax; sum of a.v in f32,
// cast to the model dtype.
//
// Design: one block per (query rows group, kv head, batch row); each of
// its 8 warps owns one (query row, query head) of that kv head, so the
// n_rep x (rows of the group) query rows share every K/V tile the block
// loads. The block walks the logical slots in tiles of 32: the tile's old
// K and V (16-byte loads, widened to f32 in shared memory) and its slot
// table (position, the chunk row that writes it); lane t of a warp takes
// the score of slot t (a sequential dot over hd), the warp updates its
// running max, rescales, and adds the tile's 32 terms in slot order.
// Every (b, i, h) output is therefore reduced in an order fixed by the
// slot index and hd alone, never by the chunk width c, the batch B or the
// grid: a row of a c-row chunk equals, bit for bit, that row computed at
// c = 1 against the matching cache state, and masked slots (an empty
// slot, a longer ring, a null block) add exact zeros. Chunked prefill ==
// the per-token loop and paged == dense thus hold for the attention core
// by construction.
//
// Bound: decode is bound by bytes (the ring read once: B 4, ring 4096, 8
// kv heads, hd 128 in bf16 is 67.1 MB, 0.020 ms at 3.35 TB/s); a 64-row
// prefill chunk by its f32 operations (17.2 GFLOP at B 4, 0.26 ms at 67
// TFLOP/s). This first design is neither: each block walks the whole
// ring serially on the CUDA cores. Splitting the ring over blocks with a
// fixed-order combine, and prefill on the tensor cores, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;     // slots a tile: one a lane
constexpr int kWarps = 8;     // query rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kPadFloor = 1 << 29;
constexpr float kNegInf = -1e30f;

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
  int B, c, H, KH, NB, bs, mb, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T widened to f32 into dst[0 .. 16 / sizeof(T))
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    serve_attention_kernel(const Args a) {
  constexpr int VPT = 16 / sizeof(T);   // elements a 16-byte load
  constexpr int E = (HD + 31) / 32;     // output elements a lane
  __shared__ float ks[kTile][HD + 1];   // +1: lane t reads row t
  __shared__ float vs[kTile][HD];
  __shared__ float qs[kWarps][HD];
  __shared__ int pos_s[kTile], src_s[kTile], phys_s[kTile];

  const T* q = static_cast<const T*>(a.q);
  const T* kn = static_cast<const T*>(a.k);
  const T* vn = static_cast<const T*>(a.v);
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  const int b = blockIdx.z, kh = blockIdx.y;
  const int n_rep = a.H / a.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < a.c * n_rep;   // warp-uniform
  const int i = row / n_rep, h = kh * n_rep + row % n_rep;
  const int* pos_b = a.positions + static_cast<size_t>(b) * a.c;
  const int* trow = a.table ? a.table + static_cast<size_t>(b) * a.mb
                            : nullptr;
  const int ring = a.ring ? a.ring[b] : a.bs;
  const int first = pos_b[0] % ring;
  const int n_slots = a.mb * a.bs;
  const int pi = active ? pos_b[i] : 0;

  if (active)
    for (int d = lane; d < HD; d += 32)
      qs[warp][d] =
          to_f(q[(static_cast<size_t>(b) * a.c + i) * a.H * HD + h * HD + d]);

  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int s0 = 0; s0 < n_slots; s0 += kTile) {
    __syncthreads();                       // the last tile is consumed
    if (threadIdx.x < kTile) {             // the tile's slot table
      const int s = s0 + threadIdx.x;
      int p = -1, src = -1, phys = 0;
      if (s < n_slots) {
        phys = trow ? trow[s / a.bs] : b;
        const bool mapped = !trow || phys > 0;
        phys = min(max(phys, 0), a.NB - 1);
        if (mapped) {
          p = a.cpos[static_cast<size_t>(phys) * a.bs + s % a.bs];
          if (s < ring) {
            int j = s - first;
            if (j < 0) j += ring;
            if (j < a.c && pos_b[j] < kPadFloor) src = j;
          }
        }
      }
      pos_s[threadIdx.x] = p;
      src_s[threadIdx.x] = src;
      phys_s[threadIdx.x] = phys;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * HD / VPT; e += kThreads) {
      const int t = e / (HD / VPT), d0 = (e % (HD / VPT)) * VPT;
      const int s = s0 + t;
      float kx[VPT], vx[VPT];
      if (s < n_slots) {
        const size_t off =
            ((static_cast<size_t>(phys_s[t]) * a.bs + s % a.bs) * a.KH + kh) *
                HD + d0;
        widen16(ck + off, kx);
        widen16(cv + off, vx);
      } else {
#pragma unroll
        for (int x = 0; x < VPT; ++x) kx[x] = vx[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < VPT; ++x) {
        ks[t][d0 + x] = kx[x];
        vs[t][d0 + x] = vx[x];
      }
    }
    __syncthreads();
    if (!active) continue;

    // lane t: the score of slot s0 + t for this warp's query row
    const int src = src_s[lane];
    const bool fresh = src >= 0 && src <= i;   // written by row src <= i
    const int p = fresh ? pos_b[src] : pos_s[lane];
    float dot = 0.f;
    if (fresh) {
      const T* kr = kn + ((static_cast<size_t>(b) * a.c + src) * a.KH + kh) *
                             HD;
      for (int d = 0; d < HD; ++d) dot = fmaf(qs[warp][d], to_f(kr[d]), dot);
    } else {
      for (int d = 0; d < HD; ++d) dot = fmaf(qs[warp][d], ks[lane][d], dot);
    }
    const bool ok = p >= 0 && p <= pi && (a.window == 0 || p > pi - a.window);
    const float sc = ok ? dot : kNegInf;
    float tmax = sc;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    const float pr = expf(sc - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
    for (int t = 0; t < kTile; ++t) {      // the tile's terms in slot order
      const float pt = __shfl_sync(0xffffffffu, pr, t);
      l += pt;
      const int st = src_s[t];
      if (st >= 0 && st <= i) {            // warp-uniform
        const T* vr = vn + ((static_cast<size_t>(b) * a.c + st) * a.KH + kh) *
                               HD;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < HD) acc[e] = fmaf(pt, to_f(vr[d]), acc[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d < HD) acc[e] = fmaf(pt, vs[t][d], acc[e]);
        }
      }
    }
    m = m_new;
  }
  if (!active) return;
  T* out = static_cast<T*>(a.out) +
           (static_cast<size_t>(b) * a.c + i) * a.H * HD + h * HD;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < HD) out[d] = from_f<T>(acc[e] / l);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const int rows = a.c * (a.H / a.KH);
  const dim3 grid((rows + kWarps - 1) / kWarps, a.KH, a.B);
  serve_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 96: return launch<T, 96>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0 f32, 1 bf16; q, out: (B, c, H, hd); k, v: (B, c, KH, hd);
// positions (B, c) int32; ck, cv: (NB, bs, KH, hd); cpos (NB, bs) int32;
// table (B, mb) int32 and ring (B,) int32 of a paged pool, or both null
// for a dense cache (NB == B, mb == 1, the ring bs). The wrapper
// (kernels/serve_attention.py) checks shapes, dtypes, contiguity,
// 16-byte alignment and c <= ring.
extern "C" int serve_attention(int dtype, int hd, const void* q,
                               const void* k, const void* v,
                               const void* positions, const void* ck,
                               const void* cv, const void* cpos,
                               const void* table, const void* ring,
                               void* out, int B, int c, int H, int KH,
                               int NB, int bs, int mb, int window,
                               void* stream) {
  if (B < 1 || c < 1 || KH < 1 || H % KH || NB < 1 || bs < 1 || mb < 1 ||
      window < 0 || (table == nullptr) != (ring == nullptr) ||
      (table == nullptr && (NB != B || mb != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(positions), ck, cv,
               static_cast<const int*>(cpos), static_cast<const int*>(table),
               static_cast<const int*>(ring), out, B, c, H, KH, NB, bs, mb,
               window};
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(hd, a, st)
         : dtype == 0 ? dispatch<float>(hd, a, st)
                      : static_cast<int>(cudaErrorInvalidValue);
}
