// invariant_rmsnorm: the serving steps' RMSNorm and the residual add that
// precedes it, in one launch, each row reduced in an order fixed by its
// width d alone, whatever the number of rows M.
//
// Replaces no Pallas kernel: it is the XLA reduction of the JAX package's
// models/layers.py: rmsnorm (:41) on the serving path, with the block's
// residual add (x + h) before it. PyTorch's CUDA mean picks its threads
// per row by the number of rows, so a row's norm depended on how many
// rows came with it, and chunked prefill no longer matched the per-token
// loop.
//
// s = x + h, an f32 add rounded to T (PyTorch's x + h); y = (s *
// rsqrt(mean(s^2) + eps)) * g in f32, cast to T (kernels/ref.py:
// invariant_rmsnorm_ref). Without h (the norm-only form) s is x and is not
// written. Every multiply and add rounds on its own.
//
// A row is one block of 32 W threads; thread t owns the 16-byte vectors t,
// t + 32 W, ... (kVpt of them; E = 16 / sizeof(T) elements each). W is
// the least power of two (1 to 16 warps) that leaves a thread kMaxVpt = 4
// vectors or fewer, kVpt the least power of two that then covers ceil(d /
// E) vectors: one warp holds a row up to d 1024 in bf16 (512 in f32), 4
// warps at d 4096, 16 at 16384 (the widest: 16384 in bf16, 8192 in f32).
// A thread's serial work, not the bytes, bounds a launch of a few rows:
// on an H100, one warp a row at d 4096 (16 vectors a thread) took 0.0050
// ms with the add at M 4, four warps of 4 vectors 0.0025
// (scripts/invariant_rmsnorm_breakdown.py). A thread issues every load of
// x and h before the first use, keeps s in registers (as T, read from
// device memory once) and stores s and y in 16-byte vectors. Its squares
// go to E sums by the element's place in the vector, in vector order; the
// E sums fold pairwise (k + E/2 into k, ...), the lanes by a fixed xor
// butterfly and, for W > 1, the warps' sums in warp order behind one
// barrier. W and kVpt are functions of d alone, so a row's bits are the
// same at every M.
// A d that is not a multiple of E, or an operand that is not 16-byte
// aligned, takes the per-element form: the same vectors loaded element
// by element (zeros past d), the same order, the same bits.
//
// Bound: bytes (x and h read, s and y written, g); at a decode step's few
// rows, one launch. The add in the same launch saves the residual add's
// own launch and its pass over x, h and s.
#include <cstring>

#include "common.cuh"

namespace {

using repro_torch::Vec16;

constexpr int kMaxWarps = 16;
constexpr int kMaxVpt = 4;  // vectors a thread, before W grows

// threads a block of vpt vectors a thread may have (the registers of x
// and h in flight: 63 a thread at 4 bf16 vectors, 168 at 16)
constexpr int max_threads(int vpt) { return vpt <= 4 ? 512 : 2048 / vpt; }

// 16 bytes of T from E floats, each rounded to nearest even (bf16: one
// cvt.rn.bf16x2.f32 a pair)
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (sizeof(T) == 4) {
    return Vec16<T>::pack(f);
  } else {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
      memcpy(&w[q], &p, sizeof(unsigned));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// vector v of a row (elements v E .. v E + E - 1), zeros past d
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p, int v,
                                          int d) {
  constexpr int E = Vec16<T>::E;
  if constexpr (kVec) {
    return v * E < d ? __ldg(reinterpret_cast<const uint4*>(p) + v)
                     : make_uint4(0u, 0u, 0u, 0u);
  } else {
    float f[E];
#pragma unroll
    for (int k = 0; k < E; ++k)
      f[k] = v * E + k < d ? repro_torch::ld(p, v * E + k) : 0.f;
    return pack<T>(f);  // exact: each f came from a T
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int v, int d,
                                          const uint4& u) {
  constexpr int E = Vec16<T>::E;
  if constexpr (kVec) {
    if (v * E < d) reinterpret_cast<uint4*>(p)[v] = u;
  } else {
    float f[E];
    Vec16<T>::unpack(u, f);
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (v * E + k < d) repro_torch::st(p, v * E + k, f[k]);
  }
}

template <typename T, int kVpt, bool kAdd, bool kVec>
__global__ void __launch_bounds__(kVpt <= 4 ? 512 : 2048 / kVpt)
    invariant_rmsnorm_kernel(const T* __restrict__ x,
                             const T* __restrict__ h,
                             const T* __restrict__ g, T* __restrict__ s,
                             T* __restrict__ y, int d, float eps) {
  constexpr int E = Vec16<T>::E;
  __shared__ float part[kMaxWarps];
  const int nt = blockDim.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  x += row;
  y += row;
  uint4 a[kVpt];
  uint4 b[kVpt];
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    a[j] = load_vec<T, kVec>(x, threadIdx.x + j * nt, d);
    if constexpr (kAdd)
      b[j] = load_vec<T, kVec>(h + row, threadIdx.x + j * nt, d);
  }
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    float f[E];
    Vec16<T>::unpack(a[j], f);
    if constexpr (kAdd) {
      float q[E];
      Vec16<T>::unpack(b[j], q);
#pragma unroll
      for (int k = 0; k < E; ++k) f[k] = __fadd_rn(f[k], q[k]);
      a[j] = pack<T>(f);  // s, rounded to T
      Vec16<T>::unpack(a[j], f);
      store_vec<T, kVec>(s + row, threadIdx.x + j * nt, d, a[j]);
    }
#pragma unroll
    for (int k = 0; k < E; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(f[k], f[k]));
  }
  uint4 gv[kVpt];  // in flight while the sums fold
#pragma unroll
  for (int j = 0; j < kVpt; ++j)
    gv[j] = load_vec<T, kVec>(g, threadIdx.x + j * nt, d);
#pragma unroll
  for (int w = E / 2; w; w >>= 1)
#pragma unroll
    for (int k = 0; k < w; ++k) acc[k] = __fadd_rn(acc[k], acc[k + w]);
  float tot = acc[0];
#pragma unroll
  for (int o = 16; o; o >>= 1)
    tot = __fadd_rn(tot, __shfl_xor_sync(0xffffffffu, tot, o));
  if (nt > 32) {  // uniform over the block: W depends on d alone
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = tot;
    __syncthreads();
    tot = part[0];
    for (int w = 1; w < nt / 32; ++w) tot = __fadd_rn(tot, part[w]);
  }
  const float r =
      rsqrtf(__fadd_rn(__fdiv_rn(tot, static_cast<float>(d)), eps));
#pragma unroll
  for (int j = 0; j < kVpt; ++j) {
    float f[E], q[E];
    Vec16<T>::unpack(a[j], f);
    Vec16<T>::unpack(gv[j], q);
#pragma unroll
    for (int k = 0; k < E; ++k) f[k] = __fmul_rn(__fmul_rn(f[k], r), q[k]);
    store_vec<T, kVec>(y, threadIdx.x + j * nt, d, pack<T>(f));
  }
}

struct Plan {
  int warps, vpt;  // d too wide where vpt > kMaxVpt
};

// the threads and vectors of a row: functions of d (and E) alone
Plan plan(int d, int E) {
  const int nvec = (d + E - 1) / E;
  int w = 1;
  while (w < kMaxWarps && nvec > 32 * w * kMaxVpt) w *= 2;
  const int per = (nvec + 32 * w - 1) / (32 * w);
  int vpt = 1;
  while (vpt < per) vpt *= 2;
  return {w, vpt};
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the kernel of p.vpt vectors a thread (V = 1, 2, 4, ... kMaxVpt)
template <typename T, bool kAdd, bool kVec, int V = 1>
int launch(Plan p, const T* x, const T* h, const T* g, T* s, T* y, int M,
           int d, float eps, cudaStream_t st) {
  if (p.vpt == V) {
    invariant_rmsnorm_kernel<T, V, kAdd, kVec>
        <<<M, 32 * p.warps, 0, st>>>(x, h, g, s, y, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (V < kMaxVpt)
    return launch<T, kAdd, kVec, 2 * V>(p, x, h, g, s, y, M, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run(const void* x, const void* h, const void* g, void* s, void* y, int M,
        int d, float eps, cudaStream_t st) {
  const Plan p = plan(d, Vec16<T>::E);
  if (p.vpt > kMaxVpt || 32 * p.warps > max_threads(p.vpt))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % Vec16<T>::E == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(y) && (!h || (aligned16(h) && aligned16(s)));
  const auto* xt = static_cast<const T*>(x);
  const auto* ht = static_cast<const T*>(h);
  const auto* gt = static_cast<const T*>(g);
  auto* st_ = static_cast<T*>(s);
  auto* yt = static_cast<T*>(y);
  if (h)
    return vec ? launch<T, true, true>(p, xt, ht, gt, st_, yt, M, d, eps, st)
               : launch<T, true, false>(p, xt, ht, gt, st_, yt, M, d, eps, st);
  return vec ? launch<T, false, true>(p, xt, ht, gt, st_, yt, M, d, eps, st)
             : launch<T, false, false>(p, xt, ht, gt, st_, yt, M, d, eps, st);
}

}  // namespace

// dtype 0 f32, 1 bf16; x, h, s, y (M, d) contiguous, g (d); h and s null
// for the norm-only form. The wrappers (kernels/invariant_rmsnorm.py)
// check shapes, dtypes and contiguity.
extern "C" int invariant_rmsnorm(int dtype, const void* x, const void* h,
                                 const void* g, void* s, void* y, int M,
                                 int d, float eps, void* stream) {
  if (M < 1 || d < 1 || (h == nullptr) != (s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, h, g, s, y, M, d, eps, st);
  if (dtype == 0) return run<float>(x, h, g, s, y, M, d, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0] warps a row, out[1] vectors a thread, out[2] 1 where d takes
// 16-byte vectors (aligned operands given), out[3] 1 where d is too wide
extern "C" void invariant_rmsnorm_plan(int dtype, int d, int* out) {
  const int E = dtype == 1 ? Vec16<__nv_bfloat16>::E : Vec16<float>::E;
  const Plan p = plan(d, E);
  out[0] = p.warps;
  out[1] = p.vpt;
  out[2] = d % E == 0;
  out[3] = p.vpt > kMaxVpt || 32 * p.warps > max_threads(p.vpt);
}
