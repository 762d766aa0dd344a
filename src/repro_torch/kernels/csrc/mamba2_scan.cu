// The Mamba-2 (SSD) state recurrence for Hopper (sm_90a), forward and
// backward, bound with ctypes.
//
// Neither replaces a Pallas kernel: the JAX package runs the recurrence
// as a lax.scan over 64-step chunks under jax.checkpoint
// (src/repro/models/mamba2.py:113) and leaves its gradient to XLA. Run
// from Python on the card that scan would be 2,048 dependent steps of
// several launches each, for every layer. Per (batch, head), with the
// state h (P, N) f32 (P = 64, the head dim; N the state size):
//   h_t = a_t h_{t-1} + x_t (outer) B_t,   y_t = h_t C_t,
// a (B, S, H), x (B, S, H, P) (dt-scaled), B and C (B, S, N), shared by
// the heads. mamba2_fwd writes y (B, S, H, P), h_final (B, H, P, N) and,
// for the backward, the state entering every kCk-th step (states, (B, H,
// ceil(S / kCk), P, N), h0 first). mamba2_bwd, with G the adjoint of
// h_t, walking time backward:
//   G += dy_t (outer) C_t,   dC_t = sum_{h,p} h_t dy_t,
//   dxdt_t = G B_t,  dB_t = sum_{h,p} G x_t,  da_t = sum_{p,n} G h_{t-1},
//   G <- a_t G,  and dh0 = G at the end.
// (kernels/ref.py: mamba2_scan_ref, mamba2_scan_bwd_ref.)
//
// Design (a first one: right and simple). One block of 256 threads per
// (batch, head) in both directions: 128 blocks at the pod shape (B 2, H
// 64), one an SM. Thread i holds row p = i / 4 of the state and N / 4
// consecutive columns (16 at N 64) in registers. A step is, per thread,
// N / 4 state updates and, for the forward, a dot with C_t whose four
// partials meet in a fixed butterfly (two xor shuffles), so every lane
// of a row holds the same y.
//   mamba2_fwd_kernel walks the S steps in segments of kCk. cp.async
//   stages the next segment's a, x, B and C into the second half of a
//   double buffer while the current one is computed; the state entering
//   each segment is stored to `states`.
//   mamba2_bwd_kernel walks the segments from last to first. It stages
//   a segment's a, x, dy, B and C, restarts the state from the segment's
//   saved state, steps it forward once, storing every kSub-th state to a
//   per-block scratch (each thread its own values, so no barrier: 256 KB
//   a block, 32 MB at the pod shape, held by L2), then takes the
//   sub-segments from last to first: the sub-segment's kSub states are
//   stepped forward again from the scratch into shared memory (each
//   thread its own slots) and walked backward. dxdt meets over the four
//   lanes of a row; dB and dC over the eight rows of a warp (xor 4, 8,
//   16) and then over the eight warps in warp order, through shared
//   memory, once a sub-segment; da over the warp (xor 1..16) and then
//   the warps in order. dB and dC leave the block per head (B, S, H, N);
//   mamba2_bwd_heads_kernel then sums them over the heads in head order.
// Every sum runs in a fixed order and nothing is accumulated across
// blocks, so each call is deterministic (no atomics): the port's chunked
// == per-round contract holds bitwise. The state updates h = a h + x B
// and G = G + dy C, G = a G round each multiply and add alone
// (__fmul_rn / __fadd_rn), as the plain version's elementwise ops do, so
// the states and adjoints carry the plain version's bits; only the dots
// (y, dxdt, dB, dC, da) sum in another order. h_{t-1} is never recovered
// by dividing by a_t (a = exp(softplus(dt) A) underflows to 0).
//
// Bound (chip_smoke.py: time_mamba2). At the pod shape (B 2, S 2048, H
// 64, P 64, N 64) the forward's function reads a, x, B, C and h0 and
// writes y and h_final (141.6 MB, 0.042 ms at 3.35 TB/s) and does 5 P N
// f32 flops a step per (b, h) (5.37 GFLOP, 0.080 ms at 67 TFLOP/s): bound
// by operations. The backward's reads dy, dh, a, x, B, C, h0 and writes
// da, dxdt, dB, dC, dh0 (213.9 MB, 0.064 ms) and does 14 P N flops a step
// (15.03 GFLOP, 0.224 ms): bound by operations. This design is latency
// bound: one block an SM walks 2,048 dependent steps, and in the backward
// each step reduces 2 N / 4 values over the warp by shuffles. The chunked
// SSD matrix form on the tensor cores is the redesign (ROADMAP B).
//
// Templated on N in {16, 32, 64} (64 is zamba2's ssm_state, 16 the
// reduced config's); P is 64 (models/mamba2.py: HEAD_DIM). The checkpoint
// interval kCk is owned by kernels/ref.py (MAMBA2_CKPT), which sizes the
// states: the wrapper passes it as `ckpt` and the entries refuse any
// other value. The C entries return cudaGetLastError() after each launch;
// the Python wrapper (kernels/mamba2_scan.py) raises when it is not 0.

#include "common.cuh"

namespace {

constexpr int kCk = 64;       // steps a segment; the entries check `ckpt`
constexpr int kP = 64;        // the head dim
constexpr int kT = 256;       // threads a block: 64 rows x 4 threads
constexpr int kSub = 4;       // the backward's states held in shared memory
constexpr int kWarps = kT / 32;
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// Staging: asynchronous copies global -> shared (cp.async, sm_80+).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// sm[t] = a[b, t0 + t, h] for t < T
__device__ __forceinline__ void stage_a(float* sm, const float* a, int b,
                                        int h, int t0, int T, int S, int H) {
  for (int e = threadIdx.x; e < T; e += kT)
    cp_async4(sm + e, a + (static_cast<size_t>(b) * S + t0 + e) * H + h);
}

// sm[t * kP + p] = x[b, t0 + t, h, p] for t < T (rows of kP floats are
// 16-byte aligned)
__device__ __forceinline__ void stage_rows(float* sm, const float* x, int b,
                                           int h, int t0, int T, int S,
                                           int H) {
  for (int e = threadIdx.x; e < T * (kP / 4); e += kT) {
    const int t = e / (kP / 4), c = (e % (kP / 4)) * 4;
    cp_async16(sm + t * kP + c,
               x + ((static_cast<size_t>(b) * S + t0 + t) * H + h) * kP + c);
  }
}

// sm[t * N + n] = m[b, t0 + t, n] for t < T
template <int N>
__device__ __forceinline__ void stage_bc(float* sm, const float* m, int b,
                                         int t0, int T, int S) {
  for (int e = threadIdx.x; e < T * (N / 4); e += kT) {
    const int t = e / (N / 4), c = (e % (N / 4)) * 4;
    cp_async16(sm + t * N + c,
               m + (static_cast<size_t>(b) * S + t0 + t) * N + c);
  }
}

// h <- a h + x B over a thread's NPT columns, each product and the sum
// rounded alone (the plain version's elementwise order)
template <int NPT>
__device__ __forceinline__ void step(float (&h)[NPT], float at, float xt,
                                     const float* bt) {
#pragma unroll
  for (int i = 0; i < NPT; i += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(bt + i);
    h[i] = __fadd_rn(__fmul_rn(at, h[i]), __fmul_rn(xt, bv.x));
    h[i + 1] = __fadd_rn(__fmul_rn(at, h[i + 1]), __fmul_rn(xt, bv.y));
    h[i + 2] = __fadd_rn(__fmul_rn(at, h[i + 2]), __fmul_rn(xt, bv.z));
    h[i + 3] = __fadd_rn(__fmul_rn(at, h[i + 3]), __fmul_rn(xt, bv.w));
  }
}

template <int NPT>
__device__ __forceinline__ void load_row(float (&v)[NPT], const float* src) {
#pragma unroll
  for (int i = 0; i < NPT; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + i);
    v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
  }
}

template <int NPT>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[NPT]) {
#pragma unroll
  for (int i = 0; i < NPT; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// a thread's NPT values as NPT / 4 float4s at stride kT (a warp's lanes on
// consecutive 16-byte words: no bank conflict, coalesced in global memory)
template <int NPT>
__device__ __forceinline__ void store_own(float4* dst, const float (&v)[NPT]) {
#pragma unroll
  for (int i = 0; i < NPT; i += 4)
    dst[(i / 4) * kT + threadIdx.x] =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int NPT>
__device__ __forceinline__ void load_own(float (&v)[NPT], const float4* src) {
#pragma unroll
  for (int i = 0; i < NPT; i += 4) {
    const float4 f = src[(i / 4) * kT + threadIdx.x];
    v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int N>
struct FwdSmem {
  static constexpr int buf = kCk * (1 + kP + 2 * N);  // a, x, B, C (floats)
  static constexpr size_t bytes = 2 * buf * sizeof(float);
};

template <int N>
__device__ __forceinline__ void stage_fwd(float* buf, const float* a,
                                          const float* x, const float* Bm,
                                          const float* Cm, int b, int h,
                                          int t0, int T, int S, int H) {
  stage_a(buf, a, b, h, t0, T, S, H);
  stage_rows(buf + kCk, x, b, h, t0, T, S, H);
  stage_bc<N>(buf + kCk * (1 + kP), Bm, b, t0, T, S);
  stage_bc<N>(buf + kCk * (1 + kP + N), Cm, b, t0, T, S);
}

template <int N>
__global__ void __launch_bounds__(kT, 1)
    mamba2_fwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_final,
                      float* __restrict__ states, int S, int H, int NC) {
  constexpr int NPT = N / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int p = threadIdx.x >> 2, n0 = (threadIdx.x & 3) * NPT;
  const bool lead = (threadIdx.x & 3) == 0;
  const size_t row = (static_cast<size_t>(bh) * kP + p) * N + n0;

  float hs[NPT];
  load_row<NPT>(hs, h0 + row);
  stage_fwd<N>(smem, a, x, Bm, Cm, b, h, 0, min(kCk, S), S, H);
  cp_async_commit();
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * kCk, T = min(kCk, S - t0);
    if (c + 1 < NC)
      stage_fwd<N>(smem + ((c + 1) & 1) * FwdSmem<N>::buf, a, x, Bm, Cm, b,
                   h, t0 + kCk, min(kCk, S - t0 - kCk), S, H);
    cp_async_commit();  // possibly empty: segment c is then one group back
    cp_async_wait<1>();
    __syncthreads();
    store_row<NPT>(states + (static_cast<size_t>(bh) * NC + c) * kP * N +
                       p * N + n0,
                   hs);
    const float* as = smem + (c & 1) * FwdSmem<N>::buf;
    const float* xs = as + kCk;
    const float* bs = xs + kCk * kP;
    const float* cs = bs + kCk * N;
    for (int k = 0; k < T; ++k) {
      step<NPT>(hs, as[k], xs[k * kP + p], bs + k * N + n0);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; i += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + k * N + n0 + i);
        acc = fmaf(hs[i], cv.x, acc);
        acc = fmaf(hs[i + 1], cv.y, acc);
        acc = fmaf(hs[i + 2], cv.z, acc);
        acc = fmaf(hs[i + 3], cv.w, acc);
      }
      acc += __shfl_xor_sync(kAll, acc, 1);
      acc += __shfl_xor_sync(kAll, acc, 2);
      if (lead)
        y[((static_cast<size_t>(b) * S + t0 + k) * H + h) * kP + p] = acc;
    }
    __syncthreads();  // the buffer is free before segment c + 2 is staged
  }
  store_row<NPT>(h_final + row, hs);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <int N>
struct BwdSmem {
  static constexpr int stage = kCk * (1 + 2 * kP + 2 * N);  // a, x, dy, B, C
  static constexpr int hist = kSub * kP * N;                // kSub states
  static constexpr int part = kSub * kWarps * N;            // dB or dC
  static constexpr size_t bytes =
      (stage + hist + 2 * part + kSub * kWarps) * sizeof(float);
};

template <int N>
__global__ void __launch_bounds__(kT, 1)
    mamba2_bwd_kernel(const float* __restrict__ dy,
                      const float* __restrict__ dh,
                      const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ states,
                      float* __restrict__ da, float* __restrict__ dx,
                      float* __restrict__ dBp, float* __restrict__ dCp,
                      float* __restrict__ dh0, float4* __restrict__ scratch,
                      int S, int H, int NC) {
  constexpr int NPT = N / 4;
  using L = BwdSmem<N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* as = smem;
  float* xs = as + kCk;
  float* dys = xs + kCk * kP;
  float* bs = dys + kCk * kP;
  float* cs = bs + kCk * N;
  float4* hist = reinterpret_cast<float4*>(smem + L::stage);
  float* pB = smem + L::stage + L::hist;
  float* pC = pB + L::part;
  float* pA = pC + L::part;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int p = threadIdx.x >> 2, n0 = (threadIdx.x & 3) * NPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (static_cast<size_t>(bh) * kP + p) * N + n0;
  // this block's scratch: the state entering each of a segment's
  // kCk / kSub sub-segments, NPT / 4 float4s a thread at stride kT
  float4* scr = scratch + static_cast<size_t>(bh) * (kCk / kSub) * (NPT / 4) * kT;

  float G[NPT];
  load_row<NPT>(G, dh + row);
  for (int c = NC - 1; c >= 0; --c) {
    const int t0 = c * kCk, T = min(kCk, S - t0);
    __syncthreads();  // the previous segment's readers are done
    stage_a(as, a, b, h, t0, T, S, H);
    stage_rows(xs, x, b, h, t0, T, S, H);
    stage_rows(dys, dy, b, h, t0, T, S, H);
    stage_bc<N>(bs, Bm, b, t0, T, S);
    stage_bc<N>(cs, Cm, b, t0, T, S);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // the segment forward from its saved state, keeping the state
    // entering every sub-segment (each thread its own values)
    float hs[NPT];
    load_row<NPT>(hs, states + (static_cast<size_t>(bh) * NC + c) * kP * N +
                          p * N + n0);
    for (int k = 0; k < T; ++k) {
      if (k % kSub == 0) store_own<NPT>(scr + (k / kSub) * (NPT / 4) * kT, hs);
      step<NPT>(hs, as[k], xs[k * kP + p], bs + k * N + n0);
    }

    for (int s = (T - 1) / kSub; s >= 0; --s) {
      const int k0 = s * kSub, len = min(kSub, T - k0);
      load_own<NPT>(hs, scr + s * (NPT / 4) * kT);
      for (int j = 0; j < len; ++j) {  // h_{t-1} of each step
        store_own<NPT>(hist + j * (NPT / 4) * kT, hs);
        step<NPT>(hs, as[k0 + j], xs[(k0 + j) * kP + p], bs + (k0 + j) * N + n0);
      }
      for (int j = len - 1; j >= 0; --j) {
        const int k = k0 + j;
        const float at = as[k], xt = xs[k * kP + p], dyt = dys[k * kP + p];
        const float* bt = bs + k * N + n0;
        const float* ct = cs + k * N + n0;
        float hp[NPT], pb[NPT], pc[NPT];
        load_own<NPT>(hp, hist + j * (NPT / 4) * kT);
        float sx = 0.f, sa = 0.f;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const float bi = bt[i], ci = ct[i];
          const float ht = __fadd_rn(__fmul_rn(at, hp[i]), __fmul_rn(xt, bi));
          G[i] = __fadd_rn(G[i], __fmul_rn(dyt, ci));
          pc[i] = ht * dyt;
          pb[i] = G[i] * xt;
          sx = fmaf(G[i], bi, sx);
          sa = fmaf(G[i], hp[i], sa);
        }
        sx += __shfl_xor_sync(kAll, sx, 1);
        sx += __shfl_xor_sync(kAll, sx, 2);
        if ((threadIdx.x & 3) == 0)
          dx[((static_cast<size_t>(b) * S + t0 + k) * H + h) * kP + p] = sx;
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            pb[i] += __shfl_xor_sync(kAll, pb[i], m);
            pc[i] += __shfl_xor_sync(kAll, pc[i], m);
          }
        }
#pragma unroll
        for (int m = 1; m < 32; m <<= 1) sa += __shfl_xor_sync(kAll, sa, m);
        if (lane < 4) {  // row 0 of the warp: its columns n0 .. n0 + NPT
          store_row<NPT>(pB + (j * kWarps + warp) * N + n0, pb);
          store_row<NPT>(pC + (j * kWarps + warp) * N + n0, pc);
        }
        if (lane == 0) pA[j * kWarps + warp] = sa;
#pragma unroll
        for (int i = 0; i < NPT; ++i) G[i] = __fmul_rn(at, G[i]);
      }
      __syncthreads();
      // the warps' sums in warp order
      for (int e = threadIdx.x; e < len * N; e += kT) {
        const int j = e / N, n = e % N;
        float sb = pB[j * kWarps * N + n], sc = pC[j * kWarps * N + n];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          sb += pB[(j * kWarps + w) * N + n];
          sc += pC[(j * kWarps + w) * N + n];
        }
        const size_t o =
            ((static_cast<size_t>(b) * S + t0 + k0 + j) * H + h) * N + n;
        dBp[o] = sb;
        dCp[o] = sc;
      }
      if (threadIdx.x < len) {
        const int j = threadIdx.x;
        float sa = pA[j * kWarps];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sa += pA[j * kWarps + w];
        da[(static_cast<size_t>(b) * S + t0 + k0 + j) * H + h] = sa;
      }
      __syncthreads();  // the partials and h_{t-1} slots are free again
    }
  }
  store_row<NPT>(dh0 + row, G);
}

// dB[b, t, n] = sum_h dBp[b, t, h, n] (and dC), heads in order
__global__ void __launch_bounds__(kT)
    mamba2_bwd_heads_kernel(const float* __restrict__ dBp,
                            const float* __restrict__ dCp,
                            float* __restrict__ dB, float* __restrict__ dC,
                            long long rows, int H, int N) {
  const long long total = rows * N;
  for (long long e = blockIdx.x * static_cast<long long>(kT) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kT) {
    const long long r = e / N;
    const int n = static_cast<int>(e % N);
    const float* pb = dBp + r * H * N + n;
    const float* pc = dCp + r * H * N + n;
    float sb = pb[0], sc = pc[0];
    for (int h = 1; h < H; ++h) {
      sb += pb[static_cast<size_t>(h) * N];
      sc += pc[static_cast<size_t>(h) * N];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
}

bool valid(int B, int S, int H, int P, int ckpt) {
  return B >= 1 && S >= 1 && H >= 1 && P == kP && ckpt == kCk &&
         static_cast<long long>(B) * H < (1LL << 31);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// a: (B, S, H) f32; x: (B, S, H, P) f32; Bm, Cm: (B, S, N) f32; h0: (B,
// H, P, N) f32; ckpt: kernels/ref.py's MAMBA2_CKPT (must equal kCk).
// Writes y (B, S, H, P), h_final (B, H, P, N) and states (B, H, ceil(S /
// ckpt), P, N), all f32. One launch on the stream.
extern "C" int mamba2_fwd(int N, int ckpt, const void* a, const void* x,
                          const void* Bm, const void* Cm, const void* h0,
                          void* y, void* h_final, void* states, int B, int S,
                          int H, int P, void* stream) {
  if (!valid(B, S, H, P, ckpt)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
  const int NC = (S + kCk - 1) / kCk;
  int err = 0;
#define REPRO_MAMBA2_FWD(NN)                                                  \
  {                                                                           \
    err = set_smem(mamba2_fwd_kernel<NN>, FwdSmem<NN>::bytes);                \
    if (err != 0) return err;                                                 \
    mamba2_fwd_kernel<NN><<<B * H, kT, FwdSmem<NN>::bytes, st>>>(             \
        f(a), f(x), f(Bm), f(Cm), f(h0), o(y), o(h_final), o(states), S, H,   \
        NC);                                                                  \
  }
  switch (N) {
    case 16: REPRO_MAMBA2_FWD(16); break;
    case 32: REPRO_MAMBA2_FWD(32); break;
    case 64: REPRO_MAMBA2_FWD(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_MAMBA2_FWD
  return cudaGetLastError();
}

// dy: (B, S, H, P) f32; dh: (B, H, P, N) f32, the gradient of h_final; a,
// x, Bm, Cm, states as mamba2_fwd took and wrote them; dBp, dCp: (B, S,
// H, N) f32 scratch (the per-head partials); scratch: (B * H, ckpt /
// kSub, P, N) f32. Writes da (B, S, H), dx (B, S, H, P), dB, dC (B, S,
// N) and dh0 (B, H, P, N), all f32. Two launches on the stream: the
// recurrence, then the sum over the heads.
extern "C" int mamba2_bwd(int N, int ckpt, const void* dy, const void* dh,
                          const void* a, const void* x, const void* Bm,
                          const void* Cm, const void* states, void* da,
                          void* dx, void* dB, void* dC, void* dh0, void* dBp,
                          void* dCp, void* scratch, int B, int S, int H,
                          int P, void* stream) {
  if (!valid(B, S, H, P, ckpt)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
  const int NC = (S + kCk - 1) / kCk;
  int err = 0;
#define REPRO_MAMBA2_BWD(NN)                                                  \
  {                                                                           \
    err = set_smem(mamba2_bwd_kernel<NN>, BwdSmem<NN>::bytes);                \
    if (err != 0) return err;                                                 \
    mamba2_bwd_kernel<NN><<<B * H, kT, BwdSmem<NN>::bytes, st>>>(             \
        f(dy), f(dh), f(a), f(x), f(Bm), f(Cm), f(states), o(da), o(dx),      \
        o(dBp), o(dCp), o(dh0), static_cast<float4*>(scratch), S, H, NC);     \
  }
  switch (N) {
    case 16: REPRO_MAMBA2_BWD(16); break;
    case 32: REPRO_MAMBA2_BWD(32); break;
    case 64: REPRO_MAMBA2_BWD(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_MAMBA2_BWD
  err = cudaGetLastError();
  if (err != 0) return err;
  const long long rows = static_cast<long long>(B) * S;
  const long long want = (rows * N + kT - 1) / kT;
  const long long blocks =
      want < repro_torch::kMaxBlocks ? want : repro_torch::kMaxBlocks;
  mamba2_bwd_heads_kernel<<<static_cast<int>(blocks), kT, 0, st>>>(
      f(dBp), f(dCp), o(dB), o(dC), rows, H, N);
  return cudaGetLastError();
}
