// The RWKV-6 recurrence for Hopper (sm_90a), forward and backward, bound
// with ctypes.
//
// rwkv6_fwd replaces the JAX package's kernels/rwkv6_scan.py: rwkv6_scan
// (Pallas, src/repro/kernels/rwkv6_scan.py:49). Per (batch, head), with
// the state S (hd, hd) f32:
//   y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t.
// It writes y (B, S, H, hd) f32, s_final (B, H, hd, hd) f32 and, for the
// backward, the state entering every kCk-th step (states, (B, H,
// ceil(S / kCk), hd, hd) f32, s0 first).
// rwkv6_bwd replaces what the TPU path has no kernel for: the XLA
// autodiff of models/rwkv6.py's scan (src/repro/models/rwkv6.py:119).
// With G the adjoint of the state after step t, walking time backward:
//   dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t
//   dk_t = r_t * u * (dy_t . v_t) + G v_t
//   dv_t = (sum_i r_i u_i k_i) dy_t + G^T k_t
//   dw_t = rowsum(G * S_{t-1}),   du += r_t * k_t * (dy_t . v_t)
//   G   <- diag(w_t) G + r_t^T dy_t,   and ds0 = G at the end.
// (kernels/ref.py: rwkv6_scan_ref, rwkv6_scan_bwd_ref.)
//
// Design. The (b, h) recurrences are independent and each is serial in
// time, so one block runs one (b, h) and walks its S steps. In the
// forward, column j of S depends only on v_t[j] (S[i][j] <- w_i S[i][j]
// + k_i v_j) and y_t[j] sums over i only, so thread j keeps column j in
// registers: no reduction across threads ("one thread per channel", the
// CUDA wkv6 design the Pallas kernel's docstring names). Each segment of
// kCk steps of r, k, w, v is staged in shared memory by one coalesced
// load a step, so a step costs no barrier.
//
// The backward is one launch of two kinds of block (blockIdx.y):
//   rows    (y = 0): thread i owns row i of S and of G. dr, dk, dw and du
//           reduce over j, which is inside the thread; the row of S_{t-1}
//           is recomputed forward from the segment's saved state (never
//           by dividing by w: the decay reaches exp(-exp(4)) ~ 2e-24) into
//           a per-block scratch of kCk states, then read back in reverse.
//           Thread i writes and reads only its own elements of the
//           scratch, so it needs no barrier.
//   columns (y = 1): thread j owns column j of G, which needs no S at all;
//           dv reduces over i, inside the thread.
// du is written per (b, h) (B, H, hd); where u is shared, autograd sums
// it over b (kernels/rwkv6_scan.py expands u once). Nothing is
// accumulated across blocks and no atomics are used, so each launch is
// deterministic: the port's chunked == per-round contract holds bitwise.
//
// Bound. At (B 2, S 2048, H 40, hd 64) the forward's function reads r,
// k, v, w and s0 and writes y and s_final (212 MB, 0.063 ms at 3.35
// TB/s) and needs 5 hd^2 + O(hd) f32 flops a step per (b, h) (3.4 GFLOP,
// 0.050 ms at 67 TFLOP/s): bound by bytes (chip_smoke.py: time_rwkv6
// counts both kernels; the saved states are this design's, not the
// function's, and are not counted). This first design is latency-bound
// instead: 80 blocks of 64 threads (2 warps on 80 of 132 SMs) each walk
// a 2048-step chain. Left for later PRs: the chunked (matrix) form of
// the recurrence on the tensor cores, which trades the serial chain for
// intra-chunk products.
//
// Templated on hd in {16, 32, 64} (64 is the model's HEAD_DIM; 16 is the
// Pallas kernel's test width). The checkpoint interval kCk is owned by
// kernels/ref.py (RWKV6_CKPT), which sizes the states and the scratch:
// the wrapper passes it as `ckpt` and the entries refuse any other value.
// The C entries return cudaGetLastError() after the launch; the Python
// wrapper (kernels/rwkv6_scan.py) raises when it is not 0.

#include "common.cuh"

namespace {

constexpr int kCk = 16;  // steps a segment; the entries check `ckpt`

// offset of element (b, t, h, 0) of a (B, S, H, HD) tensor
template <int HD>
__device__ __forceinline__ size_t at(int b, int t, int h, int S, int H) {
  return ((static_cast<size_t>(b) * S + t) * H + h) * HD;
}

template <int HD>
__device__ __forceinline__ size_t mat(int bh) {  // offset of (bh, 0, 0)
  return static_cast<size_t>(bh) * HD * HD;
}

// sm[s][c] = x[b, t0 + s, h, c] for s < L: thread c loads element c
template <int HD>
__device__ __forceinline__ void stage(float (*sm)[HD], const float* x,
                                      int b, int t0, int L, int h, int S,
                                      int H, int c) {
  for (int s = 0; s < L; ++s) sm[s][c] = x[at<HD>(b, t0 + s, h, S, H) + c];
}

template <int HD>
__global__ void __launch_bounds__(HD)
    rwkv6_fwd_kernel(const float* __restrict__ r,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, float* __restrict__ y,
                     float* __restrict__ s_final,
                     float* __restrict__ states, int S, int H) {
  __shared__ float sr[kCk][HD], sk[kCk][HD], sw[kCk][HD], sv[kCk][HD];
  __shared__ float su[HD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int NC = (S + kCk - 1) / kCk;
  float col[HD];  // column j of S
#pragma unroll
  for (int i = 0; i < HD; ++i) col[i] = s0[mat<HD>(bh) + i * HD + j];
  su[j] = u[static_cast<size_t>(bh) * HD + j];
  for (int g = 0; g < NC; ++g) {
    const int t0 = g * kCk, L = min(kCk, S - t0);
    float* sp = states + (static_cast<size_t>(bh) * NC + g) * HD * HD;
#pragma unroll
    for (int i = 0; i < HD; ++i) sp[i * HD + j] = col[i];
    __syncthreads();  // the previous segment's reads are done
    stage<HD>(sr, r, b, t0, L, h, S, H, j);
    stage<HD>(sk, k, b, t0, L, h, S, H, j);
    stage<HD>(sw, w, b, t0, L, h, S, H, j);
    stage<HD>(sv, v, b, t0, L, h, S, H, j);
    __syncthreads();
    for (int s = 0; s < L; ++s) {
      const float vj = sv[s][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = sk[s][i] * vj;
        acc += sr[s][i] * (col[i] + su[i] * kv);
        col[i] = sw[s][i] * col[i] + kv;
      }
      y[at<HD>(b, t0 + s, h, S, H) + j] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_final[mat<HD>(bh) + i * HD + j] = col[i];
}

// Thread i: row i of S and G; dr, dk, dw, du and row i of ds0.
template <int HD>
__device__ void bwd_rows(const float* __restrict__ dy,
                         const float* __restrict__ ds,
                         const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ states,
                         float* __restrict__ dr, float* __restrict__ dk,
                         float* __restrict__ dw, float* __restrict__ du,
                         float* __restrict__ ds0, float* __restrict__ scr,
                         const float* su, float (*sr)[HD], float (*sk)[HD],
                         float (*sw)[HD], float (*sv)[HD],
                         float (*sdy)[HD], int S, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, i = threadIdx.x;
  const int NC = (S + kCk - 1) / kCk;
  float G[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) G[j] = ds[mat<HD>(bh) + i * HD + j];
  float du_acc = 0.f;
  for (int g = NC - 1; g >= 0; --g) {
    const int t0 = g * kCk, L = min(kCk, S - t0);
    __syncthreads();  // the previous segment's reads are done
    stage<HD>(sr, r, b, t0, L, h, S, H, i);
    stage<HD>(sk, k, b, t0, L, h, S, H, i);
    stage<HD>(sw, w, b, t0, L, h, S, H, i);
    stage<HD>(sv, v, b, t0, L, h, S, H, i);
    stage<HD>(sdy, dy, b, t0, L, h, S, H, i);
    __syncthreads();
    {  // recompute: scr[s][j][i] = row i of the state entering t0 + s
      const float* sp = states + (static_cast<size_t>(bh) * NC + g) * HD * HD;
      float row[HD];
#pragma unroll
      for (int j = 0; j < HD; ++j) row[j] = sp[i * HD + j];
      for (int s = 0; s < L; ++s) {
        const float ki = sk[s][i], wi = sw[s][i];
#pragma unroll
        for (int j = 0; j < HD; ++j) {
          scr[(s * HD + j) * HD + i] = row[j];
          const float kv = ki * sv[s][j];
          row[j] = wi * row[j] + kv;
        }
      }
    }
    const float ui = su[i];
    for (int s = L - 1; s >= 0; --s) {
      const float ri = sr[s][i], ki = sk[s][i], wi = sw[s][i];
      float dyv = 0.f, drs = 0.f, dks = 0.f, dws = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        const float sj = scr[(s * HD + j) * HD + i];
        const float dyj = sdy[s][j], vj = sv[s][j];
        dyv += dyj * vj;
        drs += sj * dyj;
        dks += G[j] * vj;
        dws += G[j] * sj;
        G[j] = wi * G[j] + ri * dyj;
      }
      const size_t o = at<HD>(b, t0 + s, h, S, H) + i;
      dr[o] = drs + ui * ki * dyv;
      dk[o] = ri * ui * dyv + dks;
      dw[o] = dws;
      du_acc += ri * ki * dyv;
    }
  }
  du[static_cast<size_t>(bh) * HD + i] = du_acc;
#pragma unroll
  for (int j = 0; j < HD; ++j) ds0[mat<HD>(bh) + i * HD + j] = G[j];
}

// Thread j: column j of G; dv.
template <int HD>
__device__ void bwd_cols(const float* __restrict__ dy,
                         const float* __restrict__ ds,
                         const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ w,
                         float* __restrict__ dv, const float* su,
                         float (*sr)[HD], float (*sk)[HD], float (*sw)[HD],
                         float (*sdy)[HD], int S, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int NC = (S + kCk - 1) / kCk;
  float G[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) G[i] = ds[mat<HD>(bh) + i * HD + j];
  for (int g = NC - 1; g >= 0; --g) {
    const int t0 = g * kCk, L = min(kCk, S - t0);
    __syncthreads();
    stage<HD>(sr, r, b, t0, L, h, S, H, j);
    stage<HD>(sk, k, b, t0, L, h, S, H, j);
    stage<HD>(sw, w, b, t0, L, h, S, H, j);
    stage<HD>(sdy, dy, b, t0, L, h, S, H, j);
    __syncthreads();
    for (int s = L - 1; s >= 0; --s) {
      const float dyj = sdy[s][j];
      float c = 0.f, acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float ri = sr[s][i], ki = sk[s][i];
        c += ri * su[i] * ki;
        acc += G[i] * ki;
        G[i] = sw[s][i] * G[i] + ri * dyj;
      }
      dv[at<HD>(b, t0 + s, h, S, H) + j] = c * dyj + acc;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(HD)
    rwkv6_bwd_kernel(const float* dy, const float* ds, const float* r,
                     const float* k, const float* v, const float* w,
                     const float* u, const float* states, float* dr,
                     float* dk, float* dv, float* dw, float* du, float* ds0,
                     float* scratch, int S, int H) {
  __shared__ float sr[kCk][HD], sk[kCk][HD], sw[kCk][HD], sv[kCk][HD],
      sdy[kCk][HD];
  __shared__ float su[HD];
  const int bh = blockIdx.x;
  su[threadIdx.x] = u[static_cast<size_t>(bh) * HD + threadIdx.x];
  if (blockIdx.y == 0) {
    bwd_rows<HD>(dy, ds, r, k, v, w, states, dr, dk, dw, du, ds0,
                 scratch + static_cast<size_t>(bh) * kCk * HD * HD, su, sr,
                 sk, sw, sv, sdy, S, H);
  } else {
    bwd_cols<HD>(dy, ds, r, k, w, dv, su, sr, sk, sw, sdy, S, H);
  }
}

bool valid(int B, int S, int H, int ckpt) {
  return B > 0 && S > 0 && H > 0 && ckpt == kCk;
}

}  // namespace

// r, k, v, w: (B, S, H, hd) f32; u: (B, H, hd) f32 (one row per batch
// row); s0: (B, H, hd, hd) f32; ckpt: the caller's checkpoint interval,
// which must be kCk. Writes y (B, S, H, hd), s_final (B, H, hd, hd) and
// states (B, H, ceil(S / ckpt), hd, hd), all f32.
extern "C" int rwkv6_fwd(int hd, int ckpt, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const void* s0, void* y, void* s_final,
                         void* states, int B, int S, int H, void* stream) {
  if (!valid(B, S, H, ckpt)) return cudaErrorInvalidValue;
  const dim3 grid(B * H);
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define REPRO_RWKV6_FWD(HD)                                                  \
  rwkv6_fwd_kernel<HD><<<grid, HD, 0, st>>>(                                 \
      f(r), f(k), f(v), f(w), f(u), f(s0), static_cast<float*>(y),           \
      static_cast<float*>(s_final), static_cast<float*>(states), S, H)
  switch (hd) {
    case 16: REPRO_RWKV6_FWD(16); break;
    case 32: REPRO_RWKV6_FWD(32); break;
    case 64: REPRO_RWKV6_FWD(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RWKV6_FWD
  return cudaGetLastError();
}

// dy: (B, S, H, hd) f32; ds: (B, H, hd, hd) f32; r, k, v, w, u, states as
// rwkv6_fwd took and wrote them; scratch: (B * H, ckpt, hd, hd) f32; ckpt
// as for rwkv6_fwd. Writes dr, dk, dv, dw (B, S, H, hd), du (B, H, hd) per
// batch row and ds0 (B, H, hd, hd), all f32.
extern "C" int rwkv6_bwd(int hd, int ckpt, const void* dy,
                         const void* ds, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const void* states,
                         void* dr, void* dk, void* dv, void* dw, void* du,
                         void* ds0, void* scratch, int B, int S, int H,
                         void* stream) {
  if (!valid(B, S, H, ckpt)) return cudaErrorInvalidValue;
  const dim3 grid(B * H, 2);
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
#define REPRO_RWKV6_BWD(HD)                                                  \
  rwkv6_bwd_kernel<HD><<<grid, HD, 0, st>>>(                                 \
      f(dy), f(ds), f(r), f(k), f(v), f(w), f(u), f(states), o(dr), o(dk),   \
      o(dv), o(dw), o(du), o(ds0), o(scratch), S, H)
  switch (hd) {
    case 16: REPRO_RWKV6_BWD(16); break;
    case 32: REPRO_RWKV6_BWD(32); break;
    case 64: REPRO_RWKV6_BWD(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RWKV6_BWD
  return cudaGetLastError();
}
