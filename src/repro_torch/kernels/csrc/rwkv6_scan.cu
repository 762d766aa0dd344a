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
// Design. Both directions are chunk-parallel over segments of L = kCk
// steps: segment c covers t0 = c L .. t0 + L - 1.
//
// The forward's only serial dependence is the state at segment
// boundaries: with S_c the state entering segment c,
//   S_{c+1} = diag(W_c) S_c + sum_t diag(Q_t) k_t^T v_t,
//   W_c = prod_t w_t,   Q_t = prod_{t<tau<t0+L} w_tau.
// Two launches:
//   1. rwkv6_fwd_scan_kernel, one block per (b, h, group of 16 columns
//      of S): column j of S depends only on v[:, j], so a recurrence's
//      column groups scan side by side with no exchange (320 blocks at the
//      main shape, against 80 chains of 2048 steps before). Each thread
//      keeps 4 rows of one column in registers, writes S_c to states[c]
//      (the tensor the backward restarts from) and forms the segment's
//      sum, which does not depend on S_c: the serial part is one
//      multiply-add an element a segment. cp.async stages k, w and the
//      block's columns of v three segments ahead;
//   2. rwkv6_fwd_seg_kernel, one block per (b, h, c): y of the segment
//      from S_c in matrix form,
//        y_t = (r_t P_t) S_c + sum_{s<t} A[t][s] v_s + A[t][t] v_t,
//        P_t = prod_{t0<=tau<t} w_tau,
//        A[t][s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i],
//        A[t][t] = sum_i r_t[i] u[i] k_t[i],
//      an (L x hd)(hd x hd) product, the L x L matrix A and an (L x L)(L
//      x hd) product. B H ceil(S/L) units: 10,240 at the main shape.
//
// The backward's only serial dependence is the adjoint G at segment
// boundaries: with G_e(c) the adjoint of the state leaving segment c,
//   G_e(c - 1) = diag(W_c) G_e(c) + Delta_c,   W_c = prod_t w_t,
//   Delta_c = sum_t diag(prod_{t0<=tau<t} w_tau) r_t^T dy_t.
// Two launches:
//   1. rwkv6_bwd_scan_kernel, one block per (b, h): the scan over the
//      segments only (128 at S = 2048, against 2048 steps before), from
//      d(s_final) to ds0, writing G_e(c) for every segment. Each
//      segment's Delta_c (an (hd x L)(L x hd) product), W_c and du's part
//      are formed on the fly from its inputs, which cp.async stages while
//      the segment before is computed;
//   2. rwkv6_bwd_seg_kernel, one block per (b, h, c): dr, dk, dv, dw of
//      the segment from its saved state and G_e(c), in matrix form (the
//      kernel's note): three (hd x hd)(hd x L) products (S0 dy^T, G_e
//      v^T, (k Q) G_e), the L x L Gram matrix v dy^T and, per row i, sums
//      over pairs and triples of steps weighted by decay products. No
//      per-step state is ever formed, so no history of L states (256 KB
//      a unit at hd 64) is kept anywhere. B H ceil(S/L) units: 10,240 at
//      the main shape, against 80 serial chains before.
// In both directions every decay product is a running product (never a
// division by w, never a difference of log-sums): the decay reaches
// exp(-exp(4)) ~ 2e-24, a product over a few steps underflows to 0, and
// that 0 is right. A segment's inputs and saved states are staged into
// shared memory by cp.async (the backward's rows padded to hd + 1 floats,
// so a warp reading a column hits 32 banks). A ragged last segment is
// padded with steps that change nothing (r = k = v = dy = 0, w = 1). du is written per (b, h)
// (B, H, hd); where u is shared, autograd sums it over b
// (kernels/rwkv6_scan.py expands u once). Nothing is accumulated across
// blocks and no atomics are used; every sum runs in a fixed order, so
// each call is deterministic: the port's chunked == per-round contract
// holds bitwise.
//
// Bound. At (B 2, S 2048, H 40, hd 64) the forward's function reads r,
// k, v, w and s0 and writes y and s_final (212 MB, 0.063 ms at 3.35
// TB/s) and needs 5 hd^2 + O(hd) f32 flops a step per (b, h) (3.4 GFLOP,
// 0.050 ms at 67 TFLOP/s): bound by bytes (chip_smoke.py: time_rwkv6
// counts both kernels; the saved states are this design's, not the
// function's, and are not counted). The forward's design moves more: pass
// 1 reads k, v, w (126 MB) and writes the states (168 MB); pass 2 reads
// r, k, v, w and the states (336 MB) and writes y (42 MB): 0.67 GB, 0.20
// ms at 3.35 TB/s, beside about 3.5 GFLOP (0.05 ms), so its bound is its
// own bytes, 3.2x the function's (time_rwkv6 prints both). Pass 1's
// column groups read k and w once each (from L2 after the first). The
// backward's function moves 381.5 MB and needs 7.55 GFLOP (time_rwkv6:
// 0.114 ms, bytes). Its design moves more: pass 1 reads r, k, v, w, dy
// (210 MB) and writes G_e (168 MB, B H ceil(S/L) hd^2 f32); pass 2 reads
// the five inputs, the saved states and G_e (546 MB) and writes dr, dk,
// dv, dw (168 MB): 1.09 GB, 0.33 ms at 3.35 TB/s, beside about 7 GFLOP
// (0.10 ms), so the design's bound is its own bytes, 2.9x the function's.
// Neither backward pass reaches it: pass 1 runs 80 blocks (one a
// recurrence) on 80 of 132 SMs and its 128 segments' sums follow one
// another in each, so it waits on each segment's compute (its staging is
// hidden); pass 2 issues more shared-memory loads and multiply-adds per
// unit than its bytes take to stream. The device times are in PERF.md.
//
// Templated on hd in {16, 32, 64} (64 is the model's HEAD_DIM; 16 is the
// Pallas kernel's test width). The checkpoint interval kCk is owned by
// kernels/ref.py (RWKV6_CKPT), which sizes the states and the scratch:
// the wrapper passes it as `ckpt` and the entries refuse any other value.
// The C entries return cudaGetLastError() after each launch; the Python
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

// ---------------------------------------------------------------------------
// Staging: asynchronous copies global -> shared (cp.async, sm_80+).
// ---------------------------------------------------------------------------

// one 4-byte asynchronous copy global -> shared (sm_80+)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sm[t * (HD + 1) + c] = x[b, t0 + t, h, c] for t < Lc, `fill` for
// Lc <= t < kCk: a ragged segment is padded with steps that change
// nothing (r = k = v = dy = 0, w = 1). Rows are padded to HD + 1 floats so
// a warp reading one column of 32 rows hits 32 banks.
template <int HD>
__device__ __forceinline__ void stage_seg(float* sm, const float* x, int b,
                                          int t0, int Lc, int h, int S,
                                          int H, float fill) {
  for (int e = threadIdx.x; e < kCk * HD; e += blockDim.x) {
    const int t = e / HD, c = e % HD;
    if (t < Lc)
      cp_async4(sm + t * (HD + 1) + c, x + at<HD>(b, t0 + t, h, S, H) + c);
    else
      sm[t * (HD + 1) + c] = fill;
  }
}

// one 16-byte asynchronous copy global -> shared, through L2 only
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// sm[t * HD + c] = x[b, t0 + t, h, c] as stage_seg, rows unpadded, in
// 16-byte copies (rows of HD floats are 16-byte aligned)
template <int HD>
__device__ __forceinline__ void stage_seg16(float* sm, const float* x,
                                            int b, int t0, int Lc, int h,
                                            int S, int H, float fill) {
  for (int e = threadIdx.x; e < kCk * HD / 4; e += blockDim.x) {
    const int t = e / (HD / 4), c = (e % (HD / 4)) * 4;
    if (t < Lc)
      cp_async16(sm + t * HD + c, x + at<HD>(b, t0 + t, h, S, H) + c);
    else
      *reinterpret_cast<float4*>(sm + t * HD + c) =
          make_float4(fill, fill, fill, fill);
  }
}

// sm[i * (HD + 1) + j] = x[i * HD + j], an (HD, HD) matrix
template <int HD>
__device__ __forceinline__ void stage_mat(float* sm, const float* x) {
  for (int e = threadIdx.x; e < HD * HD; e += blockDim.x)
    cp_async4(sm + (e / HD) * (HD + 1) + e % HD, x + e);
}

// cp.async groups: close the group issued since the last commit; wait
// until at most N groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// sm[t * JC + c] = x[b, t0 + t, h, j0 + c] for c < JC, as stage_seg16:
// columns j0 .. j0 + JC - 1 of each row (j0 and JC multiples of 4)
template <int HD, int JC>
__device__ __forceinline__ void stage_cols16(float* sm, const float* x,
                                             int b, int t0, int Lc, int h,
                                             int S, int H, int j0) {
  for (int e = threadIdx.x; e < kCk * JC / 4; e += blockDim.x) {
    const int t = e / (JC / 4), c = (e % (JC / 4)) * 4;
    if (t < Lc)
      cp_async16(sm + t * JC + c, x + at<HD>(b, t0 + t, h, S, H) + j0 + c);
    else
      *reinterpret_cast<float4*>(sm + t * JC + c) = make_float4(0.f, 0.f,
                                                                0.f, 0.f);
  }
}

// sm[e] = x[e] for e < HD * HD, an (HD, HD) matrix, rows unpadded
template <int HD>
__device__ __forceinline__ void stage_mat16(float* sm, const float* x) {
  for (int e = threadIdx.x * 4; e < HD * HD; e += blockDim.x * 4)
    cp_async16(sm + e, x + e);
}

// ---------------------------------------------------------------------------
// The forward in chunk-parallel form: two launches (see the note).
// ---------------------------------------------------------------------------

constexpr int kFwdCols = 16;  // columns of S a pass-1 block owns
constexpr int kFwdRows = 4;   // rows of S a pass-1 thread owns
constexpr int kFwdBufs = 4;   // segments pass 1 keeps in flight

template <int HD>
struct FwdScanSmem {
  static constexpr int SEG = kCk * HD, BUF = 2 * SEG + kCk * kFwdCols;
  static constexpr int threads = HD / kFwdRows * kFwdCols;
};

// Pass 1, one block per (b, h, group of kFwdCols columns of S): the
// boundary scan. Column j of S depends on v[:, j] only, so the column
// groups of one recurrence need no exchange. Thread (column j, rows i0 ..
// i0 + kFwdRows - 1) keeps its elements of S in registers and walks the
// segments first to last: it writes S (the state entering segment c) to
// states[c], forms
//   dS[i][j] = sum_t Q_t[i] k_t[i] v_t[j],  Q_t = prod_{t<tau<L} w_tau,
//   W[i] = prod_t w_t[i]  (running products from the segment's end)
// and steps S <- W S + dS. dS does not depend on S, so the serial part is
// one multiply-add an element a segment; cp.async stages k, w and the
// block's columns of v kFwdBufs - 1 segments ahead.
template <int HD>
__global__ void __launch_bounds__(FwdScanSmem<HD>::threads)
    rwkv6_fwd_scan_kernel(const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ s0,
                          float* __restrict__ states,
                          float* __restrict__ s_final, int S, int H, int NC) {
  using M = FwdScanSmem<HD>;
  constexpr int SEG = M::SEG, BUF = M::BUF, NJ = HD / kFwdCols;
  static_assert(kFwdRows == 4, "rows are read as float4");
  __shared__ __align__(16) float buf[kFwdBufs * BUF];
  const int bh = blockIdx.x / NJ, j0 = (blockIdx.x % NJ) * kFwdCols;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const int jl = tid % kFwdCols, i0 = (tid / kFwdCols) * kFwdRows;
  const int j = j0 + jl;
  const auto stage = [&](int c) {
    if (c >= NC) return;
    const int t0 = c * kCk, Lc = min(kCk, S - t0);
    float* sb = buf + (c % kFwdBufs) * BUF;
    stage_seg16<HD>(sb, k, b, t0, Lc, h, S, H, 0.f);
    stage_seg16<HD>(sb + SEG, w, b, t0, Lc, h, S, H, 1.f);
    stage_cols16<HD, kFwdCols>(sb + 2 * SEG, v, b, t0, Lc, h, S, H, j0);
  };
  float st[kFwdRows];
#pragma unroll
  for (int q = 0; q < kFwdRows; ++q) st[q] = s0[mat<HD>(bh) + (i0 + q) * HD + j];
  for (int q = 0; q < kFwdBufs - 1; ++q) {  // one group a segment, even empty
    stage(q);
    cp_async_commit();
  }
  for (int c = 0; c < NC; ++c) {
    cp_async_wait<kFwdBufs - 2>();  // segment c's group is complete
    __syncthreads();  // ... for every thread; segment c - 1's reads done
    stage(c + kFwdBufs - 1);  // into segment c - 1's buffer
    cp_async_commit();
    const float* sb = buf + (c % kFwdBufs) * BUF;
    const float *sk = sb, *sw = sb + SEG, *sv = sb + 2 * SEG;
    float* sp = states + (static_cast<size_t>(bh) * NC + c) * HD * HD + j;
    float acc[kFwdRows], qd[kFwdRows];
#pragma unroll
    for (int q = 0; q < kFwdRows; ++q) {
      sp[(i0 + q) * HD] = st[q];
      acc[q] = 0.f;
      qd[q] = 1.f;
    }
#pragma unroll
    for (int t = kCk - 1; t >= 0; --t) {
      const float vj = sv[t * kFwdCols + jl];
      const float4 k4 = *reinterpret_cast<const float4*>(sk + t * HD + i0);
      const float4 w4 = *reinterpret_cast<const float4*>(sw + t * HD + i0);
      acc[0] += k4.x * qd[0] * vj; qd[0] *= w4.x;
      acc[1] += k4.y * qd[1] * vj; qd[1] *= w4.y;
      acc[2] += k4.z * qd[2] * vj; qd[2] *= w4.z;
      acc[3] += k4.w * qd[3] * vj; qd[3] *= w4.w;
    }
#pragma unroll
    for (int q = 0; q < kFwdRows; ++q) st[q] = qd[q] * st[q] + acc[q];
  }
#pragma unroll
  for (int q = 0; q < kFwdRows; ++q)
    s_final[mat<HD>(bh) + (i0 + q) * HD + j] = st[q];
}

// shared memory of pass 2, in floats (float4-read arrays first)
template <int HD>
struct FwdSegSmem {
  static constexpr int NT = 4 * HD, W = HD < 32 ? HD : 32;
  static constexpr int s0 = 0, rpT = s0 + HD * HD, r = rpT + HD * kCk,
                       k = r + kCk * HD, v = k + kCk * HD, w = v + kCk * HD,
                       apart = w + kCk * HD, u = apart + kCk * kCk * (HD / W),
                       total = u + HD;
};

// Pass 2, one block per segment (bh, c) of L = kCk steps: y of the
// segment from its entering state S0 (pass 1), in matrix form. With P_t =
// prod_{tau<t} w_tau and D(s, t) = prod_{s<tau<t} w_tau (running
// products, never a division):
//   y_t = (r_t P_t) S0 + sum_{s<=t} A[t][s] v_s,
//   A[t][s] = sum_i r_t[i] k_s[i] D(s, t)[i]  (s < t),
//   A[t][t] = sum_i r_t[i] u[i] k_t[i]  (the bonus)
// : the (L x hd)(hd x hd) product (r P) S0, the L x L matrix A (lanes over
// i, reduced by shuffles) and the (L x L)(L x hd) product A v. Thread
// (column x, steps t4 .. t4 + 3) writes y_t[x].
template <int HD>
__global__ void __launch_bounds__(4 * HD)
    rwkv6_fwd_seg_kernel(const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ states,
                         float* __restrict__ y, int S, int H, int NC) {
  using M = FwdSegSmem<HD>;
  constexpr int NT = M::NT, W = M::W;
  __shared__ __align__(16) float smem[M::total];
  float *s0 = smem + M::s0, *rpT = smem + M::rpT, *sr = smem + M::r,
        *sk = smem + M::k, *sv = smem + M::v, *sw = smem + M::w,
        *apart = smem + M::apart, *su = smem + M::u;
  const int bh = blockIdx.x / NC, c = blockIdx.x % NC;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const int t0 = c * kCk, Lc = min(kCk, S - t0);
  stage_seg16<HD>(sr, r, b, t0, Lc, h, S, H, 0.f);
  stage_seg16<HD>(sk, k, b, t0, Lc, h, S, H, 0.f);
  stage_seg16<HD>(sv, v, b, t0, Lc, h, S, H, 0.f);
  stage_seg16<HD>(sw, w, b, t0, Lc, h, S, H, 1.f);
  stage_mat16<HD>(s0, states + (static_cast<size_t>(bh) * NC + c) * HD * HD);
  if (tid < HD) su[tid] = u[static_cast<size_t>(bh) * HD + tid];
  cp_async_wait_all();
  __syncthreads();

  // (a) rpT[i][t] = r_t[i] P_t[i], transposed for float4 reads
  if (tid < HD) {
    float p = 1.f;
#pragma unroll
    for (int t = 0; t < kCk; ++t) {
      rpT[tid * kCk + t] = sr[t * HD + tid] * p;
      p *= sw[t * HD + tid];
    }
  }
  // (b) A[t][s], s <= t: lanes over i, one (s, i) a lane, reduced over
  //     groups of W lanes into HD / W parts
  {
    const int lane = tid % 32;
    for (int f0 = (tid / 32) * 32; f0 < kCk * HD; f0 += NT) {
      const int s = (f0 + lane) / HD, i = (f0 + lane) % HD;
      const float ks = sk[s * HD + i];
      float e = 1.f;
      // uniform over the warp, from its first lane's step
      for (int t = f0 / HD; t < kCk; ++t) {
        float term = 0.f;
        if (t == s) {
          term = sr[t * HD + i] * su[i] * ks;
        } else if (t > s) {
          term = ks * e * sr[t * HD + i];
          e *= sw[t * HD + i];
        }
#pragma unroll
        for (int off = W / 2; off > 0; off /= 2)
          term += __shfl_xor_sync(0xffffffffu, term, off);
        if (i % W == 0 && t >= s)
          apart[(t * kCk + s) * (HD / W) + i / W] = term;
      }
    }
  }
  __syncthreads();

  // (c) y_t[x] = (r_t P_t) S0[:, x] + sum_{s<=t} A[t][s] v_s[x]
  const int x = tid % HD, t4 = (tid / HD) * 4;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int i = 0; i < HD; ++i) {
    const float s = s0[i * HD + x];
    const float4 p4 = *reinterpret_cast<const float4*>(rpT + i * kCk + t4);
    a[0] += p4.x * s; a[1] += p4.y * s; a[2] += p4.z * s; a[3] += p4.w * s;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = t4 + q;
    if (t >= Lc) break;
    float acc = a[q];
    for (int s = 0; s <= t; ++s) {
      float A = 0.f;
#pragma unroll
      for (int g = 0; g < HD / W; ++g) A += apart[(t * kCk + s) * (HD / W) + g];
      acc += A * sv[s * HD + x];
    }
    y[at<HD>(b, t0 + t, h, S, H) + x] = acc;
  }
}

// ---------------------------------------------------------------------------
// The backward in chunk-parallel form: two launches (see the note).
// ---------------------------------------------------------------------------

// segments pass 1 keeps in flight: it stages segment c - (kScanBufs - 1)
// while it computes segment c
constexpr int kScanBufs = 4;

template <int HD>
struct ScanSmem {
  static constexpr int SEG = kCk * HD;
  static constexpr size_t bytes =
      sizeof(float) * (kScanBufs * 5 * SEG + kCk * HD + HD + kCk);
};

// Pass 1, one block per (b, h), 8 hd threads: the boundary scan. It walks
// the segments last first from G = d(s_final); for each it writes G (the
// adjoint leaving segment c) to gout[c], then forms the segment's sums
//   Delta[i][j] = sum_t P_t[i] r_t[i] dy_t[j],  P_t = prod_{tau<t} w_tau,
//   W[i] = prod_t w_t[i]   (running products, never a division)
// and steps G <- W G + Delta; du += sum_t r_t k_t (dy_t . v_t). ds0 = G at
// the end. cp.async stages segments kScanBufs - 1 ahead of the one being
// computed (16-byte copies into unpadded rows: this pass reads no
// columns), so the walk waits on the memory's latency once, not once a
// segment. Thread (j, rows i0 .. i0 + HD/8 - 1) keeps its HD/8 elements
// of G in registers and reads its rows' P_t r_t as float4s.
template <int HD>
__global__ void __launch_bounds__(8 * HD)
    rwkv6_bwd_scan_kernel(const float* __restrict__ dy,
                          const float* __restrict__ ds,
                          const float* __restrict__ r,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          float* __restrict__ gout, float* __restrict__ du,
                          float* __restrict__ ds0, int S, int H, int NC) {
  constexpr int SEG = ScanSmem<HD>::SEG, NR = HD / 8;
  constexpr int LT = 8 * HD / kCk;  // lanes a step in the dot products
  extern __shared__ __align__(16) float smem[];
  float* pr = smem;  // [kCk][HD]: P_t r_t (float4-read, so first)
  float* buf = pr + kCk * HD;  // kScanBufs x (r, k, v, w, dy) of a segment
  float* wtot = buf + kScanBufs * 5 * SEG;
  float* dyv = wtot + HD;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int j = tid % HD, i0 = (tid / HD) * NR;
  const auto stage = [&](int c) {
    if (c < 0) return;
    const int t0 = c * kCk, Lc = min(kCk, S - t0);
    float* sb = buf + (c % kScanBufs) * 5 * SEG;
    stage_seg16<HD>(sb, r, b, t0, Lc, h, S, H, 0.f);
    stage_seg16<HD>(sb + SEG, k, b, t0, Lc, h, S, H, 0.f);
    stage_seg16<HD>(sb + 2 * SEG, v, b, t0, Lc, h, S, H, 0.f);
    stage_seg16<HD>(sb + 3 * SEG, w, b, t0, Lc, h, S, H, 1.f);
    stage_seg16<HD>(sb + 4 * SEG, dy, b, t0, Lc, h, S, H, 0.f);
  };
  float G[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) G[q] = ds[mat<HD>(bh) + (i0 + q) * HD + j];
  float du_acc = 0.f;
  for (int q = 1; q < kScanBufs; ++q) {  // one group a segment, even empty
    stage(NC - q);
    cp_async_commit();
  }
  for (int c = NC - 1; c >= 0; --c) {
    cp_async_wait<kScanBufs - 2>();  // segment c's group is complete
    __syncthreads();  // ... for every thread; segment c + 1's reads done
    stage(c - (kScanBufs - 1));  // into segment c + 1's buffer
    cp_async_commit();
    const float* sb = buf + (c % kScanBufs) * 5 * SEG;
    const float *sr = sb, *sk = sb + SEG, *sv = sb + 2 * SEG,
                *sw = sb + 3 * SEG, *sdy = sb + 4 * SEG;
    if (tid < HD) {
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kCk; ++t) {
        pr[t * HD + tid] = p * sr[t * HD + tid];
        p *= sw[t * HD + tid];
      }
      wtot[tid] = p;
    }
    {  // dyv[t] = dy_t . v_t: LT lanes a step, reduced by shuffles
      const int t = tid / LT, l = tid % LT;
      float acc = 0.f;
#pragma unroll
      for (int jj = l; jj < HD; jj += LT) acc += sdy[t * HD + jj] * sv[t * HD + jj];
#pragma unroll
      for (int off = LT / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (l == 0) dyv[t] = acc;
    }
    __syncthreads();
    if (tid < HD) {
#pragma unroll
      for (int t = 0; t < kCk; ++t)
        du_acc += sr[t * HD + tid] * sk[t * HD + tid] * dyv[t];
    }
    float* go = gout + (static_cast<size_t>(bh) * NC + c) * HD * HD + j;
    float d[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      go[(i0 + q) * HD] = G[q];
      d[q] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kCk; ++t) {
      const float y = sdy[t * HD + j];
      const float* pt = pr + t * HD + i0;
      if constexpr (NR % 4 == 0) {
#pragma unroll
        for (int q = 0; q < NR; q += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pt + q);
          d[q] += p4.x * y; d[q + 1] += p4.y * y;
          d[q + 2] += p4.z * y; d[q + 3] += p4.w * y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < NR; ++q) d[q] += pt[q] * y;
      }
    }
#pragma unroll
    for (int q = 0; q < NR; ++q) G[q] = wtot[i0 + q] * G[q] + d[q];
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) ds0[mat<HD>(bh) + (i0 + q) * HD + j] = G[q];
  if (tid < HD) du[static_cast<size_t>(bh) * HD + tid] = du_acc;
}

// shared memory of pass 2, in floats. Steps (a)-(b) use s0, ge and the
// transposed dy, v, k Q (the float4-read arrays, first); step (c) uses sd,
// gv, kg and the alpha scratch instead, in the same place (99 KB -> 70 KB
// at hd 64: three blocks an SM).
template <int HD>
struct SegSmem {
  static constexpr int P = HD + 1, NT = 4 * HD, W = HD < 32 ? HD : 32;
  static constexpr int dyT = 0, vT = dyT + HD * kCk, kqT = vT + HD * kCk,
                       s0 = kqT + HD * kCk, ge = s0 + HD * P,
                       ab_end = ge + HD * P;
  static constexpr int sd = 0, gv = sd + kCk * P, kg = gv + kCk * P,
                       alpha = kg + kCk * P, c_end = alpha + kCk * NT;
  static constexpr int r = ab_end > c_end ? ab_end : c_end, k = r + kCk * P,
                       v = k + kCk * P, w = v + kCk * P, dy = w + kCk * P,
                       vd = dy + kCk * P, apart = vd + kCk * kCk,
                       u = apart + kCk * kCk * (HD / W), gs = u + HD,
                       cc = gs + HD, total = cc + kCk;
  static constexpr size_t bytes = sizeof(float) * total;
};

// Pass 2, one block per segment (bh, c) of L = kCk steps: every output of
// the segment from its entering state S0 (the forward's saved state) and
// the adjoint Ge leaving it (pass 1), in matrix form. Within the segment,
// with D(a, b)[i] = prod_{a<rho<b} w_rho[i] (a running product),
// P_t = D(-1, t), Q_t = D(t, L):
//   S_{t-1} = P_t S0 + sum_{tau<t} D(tau, t) k_tau^T v_tau
//   G_t     = Q_t Ge + sum_{sigma>t} D(t, sigma) r_sigma^T dy_sigma
// so with SD = S0 dy^T, GV = Ge v^T, VD[tau][sigma] = v_tau . dy_sigma:
//   dr_t = P_t SD_t + sum_{tau<t} D(tau,t) k_tau VD[tau][t] + u k_t VD[t][t]
//   dk_t = r_t u VD[t][t] + Q_t GV_t + sum_{sigma>t} D(t,sigma) r_sigma
//          VD[t][sigma]
//   dv_t = c_t dy_t + (k_t Q_t) Ge + sum_{sigma>t} A[t][sigma] dy_sigma,
//          A[t][sigma] = sum_i k_t D(t,sigma) r_sigma, c_t = sum_i r u k
//   dw_t = Q_t P_t rowsum(Ge * S0) + Q_t sum_{tau<t} D(tau,t) k_tau GV_tau
//          + P_t sum_{sigma>t} D(t,sigma) r_sigma SD_sigma
//          + sum_{sigma>t} D(t,sigma) r_sigma sum_{tau<t} D(tau,t) k_tau
//            VD[tau][sigma]
// (per row i; products and sums over i, j as written). Every decay
// product is formed by multiplication, so one that underflows is 0.
template <int HD>
__global__ void __launch_bounds__(4 * HD)
    rwkv6_bwd_seg_kernel(const float* __restrict__ dy,
                         const float* __restrict__ r,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ states,
                         const float* __restrict__ gbuf,
                         float* __restrict__ dr, float* __restrict__ dk,
                         float* __restrict__ dv, float* __restrict__ dw,
                         int S, int H, int NC) {
  using M = SegSmem<HD>;
  constexpr int P = M::P, NT = M::NT, W = M::W;
  extern __shared__ __align__(16) float smem[];
  float *dyT = smem + M::dyT, *vT = smem + M::vT, *kqT = smem + M::kqT;
  // step (c)'s arrays overlay step (a)-(b)'s
  float *sr = smem + M::r, *sk = smem + M::k, *sv = smem + M::v,
        *sw = smem + M::w, *sdy = smem + M::dy, *s0 = smem + M::s0,
        *ge = smem + M::ge, *sd = smem + M::sd, *gv = smem + M::gv,
        *kg = smem + M::kg, *vd = smem + M::vd, *apart = smem + M::apart,
        *alpha = smem + M::alpha, *su = smem + M::u, *gs = smem + M::gs,
        *cc = smem + M::cc;
  const int bh = blockIdx.x / NC, c = blockIdx.x % NC;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const int t0 = c * kCk, Lc = min(kCk, S - t0);
  const size_t seg = static_cast<size_t>(bh) * NC + c;
  stage_seg<HD>(sr, r, b, t0, Lc, h, S, H, 0.f);
  stage_seg<HD>(sk, k, b, t0, Lc, h, S, H, 0.f);
  stage_seg<HD>(sv, v, b, t0, Lc, h, S, H, 0.f);
  stage_seg<HD>(sw, w, b, t0, Lc, h, S, H, 1.f);
  stage_seg<HD>(sdy, dy, b, t0, Lc, h, S, H, 0.f);
  stage_mat<HD>(s0, states + seg * HD * HD);
  stage_mat<HD>(ge, gbuf + seg * HD * HD);
  if (tid < HD) su[tid] = u[static_cast<size_t>(bh) * HD + tid];
  cp_async_wait_all();
  __syncthreads();

  // (a) transposed dy, v; k_t Q_t; rowsum(Ge * S0); c_t; VD; A's parts
  for (int e = tid; e < HD * kCk; e += NT) {
    const int j = e / kCk, t = e % kCk;
    dyT[e] = sdy[t * P + j];
    vT[e] = sv[t * P + j];
  }
  if (tid < HD) {
    float q = 1.f;
    for (int t = kCk - 1; t >= 0; --t) {
      kqT[tid * kCk + t] = sk[t * P + tid] * q;
      q *= sw[t * P + tid];
    }
  } else if (tid < 2 * HD) {
    const int i = tid - HD;
    float acc = 0.f;
    for (int j = 0; j < HD; ++j) acc += ge[i * P + j] * s0[i * P + j];
    gs[i] = acc;
  } else if (tid < 2 * HD + kCk) {
    const int t = tid - 2 * HD;
    float acc = 0.f;
    for (int i = 0; i < HD; ++i) acc += sr[t * P + i] * su[i] * sk[t * P + i];
    cc[t] = acc;
  }
  for (int p = tid; p < kCk * kCk; p += NT) {
    const int ta = p / kCk, sg = p % kCk;
    float acc = 0.f;
    for (int j = 0; j < HD; ++j) acc += sv[ta * P + j] * sdy[sg * P + j];
    vd[ta * kCk + sg] = acc;
  }
  {  // A[t][sigma]: lanes over i, reduced over groups of W lanes
    const int lane = tid % 32;
    for (int f0 = (tid / 32) * 32; f0 < kCk * HD; f0 += NT) {
      const int t = (f0 + lane) / HD, i = (f0 + lane) % HD;
      const float kt = sk[t * P + i];
      float e = 1.f;
      // uniform over the warp, from its first lane's step
      for (int sg = f0 / HD + 1; sg < kCk; ++sg) {
        float term = 0.f;
        if (sg > t) {
          term = kt * e * sr[sg * P + i];
          e *= sw[sg * P + i];
        }
#pragma unroll
        for (int off = W / 2; off > 0; off /= 2)
          term += __shfl_xor_sync(0xffffffffu, term, off);
        if (i % W == 0) apart[(t * kCk + sg) * (HD / W) + i / W] = term;
      }
    }
  }
  __syncthreads();

  // (b) SD = S0 dy^T, GV = Ge v^T (thread: row i, steps 4 tg .. 4 tg + 3)
  //     and KG = (k Q) Ge (thread: column j, the same steps)
  {
    const int x = tid % HD, t4 = (tid / HD) * 4;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f},
          kgs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < HD; ++j) {
      const float s = s0[x * P + j], gg = ge[x * P + j];
      const float4 d4 = *reinterpret_cast<const float4*>(dyT + j * kCk + t4);
      const float4 v4 = *reinterpret_cast<const float4*>(vT + j * kCk + t4);
      a[0] += s * d4.x; a[1] += s * d4.y; a[2] += s * d4.z; a[3] += s * d4.w;
      g[0] += gg * v4.x; g[1] += gg * v4.y; g[2] += gg * v4.z;
      g[3] += gg * v4.w;
    }
#pragma unroll 4
    for (int i = 0; i < HD; ++i) {
      const float gg = ge[i * P + x];
      const float4 q4 = *reinterpret_cast<const float4*>(kqT + i * kCk + t4);
      kgs[0] += gg * q4.x; kgs[1] += gg * q4.y; kgs[2] += gg * q4.z;
      kgs[3] += gg * q4.w;
    }
    __syncthreads();  // s0, ge and the transposes are dead from here
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sd[(t4 + q) * P + x] = a[q];
      gv[(t4 + q) * P + x] = g[q];
      kg[(t4 + q) * P + x] = kgs[q];
    }
  }
  __syncthreads();

  // (c) dr, dk, dw for (t, i) and dv for (t, j): thread x, steps tg + 4 m
  const int x = tid % HD, tg = tid / HD;
  const float ux = su[x], gsx = gs[x];
  float* al = alpha + tid;  // this thread's D(tau, t) k_tau, stride NT
  for (int t = tg; t < Lc; t += 4) {
    float d = 1.f, s_r = 0.f, s_g = 0.f;
    for (int ta = t - 1; ta >= 0; --ta) {
      const float a = d * sk[ta * P + x];
      al[ta * NT] = a;
      s_r += a * vd[ta * kCk + t];
      s_g += a * gv[ta * P + x];
      d *= sw[ta * P + x];
    }
    const float Pt = d;
    float e = 1.f, s_k = 0.f, s_s = 0.f, cross = 0.f;
    for (int sg = t + 1; sg < kCk; ++sg) {
      const float bb = e * sr[sg * P + x];
      s_k += bb * vd[t * kCk + sg];
      s_s += bb * sd[sg * P + x];
      float inner = 0.f;
      for (int ta = 0; ta < t; ++ta) inner += al[ta * NT] * vd[ta * kCk + sg];
      cross += bb * inner;
      e *= sw[sg * P + x];
    }
    const float Qt = e, dyv = vd[t * kCk + t];
    const float kx = sk[t * P + x], rx = sr[t * P + x];
    const size_t o = at<HD>(b, t0 + t, h, S, H) + x;
    dr[o] = Pt * sd[t * P + x] + s_r + ux * kx * dyv;
    dk[o] = rx * ux * dyv + Qt * gv[t * P + x] + s_k;
    dw[o] = Qt * Pt * gsx + Qt * s_g + Pt * s_s + cross;
    float acc = cc[t] * sdy[t * P + x] + kg[t * P + x];
    for (int sg = t + 1; sg < kCk; ++sg) {
      float A = 0.f;
#pragma unroll
      for (int q = 0; q < HD / W; ++q) A += apart[(t * kCk + sg) * (HD / W) + q];
      acc += A * sdy[sg * P + x];
    }
    dv[o] = acc;
  }
}

bool valid(int B, int S, int H, int ckpt) {
  return B > 0 && S > 0 && H > 0 && ckpt == kCk;
}

}  // namespace

// r, k, v, w: (B, S, H, hd) f32; u: (B, H, hd) f32 (one row per batch
// row); s0: (B, H, hd, hd) f32; ckpt: the caller's checkpoint interval,
// which must be kCk. Writes y (B, S, H, hd), s_final (B, H, hd, hd) and
// states (B, H, ceil(S / ckpt), hd, hd), all f32. Two launches on the
// stream: the boundary scan, then the segments.
extern "C" int rwkv6_fwd(int hd, int ckpt, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const void* s0, void* y, void* s_final,
                         void* states, int B, int S, int H, void* stream) {
  if (!valid(B, S, H, ckpt)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const int BH = B * H, NC = (S + kCk - 1) / kCk;
  int err = 0;
#define REPRO_RWKV6_FWD(HD)                                                  \
  {                                                                          \
    rwkv6_fwd_scan_kernel<HD>                                                \
        <<<BH * (HD / kFwdCols), FwdScanSmem<HD>::threads, 0, st>>>(         \
            f(k), f(v), f(w), f(s0), o(states), o(s_final), S, H, NC);       \
    err = cudaGetLastError();                                                \
    if (err != 0) return err;                                                \
    rwkv6_fwd_seg_kernel<HD><<<BH * NC, 4 * HD, 0, st>>>(                    \
        f(r), f(k), f(v), f(w), f(u), f(states), o(y), S, H, NC);            \
  }
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
// rwkv6_fwd took and wrote them; scratch: (B * H, ceil(S / ckpt), hd, hd)
// f32; ckpt as for rwkv6_fwd. Writes dr, dk, dv, dw (B, S, H, hd), du (B,
// H, hd) per batch row and ds0 (B, H, hd, hd), all f32. Two launches on
// the stream: the boundary scan, then the segments.
extern "C" int rwkv6_bwd(int hd, int ckpt, const void* dy,
                         const void* ds, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const void* states,
                         void* dr, void* dk, void* dv, void* dw, void* du,
                         void* ds0, void* scratch, int B, int S, int H,
                         void* stream) {
  if (!valid(B, S, H, ckpt)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const int BH = B * H, NC = (S + kCk - 1) / kCk;
  int err = 0;
#define REPRO_RWKV6_BWD(HD)                                                  \
  {                                                                          \
    float* gbuf = o(scratch);                                                \
    constexpr size_t scan_smem = ScanSmem<HD>::bytes;                        \
    err = cudaFuncSetAttribute(rwkv6_bwd_scan_kernel<HD>,                    \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               static_cast<int>(scan_smem));                 \
    if (err != 0) return err;                                                \
    rwkv6_bwd_scan_kernel<HD><<<BH, 8 * HD, scan_smem, st>>>(                \
        f(dy), f(ds), f(r), f(k), f(v), f(w), gbuf, o(du), o(ds0), S, H,     \
        NC);                                                                 \
    err = cudaGetLastError();                                                \
    if (err != 0) return err;                                                \
    constexpr size_t smem = SegSmem<HD>::bytes;                              \
    err = cudaFuncSetAttribute(rwkv6_bwd_seg_kernel<HD>,                     \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               static_cast<int>(smem));                      \
    if (err != 0) return err;                                                \
    rwkv6_bwd_seg_kernel<HD><<<BH * NC, 4 * HD, smem, st>>>(                 \
        f(dy), f(r), f(k), f(v), f(w), f(u), f(states), gbuf, o(dr), o(dk),  \
        o(dv), o(dw), S, H, NC);                                             \
  }
  switch (hd) {
    case 16: REPRO_RWKV6_BWD(16); break;
    case 32: REPRO_RWKV6_BWD(32); break;
    case 64: REPRO_RWKV6_BWD(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RWKV6_BWD
  return cudaGetLastError();
}
