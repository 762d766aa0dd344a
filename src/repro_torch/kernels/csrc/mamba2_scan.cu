// The Mamba-2 (SSD) state recurrence for Hopper (sm_90a), forward and
// backward, bound with ctypes.
//
// Neither replaces a Pallas kernel: the JAX package runs the recurrence
// as a lax.scan over 64-step chunks under jax.checkpoint
// (src/repro/models/mamba2.py:113) and leaves its gradient to XLA. Per
// (batch, head), with the state h (P, N) f32 (P = 64, the head dim; N the
// state size):
//   h_t = a_t h_{t-1} + x_t (outer) B_t,   y_t = h_t C_t,
// a (B, S, H), x (B, S, H, P) (dt-scaled), B and C (B, S, N), shared by
// the heads. mamba2_fwd writes y (B, S, H, P), h_final (B, H, P, N) and,
// for the backward, the state entering every kCk-th step (states, (B, H,
// ceil(S / kCk), P, N), h0 first). mamba2_bwd, with G_t the adjoint of
// h_t (G = dh after the last step):
//   G_t = dy_t (outer) C_t + a_{t+1} G_{t+1},   dxdt_t = G_t B_t,
//   dB_t = sum_{h,p} G_t x_t,   dC_t = sum_{h,p} h_t dy_t,
//   da_t = <G_t, h_{t-1}>,      dh0 = a_0 G_0.
// (kernels/ref.py: mamba2_scan_ref, mamba2_scan_bwd_ref.)
//
// Design: Mamba-2's own chunked (SSD) form. Chunk c covers the L = kCk =
// 64 steps t0 .. t0 + T - 1 (T = L but in a ragged last chunk), with h_c
// = states[c] the state entering it. With local steps i, j, t:
//   Lm[i][j] = a_{j+1} ... a_i (j <= i; Lm[i][i] = 1; 0 above the diagonal)
//   D_i = a_0 ... a_i,   E_t = a_{t+1} ... a_{T-1},   A_c = a_0 ... a_{T-1}.
// Forward, three launches:
//   1. mamba2_state_kernel, a block per (b, h, c), all chunks at once:
//      the chunk's own contribution S_c = X^T diag(E) B (P x N), written
//      to the slot of states that the scan fills next (states[c + 1], or
//      h_final for the last chunk), and A_c;
//   2. mamba2_pass_kernel, a thread per 4 state elements of a (b, h):
//      h_{c+1} = A_c h_c + S_c over the chunks in order, in place (32
//      dependent steps at S 2048, against 2,048 before), h0 into
//      states[0], the last into h_final;
//   3. mamba2_out_kernel, a block per (b, c, group of hg heads):
//      Y = diag(D) (C h_c^T) + (Lm o C B^T) X. C B^T (L x L) is shared by
//      the heads and formed once a block.
// Backward, four launches, the same form run in reverse:
//   1. mamba2_state_kernel<.., true>: U_c = dY^T diag(D) C (P x N), each
//      chunk's contribution to the adjoint carried into the chunk before;
//   2. mamba2_pass_kernel in reverse: R_{NC-1} = dh, R_{c-1} = A_c R_c +
//      U_c, R_c (the adjoint of h at the chunk's end, from the steps after
//      it) into its slot of a scratch, dh0 = R_{-1};
//   3. mamba2_grad_kernel, a block per (b, c, group of hg heads), from
//      h_c = states[c] and R_c, with DX = dY X^T and CB = C B^T (L x L),
//      W = Lm o DX:
//        dX = diag(E) B R^T + (Lm o CB)^T dY,
//        dC = W B + diag(D) (dY h_c),    dB = W^T C + diag(E) (X R),
//      dB and dC summed over the block's heads in head order;
//   4. mamba2_bwd_heads_kernel: dB and dC summed over the head groups in
//      order.
// No state is ever formed a step at a time, so there is no forward
// replay. The head group hg is min(8, H), whatever B and S (the wrapper
// passes it: kernels/mamba2_scan.py), so dB and dC are summed in the same
// groups at every batch size. A product over the chunk's steps stops at
// T, and one
// over P or N skips the warp tiles whose rows are all past T.
//
// Products on the tensor cores at f32 accuracy: every product is
// mma.sync m16n8k8 on tf32 operands with the 3xTF32 split (mma_sync.cuh:
// hi = tf32(v), lo = tf32(v - hi); a_hi b_lo + a_lo b_hi summed apart
// from a_hi b_hi, both into f32 accumulators). No product runs in
// single-pass TF32 or bf16. A block's 8 warps tile a 64-row output 4 x 2
// (16 rows by half the columns each). Operands are staged by cp.async
// (rows past T zero-filled) into shared memory whose row pitches keep a
// warp's fragment loads off repeated banks for their main reads (L x L
// and L x P: 68 or 72 floats).
//
// Traps the design avoids:
//   * a underflows to exactly 0 (a = exp(softplus(dt) A)). Decay products
//     are never exp(cumsum log a) differences or prefix-product ratios
//     (-inf - -inf and 0 / 0 give NaN). A thread walks its column j of Lm
//     down 16 rows, a running product in step order entered from two
//     small tables (decay_tables: the products to the end of j's quarter
//     of the chunk, and of whole quarters); D and E fall out of the walk,
//     and the state kernel's E, D and A_c come from the same tables. An
//     exact 0 gives exact 0s.
//   * da without dividing by a. The product that skips a_t is Lm[i][t]
//     Lm[t-1][j], so
//       da_t = sum_{i>=t} Lm[i][t] V[i][t]                     (DX o CB)
//            + D_{t-1} sum_{i>=t} Lm[i][t] q_i                 (h_c)
//            + E_t sum_{j<t} Lm[t-1][j] z_j                    (R_c)
//            + E_t D_{t-1} <R_c, h_c>,
//     V = (DX o CB) L'^T with L'[t][j] = Lm[t-1][j], q_i = (dY h_c)_i . C_i
//     and z_j = (X R_c)_j . B_j (the products dC and dB take anyway).
//   * Memory: states (B, H, NC, P, N) f32 is 67 MB a layer at the pod
//     shape, as before; the backward's R scratch is as large again and
//     lives for one call, the head-group partials of dB and dC (B, S, H /
//     hg, N) two more of 8 MB.
// Every sum runs in a fixed order and nothing is accumulated across blocks
// (no atomics), so each call is deterministic: the port's chunked ==
// per-round contract holds bitwise. h_final and the states are not the
// per-step recurrence's bits (a chunk boundary sums in another order);
// they are held to the same 1e-5 x (1 + max |plain|) rule as y.
//
// S below one chunk (S < kCk: the serving path's decode step, S = 1)
// keeps PR 28's per-step form in the forward: mamba2_step_kernel, a block
// of 256 threads a (b, h), the state in registers (thread i: row i / 4,
// N / 4 columns), one step at a time, y by a fixed 4-lane butterfly, the
// state update rounding each op alone. The backward takes the chunk form
// at every S (a single ragged chunk below kCk).
//
// Bound (chip_smoke.py: time_mamba2). At the pod shape (B 2, S 2048, H
// 64, P 64, N 64) the forward's function reads a, x, B, C and h0 and
// writes y and h_final (141.6 MB, 0.042 ms at 3.35 TB/s); the
// backward's reads dy, dh, a, x, B, C, h0 and writes da, dxdt, dB, dC,
// dh0 (213.9 MB, 0.064 ms). The chunk form does 6.5 and 19.4 GFLOP of
// products, three tensor-core passes each at 495 TFLOP/s: 0.039 and
// 0.117 ms. The bounds are 0.042 ms (bytes) and 0.117 ms (operations);
// the per-step recurrence's flops at the f32 rate (0.080 and 0.224 ms)
// bound only the per-step form. The design moves the saved states and
// its scratch too (about 0.5 and 0.9 GB a call: 0.14 and 0.26 ms at
// 3.35 TB/s). Its products run at about a quarter of the tensor cores'
// rate: mma.sync fragments are loaded and split from shared memory by
// the warps themselves, 8 warps an SM in the backward (its 160 KB of
// tiles fit one block).
//
// Templated on N in {16, 32, 64} (64 is zamba2's ssm_state, 16 the
// reduced config's); P is 64 (models/mamba2.py: HEAD_DIM). The chunk kCk
// is owned by kernels/ref.py (MAMBA2_CKPT), which sizes the states: the
// wrapper passes it as `ckpt` and the entries refuse any other value. The
// C entries return cudaGetLastError() after each launch; the Python
// wrapper (kernels/mamba2_scan.py) raises when it is not 0.

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

using repro_torch::mma::mma_tf32x3;
using repro_torch::mma::split_tf32;

constexpr int kCk = 64;       // steps a chunk (L); the entries check `ckpt`
constexpr int kP = 64;        // the head dim
constexpr int kT = 256;       // threads a block: 8 warps
constexpr int kLd = kCk + 4;  // pitch of an L x L or L x P tile read by rows
constexpr int kLdT = kCk + 8; // ... read down its columns
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// Staging: asynchronous copies global -> shared (cp.async, sm_80+).
// ---------------------------------------------------------------------------

// 4 bytes from src to shared dst
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// 16 bytes from src to shared dst; zeros when !valid (src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// sm[t * LD + w] = g[t * pitch + w] for t < T, 0 for T <= t < rows (w <
// W; rows of W floats, 16-byte aligned)
template <int W, int LD>
__device__ __forceinline__ void stage_tile(float* sm, const float* g,
                                           size_t pitch, int T,
                                           int rows = kCk) {
  for (int e = threadIdx.x; e < rows * (W / 4); e += blockDim.x) {
    const int t = e / (W / 4), w = (e % (W / 4)) * 4;
    const bool ok = t < T;
    cp_async16(sm + t * LD + w, g + (ok ? t * pitch + w : 0), ok);
  }
}

// sm[t] = a[b, t0 + t, h] for t < T (cp.async), `fill` up to kCk
__device__ __forceinline__ void stage_decay(float* sm, const float* a,
                                            int b, int h, int t0, int T,
                                            int S, int H, float fill = 0.f) {
  const int t = threadIdx.x;
  if (t < T)
    cp_async4(sm + t, a + (static_cast<size_t>(b) * S + t0 + t) * H + h);
  else if (t < kCk)
    sm[t] = fill;
}

// ---------------------------------------------------------------------------
// Warp products: 8 warps tile a 64-row output 4 x 2.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int warp_row0() {
  return 16 * ((threadIdx.x >> 5) & 3);
}

template <int COLS>
__device__ __forceinline__ int warp_col0() {
  return (threadIdx.x >> 7) * (COLS / 2);
}

// T rounded up to the k step: a product over the chunk's steps stops
// there (the staged rows past T are 0)
__device__ __forceinline__ int steps8(int T) { return (T + 7) & ~7; }

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc[j] += sum_{k0 <= k < k1} A(r0 + r, k) Bf(k, c0 + 8 j + n) over the
// warp's 16 x 8 NT tile, 3xTF32 (k0, k1 multiples of 8); A and Bf read
// shared memory and may scale or mask what they read. The small terms
// (hi lo, lo hi) sum apart from the large (hi hi) and join them at the
// end, so that consecutive products on a tile do not wait on each other.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int r0, int c0,
                                         int k0, int k1, FA A, FB Bf) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  float small[NT][4];
  zero(small);
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(A(r0 + g, k + q), ah[0], al[0]);
    split_tf32(A(r0 + g + 8, k + q), ah[1], al[1]);
    split_tf32(A(r0 + g, k + q + 4), ah[2], al[2]);
    split_tf32(A(r0 + g + 8, k + q + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(Bf(k + q, c0 + 8 * j + g), bh0, bl0);
      split_tf32(Bf(k + q + 4, c0 + 8 * j + g), bh1, bl1);
      mma_tf32x3(acc[j], small[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// f(value, row, col) over a warp's accumulators
template <int NT, typename F>
__device__ __forceinline__ void for_acc(float (&acc)[NT][4], int r0, int c0,
                                        F f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(acc[j][e], r0 + g + 8 * (e >> 1), c0 + 8 * j + 2 * q + (e & 1));
}

// f(value, out, row, col) over a warp's accumulators and a second set of
// the same tiling
template <int NT, typename F>
__device__ __forceinline__ void for_acc2(const float (&acc)[NT][4],
                                         float (&out)[NT][4], int r0, int c0,
                                         F f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(acc[j][e], out[j][e], r0 + g + 8 * (e >> 1),
        c0 + 8 * j + 2 * q + (e & 1));
}

// dst[r * pitch + col] = acc for the rows r < T
template <int NT>
__device__ __forceinline__ void store_acc(float* dst, size_t pitch,
                                          const float (&acc)[NT][4], int r0,
                                          int c0, int T) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = c0 + 8 * j + 2 * q;
    if (r0 + g < T)
      *reinterpret_cast<float2*>(dst + (r0 + g) * pitch + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (r0 + g + 8 < T)
      *reinterpret_cast<float2*>(dst + (r0 + g + 8) * pitch + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

// sum over a row's columns in the warp: the quad's lanes xor 1, 2 (every
// lane of the quad holds the same sum)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kAll, v, 1);
  return v + __shfl_xor_sync(kAll, v, 2);
}

// A chunk's decay products. The chunk's steps fall into 4 quarters of kQ
// = 16; two small tables:
//   suf[j] = a_{j+1} ... a_{end of j's quarter},   quarter[b] = the
//   decays of quarter b multiplied whole (both in step order).
// Lm: thread (q, j) = (threadIdx.x / kCk, threadIdx.x % kCk) walks column
// j down the rows of quarter q, Lm[i][j] = Lm[i-1][j] a_i (1 at i = j, 0
// above), entering from a_{j+1} ... a_{16 q - 1} = suf[j] times the whole
// quarters between; D_i = a_0 Lm[i][0] and E_t = Lm[T-1][t] fall out of
// the walk. Every entry is a product in a fixed order of the decays in
// its range: an exact 0 gives exact 0s, and nothing is divided.
constexpr int kQ = kCk / 4;
struct DecayTables {
  float suf[kCk], quarter[4];
};

// fills d from as; threads 0 .. kCk + 3 (the caller syncs after)
__device__ __forceinline__ void decay_tables(DecayTables& d,
                                             const float* as) {
  const int tid = threadIdx.x;
  if (tid < kCk) {
    const int e = tid | (kQ - 1);
    float p = 1.f;
#pragma unroll
    for (int k = 1; k < kQ; ++k)
      if (tid + k <= e) p *= as[min(tid + k, kCk - 1)];
    d.suf[tid] = p;
  } else if (tid < kCk + 4) {
    const int b0 = (tid - kCk) * kQ;
    float p = as[b0];
#pragma unroll
    for (int k = 1; k < kQ; ++k) p *= as[b0 + k];
    d.quarter[tid - kCk] = p;
  }
}

// put(i, j, Lm[i][j]) over the thread's kQ rows of its column (all
// threads; d filled and synced)
template <typename F>
__device__ __forceinline__ void decay_walk(const DecayTables& d,
                                           const float* as, F put) {
  const int j = threadIdx.x % kCk, q = threadIdx.x / kCk, bj = j / kQ;
  float p = d.suf[j];
#pragma unroll
  for (int b = 1; b < 3; ++b)
    if (b > bj && b < q) p *= d.quarter[b];
#pragma unroll
  for (int r = 0; r < kQ; ++r) {
    const int i = q * kQ + r;
    if (i == j)
      p = 1.f;
    else if (i > j)
      p *= as[i];
    put(i, j, i >= j ? p : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Chunk contributions: S_c = X^T diag(E) B (forward), U_c = dY^T diag(D) C
// (backward, REV), and A_c.
// ---------------------------------------------------------------------------

template <int N>
struct StateSmem {
  static constexpr int ldm = N + 8;
  static constexpr size_t bytes =
      (kCk * kLdT + kCk * ldm + 2 * kCk) * sizeof(float) +
      sizeof(DecayTables);
};

// x: x (forward) or dy; m: B (forward) or C. Writes the contribution of
// chunk c of (b, h) to slots[(b, h), c + 1] (forward) or c - 1 (REV), or
// to edge (h_final or dh0) where that slot is past the end; decay[(b, h),
// c] = A_c.
template <int N, bool REV>
__global__ void __launch_bounds__(kT)
    mamba2_state_kernel(const float* __restrict__ a,
                        const float* __restrict__ x,
                        const float* __restrict__ m,
                        float* __restrict__ slots, float* __restrict__ edge,
                        float* __restrict__ decay, int S, int H, int NC) {
  using L = StateSmem<N>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ms = xs + kCk * kLdT;
  float* as = ms + kCk * L::ldm;
  float* ws = as + kCk;
  auto* dtab = reinterpret_cast<DecayTables*>(ws + kCk);
  const int c = blockIdx.x % NC, bh = blockIdx.x / NC;
  const int b = bh / H, h = bh % H;
  const int t0 = c * kCk, T = min(kCk, S - t0);

  stage_tile<kP, kLdT>(
      xs, x + ((static_cast<size_t>(b) * S + t0) * H + h) * kP,
      static_cast<size_t>(H) * kP, T);
  stage_tile<N, L::ldm>(ms, m + (static_cast<size_t>(b) * S + t0) * N,
                             N, T);
  stage_decay(as, a, b, h, t0, T, S, H, 1.f);  // 1 past T: E and A stop there
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  decay_tables(*dtab, as);
  __syncthreads();
  if (threadIdx.x < kCk) {
    const int t = threadIdx.x, bt = t / kQ;
    float p;
    if (REV) {  // D_t = a_0 ... a_t: the quarters before t's, then t's
      p = 1.f;
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (u < bt) p *= dtab->quarter[u];
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        if (k <= t % kQ) p *= as[bt * kQ + k];
    } else {  // E_t = a_{t+1} ... a_{kCk-1}
      p = dtab->suf[t];
#pragma unroll
      for (int u = 1; u < 4; ++u)
        if (u > bt) p *= dtab->quarter[u];
    }
    ws[t] = p;
  } else if (threadIdx.x == kCk) {
    decay[static_cast<size_t>(bh) * NC + c] =
        ((dtab->quarter[0] * dtab->quarter[1]) * dtab->quarter[2]) *
        dtab->quarter[3];
  }
  __syncthreads();

  constexpr int NT = N / 16;
  const int r0 = warp_row0(), c0 = warp_col0<N>();
  float acc[NT][4];
  zero(acc);
  warp_mma<NT>(
      acc, r0, c0, 0, steps8(T),
      [&](int p, int t) { return xs[t * kLdT + p]; },
      [&](int t, int n) { return ws[t] * ms[t * L::ldm + n]; });
  const int slot = REV ? c - 1 : c + 1;
  float* dst = slot >= 0 && slot < NC
                   ? slots + (static_cast<size_t>(bh) * NC + slot) * kP * N
                   : edge + static_cast<size_t>(bh) * kP * N;
  store_acc<NT>(dst, N, acc, r0, c0, kP);
}

// The scan over the chunks, in place: forward h <- h0, then for c in
// order slots[c] <- h, h <- A_c h + S_c (S_c read from slots[c + 1] or
// edge), edge <- h; REV: h <- dh, c from last to first, U_c from slots[c
// - 1] or edge. One thread per 4 elements of a (b, h)'s P x N state.
template <bool REV>
__global__ void __launch_bounds__(kT)
    mamba2_pass_kernel(const float4* __restrict__ start,
                       float4* __restrict__ slots, float4* __restrict__ edge,
                       const float* __restrict__ decay, int NC,
                       long long BH, int PN4) {
  const long long total = BH * PN4;
  for (long long e = blockIdx.x * static_cast<long long>(kT) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kT) {
    const long long bh = e / PN4;
    const int i = static_cast<int>(e % PN4);
    float4* row = slots + bh * NC * PN4 + i;
    const float* dec = decay + bh * NC;
    float4 h = start[e];
    for (int k = 0; k < NC; ++k) {
      const int c = REV ? NC - 1 - k : k;
      const int src = REV ? c - 1 : c + 1;
      const float4 s =
          src >= 0 && src < NC ? row[static_cast<size_t>(src) * PN4] : edge[e];
      row[static_cast<size_t>(c) * PN4] = h;
      const float A = dec[c];
      h.x = fmaf(A, h.x, s.x);
      h.y = fmaf(A, h.y, s.y);
      h.z = fmaf(A, h.z, s.z);
      h.w = fmaf(A, h.w, s.w);
    }
    edge[e] = h;
  }
}

// ---------------------------------------------------------------------------
// Forward output: Y = diag(D) (C h_c^T) + (Lm o C B^T) X
// ---------------------------------------------------------------------------

template <int N>
struct OutSmem {
  static constexpr int ldn = N + 4;
  static constexpr size_t bytes =
      (kCk * kLdT + kCk * ldn + 2 * kCk * kLd + kP * ldn + 2 * kCk) *
          sizeof(float) +
      sizeof(DecayTables);
};

// CB[i][j] = C_i . B_j into cb (pitch kLd)
template <int N>
__device__ __forceinline__ void chunk_cb(float* cb, const float* bs,
                                         const float* cs, int T) {
  constexpr int ldn = N + 4;
  const int r0 = warp_row0(), c0 = warp_col0<kCk>();
  float acc[4][4];
  zero(acc);
  if (r0 < T && c0 < T)  // else the staged rows are 0, and so is CB
    warp_mma<4>(
        acc, r0, c0, 0, N, [&](int i, int n) { return cs[i * ldn + n]; },
        [&](int n, int j) { return bs[j * ldn + n]; });
  for_acc<4>(acc, r0, c0,
             [&](float v, int i, int j) { cb[i * kLd + j] = v; });
}

// One block a (b, c, group of hg heads). B is staged into the x tile's
// buffer and freed once C B^T is formed.
template <int N>
__global__ void __launch_bounds__(kT, 2)
    mamba2_out_kernel(const float* __restrict__ a,
                      const float* __restrict__ x,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ states,
                      float* __restrict__ y, int S, int H, int NC, int hg,
                      int G) {
  using L = OutSmem<N>;
  constexpr int ldn = L::ldn;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* cs = xs + kCk * kLdT;
  float* cb = cs + kCk * ldn;
  float* mm = cb + kCk * kLd;
  float* hs = mm + kCk * kLd;
  float* as = hs + kP * ldn;
  float* ds = as + kCk;
  auto* dtab = reinterpret_cast<DecayTables*>(ds + kCk);
  const int grp = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % NC, b = bc / NC;
  const int t0 = c * kCk, T = min(kCk, S - t0);
  const int r0 = warp_row0(), c0 = warp_col0<kP>();

  stage_tile<N, ldn>(xs, Bm + (static_cast<size_t>(b) * S + t0) * N, N, T);
  stage_tile<N, ldn>(cs, Cm + (static_cast<size_t>(b) * S + t0) * N, N, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cb<N>(cb, xs, cs, T);

  const int h1 = min(H, (grp + 1) * hg);
  for (int h = grp * hg; h < h1; ++h) {
    __syncthreads();  // cb is written; the last head is done with its tiles
    stage_tile<kP, kLdT>(
        xs, x + ((static_cast<size_t>(b) * S + t0) * H + h) * kP,
        static_cast<size_t>(H) * kP, T);
    stage_tile<N, ldn>(
        hs, states + ((static_cast<size_t>(b) * H + h) * NC + c) * kP * N, N,
        kP);
    stage_decay(as, a, b, h, t0, T, S, H);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    decay_tables(*dtab, as);
    __syncthreads();
    decay_walk(*dtab, as, [&](int i, int j, float v) {
      mm[i * kLd + j] = v * cb[i * kLd + j];
      if (j == 0) ds[i] = as[0] * v;
    });
    __syncthreads();

    float acc[4][4];
    zero(acc);
    if (r0 < T)
      warp_mma<4>(
          acc, r0, c0, 0, N, [&](int i, int n) { return cs[i * ldn + n]; },
          [&](int n, int p) { return hs[p * ldn + n]; });
    for_acc<4>(acc, r0, c0, [&](float& v, int i, int) { v *= ds[i]; });
    warp_mma<4>(
        acc, r0, c0, 0, min(r0 + 16, steps8(T)),
        [&](int i, int j) { return mm[i * kLd + j]; },
        [&](int j, int p) { return xs[j * kLdT + p]; });
    store_acc<4>(y + ((static_cast<size_t>(b) * S + t0) * H + h) * kP,
                 static_cast<size_t>(H) * kP, acc, r0, c0, T);
  }
}

// ---------------------------------------------------------------------------
// Backward: dX, da, and dB, dC summed over a group of heads
// ---------------------------------------------------------------------------

template <int N>
struct GradSmem {
  static constexpr int ldn = N + 4;   // B, C (read by rows)
  static constexpr int ldh = N + 8;   // h_c, R (read down columns)
  static constexpr size_t floats = 2 * kCk * ldn + 5 * kCk * kLd +
                                   2 * kP * ldh + 3 * kCk + 4 * kCk +
                                   3 * 4 * kCk + 8;
  static constexpr size_t bytes =
      floats * sizeof(float) + sizeof(DecayTables);
};

// the warp's share of sum_n acc[r][n] * m[r][n] for its rows, summed over
// the quad: out[half * kCk + r] (half: the warp's column half)
template <int NT>
__device__ __forceinline__ void row_dots(float (&acc)[NT][4], const float* m,
                                         int ld, int r0, int c0, float* out) {
  float lo = 0.f, hi = 0.f;
  for_acc<NT>(acc, r0, c0, [&](float v, int r, int n) {
    const float t = v * m[r * ld + n];
    if (r < r0 + 8) lo += t; else hi += t;
  });
  lo = quad_sum(lo);
  hi = quad_sum(hi);
  if ((threadIdx.x & 3) == 0) {
    const int g = (threadIdx.x & 31) >> 2, half = threadIdx.x >> 7;
    out[half * kCk + r0 + g] = lo;
    out[half * kCk + r0 + g + 8] = hi;
  }
}

template <int N>
__global__ void __launch_bounds__(kT, 1)
    mamba2_grad_kernel(const float* __restrict__ dy,
                       const float* __restrict__ a,
                       const float* __restrict__ x,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ states,
                       const float* __restrict__ adj,
                       float* __restrict__ dx, float* __restrict__ da,
                       float* __restrict__ dBp, float* __restrict__ dCp,
                       int S, int H, int NC, int hg, int G) {
  using L = GradSmem<N>;
  constexpr int ldn = L::ldn, ldh = L::ldh, NT = N / 16;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);
  float* cs = bs + kCk * ldn;
  float* cb = cs + kCk * ldn;
  float* lm = cb + kCk * kLd;
  float* dxm = lm + kCk * kLd;   // DX, then V o Lm
  float* xs = dxm + kCk * kLd;
  float* dys = xs + kCk * kLd;
  float* hs = dys + kCk * kLd;
  float* rs = hs + kP * ldh;
  float* as = rs + kP * ldh;
  float* ds = as + kCk;          // D_i
  float* es = ds + kCk;          // E_t
  float* qv = es + kCk;          // q_i, two column halves
  float* zv = qv + 2 * kCk;      // z_j, two column halves
  float* part = zv + 2 * kCk;    // da's three sums, four parts each
  float* red = part + 3 * 4 * kCk;
  auto* dtab = reinterpret_cast<DecayTables*>(red + 8);
  const int grp = blockIdx.x % G, bc = blockIdx.x / G;
  const int c = bc % NC, b = bc / NC;
  const int t0 = c * kCk, T = min(kCk, S - t0);
  const int r0 = warp_row0(), cL = warp_col0<kCk>(), cN = warp_col0<N>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kT8 = steps8(T);

  stage_tile<N, ldn>(bs, Bm + (static_cast<size_t>(b) * S + t0) * N, N, T);
  stage_tile<N, ldn>(cs, Cm + (static_cast<size_t>(b) * S + t0) * N, N, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  chunk_cb<N>(cb, bs, cs, T);

  float gC[NT][4], gB[NT][4];  // dC, dB over the block's heads
  zero(gC);
  zero(gB);
  const int h1 = min(H, (grp + 1) * hg);
  for (int h = grp * hg; h < h1; ++h) {
    __syncthreads();  // cb is written; the last head is done with its tiles
    const size_t row0 = (static_cast<size_t>(b) * S + t0) * H + h;
    const size_t st = ((static_cast<size_t>(b) * H + h) * NC + c) * kP * N;
    stage_tile<kP, kLd>(xs, x + row0 * kP, static_cast<size_t>(H) * kP, T);
    stage_tile<kP, kLd>(dys, dy + row0 * kP, static_cast<size_t>(H) * kP, T);
    stage_tile<N, ldh>(hs, states + st, N, kP);
    stage_tile<N, ldh>(rs, adj + st, N, kP);
    stage_decay(as, a, b, h, t0, T, S, H);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    decay_tables(*dtab, as);
    __syncthreads();
    decay_walk(*dtab, as, [&](int i, int j, float v) {
      lm[i * kLd + j] = v;
      if (j == 0) ds[i] = as[0] * v;
      if (i == T - 1) es[j] = v;
    });
    {  // <R, h_c>: each thread its elements, the warp's butterfly, then the
       // warps in order
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < kP * N / kT; ++u) {
        const int e = threadIdx.x + u * kT, p = e / N, n = e % N;
        s = fmaf(rs[p * ldh + n], hs[p * ldh + n], s);
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(kAll, s, m);
      if (lane == 0) red[warp] = s;
    }
    __syncthreads();
    float hr = red[0];
#pragma unroll
    for (int w = 1; w < kT / 32; ++w) hr += red[w];

    // products over P or N skip the tiles whose rows (or columns) are all
    // past T: their staged rows are 0, and the tile stays 0
    {  // DX = dY X^T (L x L, full)
      float acc[4][4];
      zero(acc);
      if (r0 < T && cL < T)
        warp_mma<4>(
            acc, r0, cL, 0, kP,
            [&](int i, int p) { return dys[i * kLd + p]; },
            [&](int p, int j) { return xs[j * kLd + p]; });
      for_acc<4>(acc, r0, cL,
                 [&](float v, int i, int j) { dxm[i * kLd + j] = v; });
    }
    {  // Q = dY h_c: q_i = Q_i . C_i, dC += diag(D) Q
      float acc[NT][4];
      zero(acc);
      if (r0 < T)
        warp_mma<NT>(
            acc, r0, cN, 0, kP,
            [&](int i, int p) { return dys[i * kLd + p]; },
            [&](int p, int n) { return hs[p * ldh + n]; });
      row_dots<NT>(acc, cs, ldn, r0, cN, qv);
      for_acc2<NT>(acc, gC, r0, cN, [&](float v, float& o, int i, int) {
        o = fmaf(ds[i], v, o);
      });
    }
    {  // Z = X R: z_j = Z_j . B_j, dB += diag(E) Z
      float acc[NT][4];
      zero(acc);
      if (r0 < T)
        warp_mma<NT>(
            acc, r0, cN, 0, kP, [&](int j, int p) { return xs[j * kLd + p]; },
            [&](int p, int n) { return rs[p * ldh + n]; });
      row_dots<NT>(acc, bs, ldn, r0, cN, zv);
      for_acc2<NT>(acc, gB, r0, cN, [&](float v, float& o, int j, int) {
        o = fmaf(es[j], v, o);
      });
    }
    __syncthreads();  // DX, q and z are complete

    // dC += W B, dB += W^T C, W = Lm o DX (lower triangle)
    if (r0 < T)
      warp_mma<NT>(
          gC, r0, cN, 0, min(r0 + 16, kT8),
          [&](int i, int j) { return lm[i * kLd + j] * dxm[i * kLd + j]; },
          [&](int j, int n) { return bs[j * ldn + n]; });
    warp_mma<NT>(
        gB, r0, cN, r0, kT8,
        [&](int j, int i) { return lm[i * kLd + j] * dxm[i * kLd + j]; },
        [&](int i, int n) { return cs[i * ldn + n]; });
    {  // dX = diag(E) B R^T + (Lm o CB)^T dY
      float acc[4][4];
      zero(acc);
      if (r0 < T)
        warp_mma<4>(
            acc, r0, cL, 0, N, [&](int t, int n) { return bs[t * ldn + n]; },
            [&](int n, int p) { return rs[p * ldh + n]; });
      for_acc<4>(acc, r0, cL, [&](float& v, int t, int) { v *= es[t]; });
      warp_mma<4>(
          acc, r0, cL, r0, kT8,
          [&](int t, int i) { return lm[i * kLd + t] * cb[i * kLd + t]; },
          [&](int i, int p) { return dys[i * kLd + p]; });
      store_acc<4>(dx + row0 * kP, static_cast<size_t>(H) * kP, acc, r0, cL,
                   T);
    }
    // V = (DX o CB) L'^T, L'[t][j] = Lm[t-1][j]: only j < t <= i add up,
    // so a tile with every row above every column is zero
    float vl[4][4];
    zero(vl);
    if (r0 + 15 >= cL)
      warp_mma<4>(
          vl, r0, cL, 0, min(min(cL + 32, r0 + 16), kT8),
          [&](int i, int j) { return dxm[i * kLd + j] * cb[i * kLd + j]; },
          [&](int j, int t) { return t > 0 ? lm[(t - 1) * kLd + j] : 0.f; });
    __syncthreads();  // every read of DX is done
    for_acc<4>(vl, r0, cL, [&](float v, int i, int t) {
      dxm[i * kLd + t] = v * lm[i * kLd + t];
    });
    __syncthreads();
    {  // da's three sums, each in four interleaved parts
      const int t = threadIdx.x & (kCk - 1), k = threadIdx.x / kCk;
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int u = 0; u < kCk / 4; ++u) {
        const int i = t + k + 4 * u;  // rows i >= t
        if (i < kCk) {
          s1 += dxm[i * kLd + t];
          s2 = fmaf(lm[i * kLd + t], qv[i] + qv[kCk + i], s2);
        }
        const int j = k + 4 * u;      // columns j < t
        if (j < t) s3 = fmaf(lm[(t - 1) * kLd + j], zv[j] + zv[kCk + j], s3);
      }
      part[(0 * 4 + k) * kCk + t] = s1;
      part[(1 * 4 + k) * kCk + t] = s2;
      part[(2 * 4 + k) * kCk + t] = s3;
    }
    __syncthreads();
    if (threadIdx.x < T) {
      const int t = threadIdx.x;
      float s[3];
#pragma unroll
      for (int u = 0; u < 3; ++u)
        s[u] = ((part[(u * 4) * kCk + t] + part[(u * 4 + 1) * kCk + t]) +
                part[(u * 4 + 2) * kCk + t]) +
               part[(u * 4 + 3) * kCk + t];
      const float dm1 = t > 0 ? ds[t - 1] : 1.f;
      da[row0 + static_cast<size_t>(t) * H] =
          s[0] + dm1 * s[1] + es[t] * (s[2] + dm1 * hr);
    }
  }
  const size_t o = ((static_cast<size_t>(b) * S + t0) * G + grp) * N;
  store_acc<NT>(dCp + o, static_cast<size_t>(G) * N, gC, r0, cN, T);
  store_acc<NT>(dBp + o, static_cast<size_t>(G) * N, gB, r0, cN, T);
}

// dB[b, t, n] = sum_g dBp[b, t, g, n] (and dC), groups in order
__global__ void __launch_bounds__(kT)
    mamba2_bwd_heads_kernel(const float* __restrict__ dBp,
                            const float* __restrict__ dCp,
                            float* __restrict__ dB, float* __restrict__ dC,
                            long long rows, int G, int N) {
  const long long total = rows * N;
  for (long long e = blockIdx.x * static_cast<long long>(kT) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kT) {
    const long long r = e / N;
    const int n = static_cast<int>(e % N);
    const float* pb = dBp + r * G * N + n;
    const float* pc = dCp + r * G * N + n;
    float sb = pb[0], sc = pc[0];
    for (int g = 1; g < G; ++g) {
      sb += pb[static_cast<size_t>(g) * N];
      sc += pc[static_cast<size_t>(g) * N];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
}

// ---------------------------------------------------------------------------
// The per-step forward (S < kCk: one ragged chunk, the decode step)
// ---------------------------------------------------------------------------

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

template <int N>
struct StepSmem {
  static constexpr size_t bytes = kCk * (1 + kP + 2 * N) * sizeof(float);
};

// S < kCk: states[(b, h), 0] = h0, then the S steps from registers
template <int N>
__global__ void __launch_bounds__(kT, 1)
    mamba2_step_kernel(const float* __restrict__ a,
                       const float* __restrict__ x,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ h_final,
                       float* __restrict__ states, int S, int H) {
  constexpr int NPT = N / 4;
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);
  float* xs = as + kCk;
  float* bs = xs + kCk * kP;
  float* cs = bs + kCk * N;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int p = threadIdx.x >> 2, n0 = (threadIdx.x & 3) * NPT;
  const size_t row = (static_cast<size_t>(bh) * kP + p) * N + n0;

  for (int e = threadIdx.x; e < S; e += kT)
    cp_async4(as + e, a + (static_cast<size_t>(b) * S + e) * H + h);
  stage_tile<kP, kP>(xs, x + static_cast<size_t>(b) * S * H * kP + h * kP,
                     static_cast<size_t>(H) * kP, S, S);
  stage_tile<N, N>(bs, Bm + static_cast<size_t>(b) * S * N, N, S, S);
  stage_tile<N, N>(cs, Cm + static_cast<size_t>(b) * S * N, N, S, S);
  cp_async_commit();
  float hs[NPT];
  load_row<NPT>(hs, h0 + row);
  store_row<NPT>(states + row, hs);
  cp_async_wait<0>();
  __syncthreads();
  for (int k = 0; k < S; ++k) {
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
    acc = quad_sum(acc);
    if ((threadIdx.x & 3) == 0)
      y[((static_cast<size_t>(b) * S + k) * H + h) * kP + p] = acc;
  }
  store_row<NPT>(h_final + row, hs);
}

bool valid(int B, int S, int H, int P, int ckpt, int hg) {
  const long long NC = (S + static_cast<long long>(kCk) - 1) / kCk;
  return B >= 1 && S >= 1 && H >= 1 && P == kP && ckpt == kCk &&
         hg >= 1 && hg <= H &&
         static_cast<long long>(B) * H * NC < (1LL << 31);
}

// dynamic shared memory above 48 KB, and all of the SM's shared memory
// offered, so that as many blocks as fit share an SM
template <typename K>
int set_smem(K kernel, size_t bytes) {
  const int err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != 0) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int grid_for(long long items) {
  const long long want = (items + kT - 1) / kT;
  return static_cast<int>(want < repro_torch::kMaxBlocks
                              ? want
                              : repro_torch::kMaxBlocks);
}

template <int N, bool REV>
int state_and_pass(const float* a, const float* x, const float* m,
                   const float* start, float* slots, float* edge,
                   float* decay, int B, int S, int H, int NC,
                   cudaStream_t st) {
  using L = StateSmem<N>;
  int err = set_smem(mamba2_state_kernel<N, REV>, L::bytes);
  if (err != 0) return err;
  mamba2_state_kernel<N, REV><<<B * H * NC, kT, L::bytes, st>>>(
      a, x, m, slots, edge, decay, S, H, NC);
  err = cudaGetLastError();
  if (err != 0) return err;
  const long long BH = static_cast<long long>(B) * H;
  const int PN4 = kP * N / 4;
  mamba2_pass_kernel<REV><<<grid_for(BH * PN4), kT, 0, st>>>(
      reinterpret_cast<const float4*>(start),
      reinterpret_cast<float4*>(slots), reinterpret_cast<float4*>(edge),
      decay, NC, BH, PN4);
  return cudaGetLastError();
}

template <int N>
int fwd(const float* a, const float* x, const float* Bm, const float* Cm,
        const float* h0, float* y, float* h_final, float* states,
        float* decay, int B, int S, int H, int hg, cudaStream_t st) {
  int err = 0;
  if (S < kCk) {
    constexpr size_t bytes = StepSmem<N>::bytes;
    err = set_smem(mamba2_step_kernel<N>, bytes);
    if (err != 0) return err;
    mamba2_step_kernel<N><<<B * H, kT, bytes, st>>>(a, x, Bm, Cm, h0, y,
                                                    h_final, states, S, H);
    return cudaGetLastError();
  }
  const int NC = (S + kCk - 1) / kCk, G = (H + hg - 1) / hg;
  err = state_and_pass<N, false>(a, x, Bm, h0, states, h_final, decay, B, S,
                                 H, NC, st);
  if (err != 0) return err;
  err = set_smem(mamba2_out_kernel<N>, OutSmem<N>::bytes);
  if (err != 0) return err;
  mamba2_out_kernel<N><<<B * NC * G, kT, OutSmem<N>::bytes, st>>>(
      a, x, Bm, Cm, states, y, S, H, NC, hg, G);
  return cudaGetLastError();
}

template <int N>
int bwd(const float* dy, const float* dh, const float* a, const float* x,
        const float* Bm, const float* Cm, const float* states, float* da,
        float* dx, float* dB, float* dC, float* dh0, float* dBp, float* dCp,
        float* adj, float* decay, int B, int S, int H, int hg,
        cudaStream_t st) {
  const int NC = (S + kCk - 1) / kCk, G = (H + hg - 1) / hg;
  int err = state_and_pass<N, true>(a, dy, Cm, dh, adj, dh0, decay, B, S,
                                    H, NC, st);
  if (err != 0) return err;
  err = set_smem(mamba2_grad_kernel<N>, GradSmem<N>::bytes);
  if (err != 0) return err;
  mamba2_grad_kernel<N><<<B * NC * G, kT, GradSmem<N>::bytes, st>>>(
      dy, a, x, Bm, Cm, states, adj, dx, da, dBp, dCp, S, H, NC, hg, G);
  err = cudaGetLastError();
  if (err != 0) return err;
  const long long rows = static_cast<long long>(B) * S;
  mamba2_bwd_heads_kernel<<<grid_for(rows * N), kT, 0, st>>>(
      dBp, dCp, dB, dC, rows, G, N);
  return cudaGetLastError();
}

}  // namespace

// a: (B, S, H) f32; x: (B, S, H, P) f32; Bm, Cm: (B, S, N) f32; h0: (B,
// H, P, N) f32; ckpt: kernels/ref.py's MAMBA2_CKPT (must equal kCk);
// decay: (B, H, ceil(S / ckpt)) f32 scratch; hg: heads a block of the
// output kernel. Writes y (B, S, H, P), h_final (B, H, P, N) and states
// (B, H, ceil(S / ckpt), P, N), all f32. Three launches on the stream
// (one below S = ckpt).
extern "C" int mamba2_fwd(int N, int ckpt, const void* a, const void* x,
                          const void* Bm, const void* Cm, const void* h0,
                          void* y, void* h_final, void* states, void* decay,
                          int B, int S, int H, int P, int hg, void* stream) {
  if (!valid(B, S, H, P, ckpt, hg)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
#define REPRO_MAMBA2_FWD(NN)                                                  \
  return fwd<NN>(f(a), f(x), f(Bm), f(Cm), f(h0), o(y), o(h_final),          \
                 o(states), o(decay), B, S, H, hg, st)
  switch (N) {
    case 16: REPRO_MAMBA2_FWD(16);
    case 32: REPRO_MAMBA2_FWD(32);
    case 64: REPRO_MAMBA2_FWD(64);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_MAMBA2_FWD
}

// dy: (B, S, H, P) f32; dh: (B, H, P, N) f32, the gradient of h_final; a,
// x, Bm, Cm, states as mamba2_fwd took and wrote them; hg: heads a
// block of the gradient kernel; dBp, dCp: (B, S, ceil(H / hg), N) f32
// scratch (the head groups' partials); adj: (B, H, ceil(S / ckpt), P, N)
// f32 scratch; decay: (B, H, ceil(S / ckpt)) f32 scratch. Writes da (B,
// S, H), dx (B, S, H, P), dB, dC (B, S, N) and dh0 (B, H, P, N), all
// f32. Four launches on the stream.
extern "C" int mamba2_bwd(int N, int ckpt, const void* dy, const void* dh,
                          const void* a, const void* x, const void* Bm,
                          const void* Cm, const void* states, void* da,
                          void* dx, void* dB, void* dC, void* dh0, void* dBp,
                          void* dCp, void* adj, void* decay, int B, int S,
                          int H, int P, int hg, void* stream) {
  if (!valid(B, S, H, P, ckpt, hg)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto o = [](void* q) { return static_cast<float*>(q); };
#define REPRO_MAMBA2_BWD(NN)                                                  \
  return bwd<NN>(f(dy), f(dh), f(a), f(x), f(Bm), f(Cm), f(states), o(da),   \
                 o(dx), o(dB), o(dC), o(dh0), o(dBp), o(dCp), o(adj),         \
                 o(decay), B, S, H, hg, st)
  switch (N) {
    case 16: REPRO_MAMBA2_BWD(16);
    case 32: REPRO_MAMBA2_BWD(32);
    case 64: REPRO_MAMBA2_BWD(64);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_MAMBA2_BWD
}
