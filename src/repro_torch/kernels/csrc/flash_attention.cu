// Flash attention on Hopper's CUDA cores (sm_90a), f32, forward and
// backward, and the C entries of all flash-attention kernels, bound with
// ctypes. The entries dispatch by dtype: f32 inputs launch this file's
// kernels, bf16 inputs the tensor-core kernels of flash_attention_sm90.cu
// (which holds that design's note). A bf16 call never reaches the kernels
// here; each entry counts its launches per design (flash_design_counts).
//
// flash_fwd replaces the JAX package's kernels/flash_attention.py:
// flash_attention (Pallas, src/repro/kernels/flash_attention.py:76):
// causal (optionally sliding-window, or non-causal) online-softmax
// attention over q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd), H % Hkv ==
// 0, query head h reading kv head h / (H / Hkv) (Hkv == H is the TPU
// kernel's head-repeated contract). Any length: tiles past Sq or Skv are
// masked, and no row past them is stored. Sq != Skv (cross-attention:
// every key visible) only where causal and window are 0. It also writes
// lse = m + log(l) (f32, (B, H, Sq)) for the backward. flash_bwd_dq and
// flash_bwd_dkdv replace what the TPU path has no kernel for: the XLA
// autodiff of
// models/attention.py: chunked_attention (the Pallas kernel has no
// backward). They are FlashAttention-2's backward split into two passes
// so that no atomics are needed:
//   flash_bwd_dq    one block per q tile loops over the kv tiles its rows
//                   see; its prologue computes D = rowsum(dO * O) for its
//                   rows and writes it to a (B, H, Sq) f32 scratch;
//   flash_bwd_dkdv  one block per (kv head, kv tile) loops over the query
//                   heads of its kv head and the q tiles that see it, and
//                   accumulates dK and dV; it reads D, so it runs after
//                   flash_bwd_dq on the same stream.
// Both recompute P = exp(s - lse). Every output element is written by one
// thread and nothing is accumulated across blocks, so each launch is
// deterministic: the port's chunked == per-round contract holds bitwise.
//
// Math (kernels/ref.py: flash_attention_ref, flash_attention_bwd_ref):
// s = (q * scale) . k in f32 (the Pallas kernel scales q in f32 before
// the product), masked where causal (key > query) or outside the window
// (key <= query - window); the online softmax keeps m, l and acc in f32,
// with exp(s - m_new) and the correction exp(m - m_new); out = acc /
// max(l, 1e-30). Backward: dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
// dQ = scale * dS K, dK = dS^T (q * scale), dK and dV summed over the
// query heads of a kv head.
//
// Layout: the kernels index the (B, Sq, H, hd) and (B, Skv, Hkv, hd) tensors
// directly, so the wrapper folds nothing and copies nothing. Tiles are
// 64 queries by 64 keys; the kv loop runs from the window's lower edge up
// to the causal frontier, as the Pallas kernel's does
// (flash_attention.py:37-44). Templated on hd in {64, 96, 128} (the
// repo's attention configs: reduced() and zamba2/whisper 64, phi-3-vision
// 96, minitron/llama/mixtral 128).
//
// Bound: operations. With n = B*H * (visible query-key pairs) * hd, the
// forward does 4n flops (two products), flash_bwd_dq 6n (s, dP, dQ) and
// flash_bwd_dkdv 8n (s, dP, dV, dK; s and dP recomputed), on a few bytes
// per pair: far above the card's ridge point, so the bound is those flops
// at 67 TFLOP/s (f32 outside the tensor cores). The design is simple:
// every product runs on the CUDA cores in f32 from shared-memory tiles
// (4 x 4 register tiles a thread, 256 threads a block). It stays so
// because f32 callers need f32 products: the reduced f32 model is held
// card against CPU at rtol 1e-4, and TF32 tensor cores would not meet it.
//
// The C entries return cudaGetLastError() after the launch; the Python
// wrapper (kernels/flash_attention.py) raises when it is not 0.

#include "common.cuh"
#include "flash_attention.cuh"

namespace {

using namespace repro_torch;

constexpr int kTile = 64;          // queries and keys per tile
constexpr int kP = kTile + 1;      // padded row of a transposed tile
constexpr int kFlashThreads = 256; // 16 x 16: 4 rows x 4 (or hd/16) cols
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

// Geometry of one (batch, head) of a (B, S, Hx, hd) tensor, S = Sq or
// Skv: element (s, d) sits at base + s * rs + d.
struct Rows {
  size_t base;  // offset of (b, 0, h, 0)
  size_t rs;    // Hx * hd
};

template <int HD>
__device__ __forceinline__ Rows rows_of(int b, int h, int S, int Hx) {
  return {(static_cast<size_t>(b) * S * Hx + h) * HD,
          static_cast<size_t>(Hx) * HD};
}

// dst[d * kP + r] = src row (s0 + r), element d, times mul (0 past S).
template <int HD>
__device__ void load_t(float* dst, const float* __restrict__ src, Rows g,
                       int s0, int S, float mul) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kFlashThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = s0 + r;
    dst[d * kP + r] =
        s < S ? __fmul_rn(ld(src, g.base + s * g.rs + d), mul) : 0.f;
  }
}

// dst[r * HD + d] = src row (s0 + r), element d (0 past S).
template <int HD>
__device__ void load_r(float* dst, const float* __restrict__ src, Rows g,
                       int s0, int S) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kFlashThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = s0 + r;
    dst[r * HD + d] = s < S ? ld(src, g.base + s * g.rs + d) : 0.f;
  }
}

// sum / max over the 16 lanes of a half-warp that share a row
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// query row qp may attend to key kp
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Skv,
                                        int causal, int window) {
  return qp < Sq && kp < Skv && (!causal || kp <= qp) &&
         (!window || kp > qp - window);
}

// kv tiles [lo, hi) seen by the q tile starting at q0 (causal or a window
// only where Sq == Skv)
__device__ __forceinline__ void kv_range(int q0, int Skv, int causal,
                                         int window, int* lo, int* hi) {
  const int key_hi = causal ? min(Skv, q0 + kTile) : Skv;    // exclusive
  const int key_lo = window ? max(0, q0 - window + 1) : 0;
  *lo = key_lo / kTile;
  *hi = (key_hi + kTile - 1) / kTile;
}

// q tiles [lo, hi) that see the kv tile starting at k0
__device__ __forceinline__ void q_range(int k0, int Sq, int causal,
                                        int window, int* lo, int* hi) {
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq, k0 + kTile - 1 + window) : Sq;  // excl.
  *lo = q_lo / kTile;
  *hi = (q_hi + kTile - 1) / kTile;
}

// ---------------------------------------------------------------- forward

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * HD * kP + kTile * HD + kTile * kP);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H,
                 int n_rep, int causal, int window, float scale) {
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* Qt = smem;              // [HD][kP]  q * scale
  float* Kt = Qt + HD * kP;      // [HD][kP]
  float* Vr = Kt + HD * kP;      // [kTile][HD]
  float* P = Vr + kTile * HD;    // [kTile][kP]
  const int bh = blockIdx.x, q0 = blockIdx.y * kTile;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const Rows g = rows_of<HD>(b, h, Sq, H);
  const Rows gk = rows_of<HD>(b, h / n_rep, Skv, H / n_rep);
  load_t<HD>(Qt, q, g, q0, Sq, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int kt_lo, kt_hi;
  kv_range(q0, Skv, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();             // the last tile's Kt, Vr and P are read
    load_t<HD>(Kt, k, gk, k0, Skv, 1.f);
    load_r<HD>(Vr, v, gk, k0, Skv);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qt[d * kP + 4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Kt[d * kP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      bool vis[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visible(qp, k0 + tx + 16 * j, Sq, Skv, causal, window);
        if (vis[j]) mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        P[(4 * ty + i) * kP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float pa[4], vb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = P[(4 * ty + i) * kP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vb[c] = Vr[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st(out, g.base + qp * g.rs + tx + 16 * c, __fdiv_rn(acc[i][c], den));
    if (tx == 0) lse[static_cast<size_t>(bh) * Sq + qp] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------- backward, dQ

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * HD * kP + kTile * kP);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ delta,
                    int Sq, int Skv, int H, int n_rep, int causal,
                    int window, float scale) {
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* Qt = smem;              // [HD][kP]  q * scale
  float* dOt = Qt + HD * kP;     // [HD][kP]
  float* Kt = dOt + HD * kP;     // [HD][kP]
  float* Vt = Kt + HD * kP;      // [HD][kP]
  float* dS = Vt + HD * kP;      // [kTile][kP]
  const int bh = blockIdx.x, q0 = blockIdx.y * kTile;
  const int b = bh / H, h = bh % H;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const Rows g = rows_of<HD>(b, h, Sq, H);
  const Rows gk = rows_of<HD>(b, h / n_rep, Skv, H / n_rep);
  load_t<HD>(Qt, q, g, q0, Sq, scale);
  load_t<HD>(dOt, dout, g, q0, Sq, 1.f);

  // prologue: D = rowsum(dO * O) and lse of this thread's four rows
  float D[4], L[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    float part = 0.f;
    if (qp < Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const size_t e = g.base + qp * g.rs + tx + 16 * c;
        part = fmaf(ld(dout, e), ld(out, e), part);
      }
    }
    D[i] = row_sum(part);
    L[i] = qp < Sq ? lse[static_cast<size_t>(bh) * Sq + qp] : 0.f;
    if (qp < Sq && tx == 0) delta[static_cast<size_t>(bh) * Sq + qp] = D[i];
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  int kt_lo, kt_hi;
  kv_range(q0, Skv, causal, window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_t<HD>(Kt, k, gk, k0, Skv, 1.f);
    load_t<HD>(Vt, v, gk, k0, Skv, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qt[d * kP + 4 * ty + i];
        oa[i] = dOt[d * kP + 4 * ty + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Kt[d * kP + tx + 16 * j];
        vb[j] = Vt[d * kP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            visible(qp, k0 + tx + 16 * j, Sq, Skv, causal, window)
                ? expf(s[i][j] - L[i]) : 0.f;
        dS[(4 * ty + i) * kP + tx + 16 * j] = p * (dp[i][j] - D[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float da[4], kb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = dS[(4 * ty + i) * kP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kb[c] = Kt[(tx + 16 * c) * kP + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] = fmaf(da[i], kb[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st(dq, g.base + qp * g.rs + tx + 16 * c, acc[i][c] * scale);
  }
}

// --------------------------------------------------------- backward, dK dV

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * HD * kP + 2 * kTile * kP + 2 * kTile);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ dout, const float* __restrict__ q,
                      const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Skv, int Hkv,
                      int n_rep, int causal, int window, float scale) {
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* Kt = smem;              // [HD][kP]
  float* Vt = Kt + HD * kP;      // [HD][kP]
  float* Qt = Vt + HD * kP;      // [HD][kP]  q * scale
  float* dOt = Qt + HD * kP;     // [HD][kP]
  float* Pt = dOt + HD * kP;     // [kTile keys][kP queries]
  float* dSt = Pt + kTile * kP;  // [kTile keys][kP queries]
  float* Ls = dSt + kTile * kP;  // [kTile] lse of the q tile's rows
  float* Ds = Ls + kTile;        // [kTile] D of the q tile's rows
  const int bk = blockIdx.x, k0 = blockIdx.y * kTile;
  const int b = bk / Hkv, hk = bk % Hkv, H = Hkv * n_rep;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const Rows gk = rows_of<HD>(b, hk, Skv, Hkv);
  load_t<HD>(Kt, k, gk, k0, Skv, 1.f);
  load_t<HD>(Vt, v, gk, k0, Skv, 1.f);

  // this thread's keys: k0 + 4 * ty + jj; its columns: tx + 16 * c
  float ak[4][NC], av[4][NC];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < NC; ++c) ak[jj][c] = av[jj][c] = 0.f;
  int qt_lo, qt_hi;
  q_range(k0, Sq, causal, window, &qt_lo, &qt_hi);
  const int nq = qt_hi - qt_lo;
  // the q tiles of every query head of kv head hk, one head after another
  for (int step = 0; step < n_rep * nq; ++step) {
    const int h = hk * n_rep + step / nq, q0 = (qt_lo + step % nq) * kTile;
    const Rows g = rows_of<HD>(b, h, Sq, H);
    __syncthreads();
    load_t<HD>(Qt, q, g, q0, Sq, scale);
    load_t<HD>(dOt, dout, g, q0, Sq, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kFlashThreads) {
      const bool in = q0 + r < Sq;
      const size_t e = (static_cast<size_t>(b) * H + h) * Sq + q0 + r;
      Ls[r] = in ? lse[e] : 0.f;
      Ds[r] = in ? delta[e] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];    // [key jj][query i]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jj][i] = dp[jj][i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float ka[4], va[4], qb[4], ob[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ka[jj] = Kt[d * kP + 4 * ty + jj];
        va[jj] = Vt[d * kP + 4 * ty + jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qb[i] = Qt[d * kP + tx + 16 * i];
        ob[i] = dOt[d * kP + tx + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[jj][i] = fmaf(ka[jj], qb[i], s[jj][i]);
          dp[jj][i] = fmaf(va[jj], ob[i], dp[jj][i]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int kp = k0 + 4 * ty + jj;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tx + 16 * i;
        const float p = visible(q0 + r, kp, Sq, Skv, causal, window)
                            ? expf(s[jj][i] - Ls[r]) : 0.f;
        Pt[(4 * ty + jj) * kP + r] = p;
        dSt[(4 * ty + jj) * kP + r] = p * (dp[jj][i] - Ds[r]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pa[4], da[4], ob[NC], qb[NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        pa[jj] = Pt[(4 * ty + jj) * kP + r];
        da[jj] = dSt[(4 * ty + jj) * kP + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ob[c] = dOt[(tx + 16 * c) * kP + r];
        qb[c] = Qt[(tx + 16 * c) * kP + r];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          av[jj][c] = fmaf(pa[jj], ob[c], av[jj][c]);
          ak[jj][c] = fmaf(da[jj], qb[c], ak[jj][c]);
        }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int kp = k0 + 4 * ty + jj;
    if (kp >= Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t e = gk.base + kp * gk.rs + tx + 16 * c;
      st(dk, e, ak[jj][c]);
      st(dv, e, av[jj][c]);
    }
  }
}

// ------------------------------------------------------------- launchers

// Lift the kernel's dynamic shared-memory limit above 48 KB, once per
// instantiation (the first launch comes before any CUDA-graph capture, so
// no attribute call happens while a stream is being captured).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  *done = e == cudaSuccess;
  return e;
}

dim3 grid(int rows, int S) {
  return dim3(static_cast<unsigned>(rows),
              static_cast<unsigned>((S + kTile - 1) / kTile));
}

template <int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const FlashGeo& G) {
  auto kernel = flash_fwd_kernel<HD>;
  static bool ready = false;
  if (cudaError_t e = prepare(kernel, fwd_smem<HD>(), &ready)) return e;
  kernel<<<grid(G.B * G.H, G.Sq), kFlashThreads, fwd_smem<HD>(),
           G.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, G.Sq,
      G.Skv, G.H, G.H / G.Hkv, G.causal, G.window, G.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dq(const void* dout, const void* q, const void* k,
                   const void* v, const void* out, const float* lse,
                   void* dq, float* delta, const FlashGeo& G) {
  auto kernel = flash_bwd_dq_kernel<HD>;
  static bool ready = false;
  if (cudaError_t e = prepare(kernel, dq_smem<HD>(), &ready)) return e;
  kernel<<<grid(G.B * G.H, G.Sq), kFlashThreads, dq_smem<HD>(),
           G.stream>>>(
      static_cast<const float*>(dout), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(out), lse, static_cast<float*>(dq), delta,
      G.Sq, G.Skv, G.H, G.H / G.Hkv, G.causal, G.window, G.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t bwd_dkdv(const void* dout, const void* q, const void* k,
                     const void* v, const float* lse, const float* delta,
                     void* dk, void* dv, const FlashGeo& G) {
  auto kernel = flash_bwd_dkdv_kernel<HD>;
  static bool ready = false;
  if (cudaError_t e = prepare(kernel, dkdv_smem<HD>(), &ready)) return e;
  kernel<<<grid(G.B * G.Hkv, G.Skv), kFlashThreads, dkdv_smem<HD>(),
           G.stream>>>(
      static_cast<const float*>(dout), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), G.Sq, G.Skv, G.Hkv,
      G.H / G.Hkv, G.causal, G.window, G.scale);
  return cudaGetLastError();
}

bool valid_geo(int dtype, int hd, const FlashGeo& G) {
  return (dtype == 0 || dtype == 1) && (hd == 64 || hd == 96 || hd == 128) &&
         G.B >= 1 && G.Sq >= 1 && G.Skv >= 1 && G.H >= 1 && G.Hkv >= 1 &&
         G.H % G.Hkv == 0 && G.window >= 0 &&
         (G.Sq == G.Skv || (!G.causal && !G.window)) &&
         static_cast<long long>(G.B) * G.H < (1LL << 31) &&
         (G.Sq + kTile - 1) / kTile <= 65535 &&
         (G.Skv + kTile - 1) / kTile <= 65535;
}

// f32 on the CUDA cores; hd in {64, 96, 128}
#define REPRO_FLASH_F32_DISPATCH(FN, ...)                               \
  switch (hd) {                                                         \
    case 64: return FN<64>(__VA_ARGS__);                                \
    case 96: return FN<96>(__VA_ARGS__);                                \
    case 128: return FN<128>(__VA_ARGS__);                              \
    default: return cudaErrorInvalidValue;                              \
  }

cudaError_t fwd_f32(int hd, const void* q, const void* k, const void* v,
                    void* out, float* lse, const FlashGeo& G) {
  REPRO_FLASH_F32_DISPATCH(fwd, q, k, v, out, lse, G)
}
cudaError_t bwd_dq_f32(int hd, const void* dout, const void* q,
                       const void* k, const void* v, const void* out,
                       const float* lse, void* dq, float* delta,
                       const FlashGeo& G) {
  REPRO_FLASH_F32_DISPATCH(bwd_dq, dout, q, k, v, out, lse, dq, delta, G)
}
cudaError_t bwd_dkdv_f32(int hd, const void* dout, const void* q,
                         const void* k, const void* v, const float* lse,
                         const float* delta, void* dk, void* dv,
                         const FlashGeo& G) {
  REPRO_FLASH_F32_DISPATCH(bwd_dkdv, dout, q, k, v, lse, delta, dk, dv, G)
}

// launches per kernel (fwd, dq, dkdv) and design (0: f32 on the CUDA
// cores here, 1: bf16 on the tensor cores, flash_attention_sm90.cu)
long long g_launches[3][2] = {};

cudaError_t counted(cudaError_t e, int kernel, int dtype) {
  if (e == cudaSuccess) ++g_launches[kernel][dtype];
  return e;
}

}  // namespace

using repro_torch::FlashGeo;
using repro_torch::flash_bwd_dkdv_sm90;
using repro_torch::flash_bwd_dq_sm90;
using repro_torch::flash_fwd_sm90;

// q, out: (B, Sq, H, hd), k, v: (B, Skv, Hkv, hd), contiguous in dtype
// (0 = float32, 1 = bfloat16); lse: (B, H, Sq) f32. Sq != Skv only with
// causal and window 0.
extern "C" int flash_fwd(int dtype, int hd, const void* q, const void* k,
                         const void* v, void* out, void* lse, int B, int Sq,
                         int Skv, int H, int Hkv, int causal, int window,
                         float scale, void* stream) {
  const FlashGeo G{B, Sq, Skv, H, Hkv, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  if (!valid_geo(dtype, hd, G)) return cudaErrorInvalidValue;
  auto* lse_f = static_cast<float*>(lse);
  return counted(dtype == 1 ? flash_fwd_sm90(hd, q, k, v, out, lse_f, G)
                            : fwd_f32(hd, q, k, v, out, lse_f, G),
                 0, dtype);
}

// dout, q, out, dq: (B, Sq, H, hd), k, v: (B, Skv, Hkv, hd) in dtype;
// lse, delta: (B, H, Sq) f32 (delta is written: D = rowsum(dout * out)).
extern "C" int flash_bwd_dq(int dtype, int hd, const void* dout,
                            const void* q, const void* k, const void* v,
                            const void* out, const void* lse, void* dq,
                            void* delta, int B, int Sq, int Skv, int H,
                            int Hkv, int causal, int window, float scale,
                            void* stream) {
  const FlashGeo G{B, Sq, Skv, H, Hkv, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  if (!valid_geo(dtype, hd, G)) return cudaErrorInvalidValue;
  const auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  return counted(
      dtype == 1
          ? flash_bwd_dq_sm90(hd, dout, q, k, v, out, lse_f, dq, delta_f, G)
          : bwd_dq_f32(hd, dout, q, k, v, out, lse_f, dq, delta_f, G),
      1, dtype);
}

// dout, q: (B, Sq, H, hd), k, v, dk, dv: (B, Skv, Hkv, hd) in dtype; lse,
// delta: (B, H, Sq) f32 (delta as flash_bwd_dq wrote it).
extern "C" int flash_bwd_dkdv(int dtype, int hd, const void* dout,
                              const void* q, const void* k, const void* v,
                              const void* lse, const void* delta, void* dk,
                              void* dv, int B, int Sq, int Skv, int H,
                              int Hkv, int causal, int window, float scale,
                              void* stream) {
  const FlashGeo G{B, Sq, Skv, H, Hkv, causal, window, scale,
                   static_cast<cudaStream_t>(stream)};
  if (!valid_geo(dtype, hd, G)) return cudaErrorInvalidValue;
  const auto* lse_f = static_cast<const float*>(lse);
  const auto* delta_f = static_cast<const float*>(delta);
  return counted(
      dtype == 1
          ? flash_bwd_dkdv_sm90(hd, dout, q, k, v, lse_f, delta_f, dk, dv, G)
          : bwd_dkdv_f32(hd, dout, q, k, v, lse_f, delta_f, dk, dv, G),
      2, dtype);
}

// counts[2 * kernel + design] = launches so far (kernel: 0 fwd, 1 dq,
// 2 dkdv; design: 0 f32 CUDA cores, 1 bf16 tensor cores)
extern "C" void flash_design_counts(long long* counts) {
  for (int k = 0; k < 3; ++k)
    for (int d = 0; d < 2; ++d) counts[2 * k + d] = g_launches[k][d];
}
