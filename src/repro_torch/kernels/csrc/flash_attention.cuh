// What the two flash-attention sources share: the geometry of a call and
// the tensor-core (bf16) kernels' launchers, which flash_attention.cu's C
// entries call for bf16 inputs (flash_attention_sm90.cu defines them).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd), H % Hkv == 0; Sq != Skv
// only when causal and window are 0 (cross-attention)
struct FlashGeo {
  int B, Sq, Skv, H, Hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

cudaError_t flash_fwd_sm90(int hd, const void* q, const void* k,
                           const void* v, void* out, float* lse,
                           const FlashGeo& G);
cudaError_t flash_bwd_dq_sm90(int hd, const void* dout, const void* q,
                              const void* k, const void* v, const void* out,
                              const float* lse, void* dq, float* delta,
                              const FlashGeo& G);
cudaError_t flash_bwd_dkdv_sm90(int hd, const void* dout, const void* q,
                                const void* k, const void* v,
                                const float* lse, const float* delta,
                                void* dk, void* dv, const FlashGeo& G);

}  // namespace repro_torch
