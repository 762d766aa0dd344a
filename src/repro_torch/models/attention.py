"""Attention: GQA + RoPE + optional sliding window, on the flash kernel.

The port of the JAX package's ``models/attention.py`` for full-sequence
self-attention (train): ``attn_init``, ``_split_heads`` and
``attention_fwd``. The JAX model repeats kv to the query heads
(``_repeat_kv``) and runs the XLA ``chunked_attention``; the port hands
``kernels.flash_attention`` the kv heads as they are (its kernels read
kv head h // n_rep for query head h: the same math without the copy and
without autograd's sum of the copies' gradients) and runs the
hand-written CUDA kernels on the card, their plain version on the CPU.
The tests hold the port against JAX's own ``chunked_attention``.
Decode, chunked prefill and the paged KV pool wait for the serving slice;
cross-attention waits for the encoder-decoder family.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense, dense_init


def attn_init(gen: torch.Generator, cfg, dtype) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype,
                         cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                         cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                         cfg.qkv_bias),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }


def _split_heads(x, n_heads: int, hd: int):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def attention_fwd(p, cfg, x, positions, *, causal=True, window=None):
    """Full-sequence self-attention (train). x: (B, S, d); positions:
    (B, S), the aligned 0..S-1 of ``transformer.embed_inputs`` (the
    kernel masks by row and column index, which equal those positions).

    q is scaled by hd**-0.5 in the model dtype before the kernel, which
    then runs with scale 1.0: the JAX model's ``chunked_attention``
    rounds ``q * scale`` in the model dtype before its f32 cast, so a
    bf16 model rounds at the same place in both packages.
    """
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(p["wq"], x), cfg.num_heads, hd)
    k = _split_heads(dense(p["wk"], x), cfg.num_kv_heads, hd)
    v = _split_heads(dense(p["wv"], x), cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    w = cfg.sliding_window if window is None else window
    out = flash_attention(q * hd ** -0.5, k, v, causal=causal, window=w,
                          scale=1.0)
    return dense(p["wo"], out.reshape(*x.shape[:-1], cfg.num_heads * hd))
