"""Zamba2-1.2B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

38 Mamba2 blocks, d_model=2048, shared attn (32H MHA) every 6 blocks,
d_ff=8192, vocab=32000, ssm_state=64. The port trains it federatedly on
the pod path (``launch.train --pod``), the SSD recurrence on the
hand-written mamba2 kernels and the shared attention on the flash
kernels, and serves it per token (``launch.serve``, the loop engine).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    ssm_state=64,
    attn_every=6,
    shared_attn=True,
    source="arXiv:2411.15242",
)
