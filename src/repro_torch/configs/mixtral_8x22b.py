"""Mixtral 8x22B — 8 experts top-2, sliding-window attn [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
A window of 4096 in training (the flash kernels' window) and in serving
(a ring cache of 4096 slots): it serves its own config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    num_experts=8,
    top_k=2,
    sliding_window=4096,
    moe_group_size=4096,   # blocked dispatch: linear-in-T dispatch FLOPs
    train_fsdp=True,
    serve_2d=True,
    source="arXiv:2401.04088",
)
