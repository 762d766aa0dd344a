"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family card] — GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
A dense-family config with a bias on wq, wk and wv (``qkv_bias``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    d_ff=49152,
    vocab_size=152064,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    qkv_bias=True,
    train_fsdp=True,
    serve_2d=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
