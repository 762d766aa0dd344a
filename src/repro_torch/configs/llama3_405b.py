"""Llama-3.1 405B [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
A dense-family config: the minitron-8b path at other widths. One layer
with its embedding and head is 7.39 B parameters, so its pod path at 2
cohorts does not fit one 80 GB card at any depth; it serves at a cut
depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128256,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    train_fsdp=True,
    serve_2d=True,
    source="arXiv:2407.21783",
)
