"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400, 16 experts top-2, vocab=32064.
The port trains it federatedly on the pod path (``launch.train --pod``;
each block's MLP is ``models/moe.py``: top-2 of 16 experts, capacity
dispatch in groups of ``moe_group_size`` tokens) and serves it through
``launch.serve`` (``moe.moe_serve``: every expert on the row-invariant
GEMM).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    num_experts=16,
    top_k=2,
    moe_group_size=4096,   # blocked dispatch: linear-in-T dispatch FLOPs
    train_fsdp=True,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
