"""Mistral-Large-2407 123B [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
A dense-family config: the minitron-8b path at other widths.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    d_ff=28672,
    vocab_size=32768,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    train_fsdp=True,
    serve_2d=True,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)
