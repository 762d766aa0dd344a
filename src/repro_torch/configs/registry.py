"""Architecture registry: --arch <id> -> ModelConfig.

The port has the paper's own CNN, the dense transformer minitron-8b and
the RWKV-6 model rwkv6-3b; the other LLM families join with their
models."""
from __future__ import annotations

from repro_torch.configs import minitron_8b, paper_cnn, rwkv6_3b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "minitron-8b": minitron_8b.CONFIG,
    "paper-cnn": paper_cnn.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
