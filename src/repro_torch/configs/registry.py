"""Architecture registry: --arch <id> -> ModelConfig.

The port has the paper's own CNN and the dense transformer minitron-8b;
the other LLM families join with their models."""
from __future__ import annotations

from repro_torch.configs import minitron_8b, paper_cnn
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "minitron-8b": minitron_8b.CONFIG,
    "paper-cnn": paper_cnn.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
