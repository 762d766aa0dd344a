"""Architecture registry: --arch <id> -> ModelConfig.

The port's slice covers the paper's own CNN only; the LLM families join
with their models."""
from __future__ import annotations

from repro_torch.configs import paper_cnn
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "paper-cnn": paper_cnn.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
