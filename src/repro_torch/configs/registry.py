"""Architecture registry: --arch <id> -> ModelConfig.

The port has the paper's own CNN, the dense transformers minitron-8b,
llama3-405b, mistral-large-123b and qwen1.5-110b, the mixture-of-experts
transformers phi3.5-moe-42b-a6.6b and mixtral-8x22b, and the RWKV-6
model rwkv6-3b, the hybrid zamba2-1.2b (Mamba-2 blocks and one shared
attention block), the vision-language phi-3-vision-4.2b (patch
embeddings projected before the tokens) and the encoder-decoder
whisper-medium: every model of the JAX package's registry.

Also the config-side door to the environment and scenario registries
(``repro_torch.env``): ``get_scenario`` / ``scenario_names`` resolve a
named experimental condition to FLConfig knobs (lazy imports: the env
package imports configs.base, so it must not be imported at this
module's import time)."""
from __future__ import annotations

from repro_torch.configs import (llama3_405b, minitron_8b,
                                 mistral_large_123b, mixtral_8x22b,
                                 paper_cnn, phi3_vision_4b, phi35_moe_42b,
                                 qwen15_110b, rwkv6_3b, whisper_medium,
                                 zamba2_1b)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "mistral-large-123b": mistral_large_123b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "qwen1.5-110b": qwen15_110b.CONFIG,
    "zamba2-1.2b": zamba2_1b.CONFIG,
    "phi-3-vision-4.2b": phi3_vision_4b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "paper-cnn": paper_cnn.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def serving_config(name: str) -> ModelConfig:
    """Config used for decode shapes (long-context variants where
    needed): minitron-8b serves its sliding-window variant; mixtral-8x22b
    its own windowed config."""
    cfg = get_arch(name)
    if name == "minitron-8b":
        return minitron_8b.CONFIG_SWA
    return cfg


def get_scenario(name: str):
    """Named scenario -> Scenario (see repro_torch.env.scenarios)."""
    from repro_torch.env import scenarios
    return scenarios.get(name)


def scenario_names() -> list[str]:
    from repro_torch.env import scenarios
    return scenarios.names()


def environment_names() -> list[str]:
    from repro_torch import env
    return env.names()
