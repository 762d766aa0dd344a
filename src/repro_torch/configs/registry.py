"""Architecture registry: --arch <id> -> ModelConfig.

The port has the paper's own CNN, the dense transformer minitron-8b and
the RWKV-6 model rwkv6-3b; the other LLM families join with their
models.

Also the config-side door to the environment and scenario registries
(``repro_torch.env``): ``get_scenario`` / ``scenario_names`` resolve a
named experimental condition to FLConfig knobs (lazy imports: the env
package imports configs.base, so it must not be imported at this
module's import time)."""
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


def serving_config(name: str) -> ModelConfig:
    """Config used for decode shapes (long-context variants where
    needed): minitron-8b serves its sliding-window variant."""
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
