"""Scenario registry: a name -> (environment, FLConfig knobs) binding.

A *scenario* is a reproducible experimental condition — the paper's
"moderate 30% delay" is one point; the registry makes the whole
algorithm x environment cross-product addressable by name from every
entry point (``--scenario`` on the launcher / examples, the
delay-tolerance benchmark, tests):

    fl = scenarios.apply(FLConfig(), "bursty")
    environment = env.resolve(fl)

The port's copy of the JAX package's ``env/scenarios.py``: the same
names, environments and overrides.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import FLConfig


@dataclass(frozen=True)
class Scenario:
    name: str
    env: str                       # environment registry key
    overrides: dict = field(default_factory=dict)   # FLConfig knobs
    description: str = ""

    def apply(self, fl: FLConfig) -> FLConfig:
        return fl.with_(env=self.env, **self.overrides)


_SCENARIOS: dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    assert sc.name not in _SCENARIOS, sc.name
    _SCENARIOS[sc.name] = sc
    return sc


def names() -> list[str]:
    return sorted(_SCENARIOS)


def get(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {names()}") from None


def apply(fl: FLConfig, name: str) -> FLConfig:
    """FLConfig with the named scenario's environment + knobs applied."""
    return get(name).apply(fl)


# ---------------------------------------------------------------------------
# built-in scenarios (paper §V points + beyond-paper channel models)
# ---------------------------------------------------------------------------
register(Scenario("clear", "bernoulli", {"p_delay": 0.0, "max_delay": 0},
                  "no transmission delay (paper's synchronous setting)"))
register(Scenario("moderate-30", "bernoulli",
                  {"p_delay": 0.3, "max_delay": 10},
                  "paper Fig. 3 moderate: 30% i.i.d. delay, max 10 rounds"))
register(Scenario("severe-70", "bernoulli",
                  {"p_delay": 0.7, "max_delay": 10},
                  "paper Fig. 3 severe: 70% i.i.d. delay, max 10 rounds"))
register(Scenario("bursty", "gilbert_elliott", {"max_delay": 10},
                  "Gilbert-Elliott fading: correlated outage bursts"))
register(Scenario("bursty-severe", "gilbert_elliott",
                  {"max_delay": 15, "ge_p_gb": 0.35, "ge_p_bg": 0.25},
                  "deep-fade regime: long Bad-state dwell, staleness 15"))
register(Scenario("bandwidth-limited", "bandwidth", {"max_delay": 10},
                  "log-normal uplink rate vs a round deadline"))
register(Scenario("mobility-trace", "trace",
                  {"max_delay": 10, "trace_path": ""},
                  "synthetic mobility replay: coverage-gated availability"))
