"""The system under test: the port's pod path, built as the port's
launcher builds it (``launch/train.py: pod_scale``) and driven one
round a call.

``Program`` holds one ``ChunkRunner(per_round_batch=False)`` and the
round state of ``core.round.init_state``, its weights drawn on the
device from a generator seeded by the run's seed. ``round(r)`` feeds
round r of the traffic (``traffic.py``) to ``run_chunk`` with
``scan_ok=False`` (the ``--no-scan`` mode); the call ends in the
metrics' copy to the host, so each round is closed by a device sync.
Nothing else of the port is called.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import traffic as tr
from portbench.reference.model import leaves
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core import strategies
from repro_torch.core.round import init_state
from repro_torch.exec.engine import ChunkRunner
from repro_torch.models.api import build_model
from repro_torch.utils.device import resolve_device

def model_config(cfg: dict) -> ModelConfig:
    """The port's ModelConfig of a configuration file (its other keys,
    such as ``assumed``, are the benchmark's)."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def fl_config(traffic: dict, seed: int) -> FLConfig:
    C = traffic["cohorts"]
    return FLConfig(num_clients=C, clients_per_round=C, cohorts=C,
                    local_steps=traffic["local_steps"], lr=traffic["lr"],
                    alpha0=traffic["alpha0"], eta=traffic["eta"],
                    alpha_cap=traffic["alpha_cap"],
                    p_limited=traffic["p_limited"],
                    algorithm=traffic["algorithm"],
                    client_plane=traffic["client_plane"],
                    seed=tr.stream_seed(seed, "fl") % (1 << 31))


class Program:
    """The port's pod path at one configuration and traffic."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.device = resolve_device(device)
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        model = build_model(model_config(cfg))
        fl = fl_config(traffic, seed)
        if fault is not None:
            model = fault.model(model, traffic)
        strategy = strategies.resolve(fl)
        self.state = init_state(model, fl,
                                tr.weights_generator(seed, self.device),
                                self.device, strategy)
        self.runner = ChunkRunner(model, fl, strategy, per_round_batch=False,
                                  use_scan=False, device=self.device)
        self.fault = fault

    def feed(self, r: int):
        """(batch, schedule) of round r."""
        tokens = tr.round_tokens(self.traffic, self.cfg["vocab_size"],
                                 self.seed, r, self.device)
        return {"tokens": tokens}, tr.round_schedule(self.traffic, self.seed,
                                                     r)

    def round(self, r: int) -> float:
        """Round r through ``ChunkRunner.run_chunk``; its mean loss."""
        batch, sched = self.feed(r)
        prev = self.state
        self.state, m = self.runner.run_chunk(prev, batch, sched,
                                              scan_ok=False)
        if self.fault is not None:
            self.state = self.fault.after_round(prev, self.state)
        return float(m["loss"][0])

    def params(self):
        return self.state["params"]

    def close(self) -> None:
        """Free the device state."""
        self.state = self.runner = None


def host_copy(tree) -> list:
    """The leaves of a params tree copied to pinned host memory."""
    out = []
    for _, x in leaves(tree):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        h.copy_(x)
        out.append(h)
    return out
