"""Pluggable server-strategy subsystem. Importing this package registers
the strategies the port has:

    ama (alias ama_fes) | async_ama | fedavg | fedprox | fedopt

Use ``resolve(fl)`` to get the strategy instance for a config.
"""
from repro_torch.core.strategies.base import (ServerStrategy, get, names,
                                              register, resolve)
from repro_torch.core.strategies.ama import AMAStrategy
from repro_torch.core.strategies.async_ama import AsyncAMAStrategy
from repro_torch.core.strategies.fedavg import FedAvgStrategy
from repro_torch.core.strategies.fedopt import FedOptStrategy
from repro_torch.core.strategies.fedprox import FedProxStrategy

__all__ = ["ServerStrategy", "register", "resolve", "get", "names",
           "AMAStrategy", "AsyncAMAStrategy", "FedAvgStrategy",
           "FedOptStrategy", "FedProxStrategy"]
