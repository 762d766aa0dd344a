"""Heterogeneous-environment subsystem (numpy host plane). Importing this
package registers the environments the port has: ``bernoulli`` (alias
``iid_delay``) and ``bandwidth`` (alias ``snr``). Use ``resolve(fl)`` to
get the environment for a config.
"""
from repro_torch.env.base import (ChannelModel, DeviceProfile, Environment,
                                  RoundSchedule, get, names, register,
                                  resolve, round_rng)
from repro_torch.env.bandwidth import BandwidthEnvironment
from repro_torch.env.bernoulli import BernoulliEnvironment

__all__ = ["Environment", "ChannelModel", "DeviceProfile", "RoundSchedule",
           "BandwidthEnvironment", "BernoulliEnvironment", "register",
           "resolve", "get", "names", "round_rng"]
