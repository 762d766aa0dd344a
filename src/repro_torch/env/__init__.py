"""Heterogeneous-environment subsystem (numpy host plane). Importing this
package registers the built-in environments, as the JAX package's does:

    bernoulli (alias iid_delay) | gilbert_elliott (ge, bursty)
    | bandwidth (snr) | trace (mobility)

Use ``resolve(fl)`` to get the environment for a config (``fl.env``),
``get(name)`` / ``names()`` to address the registry directly, and
``scenarios`` for named environment + FLConfig-knob bindings.
"""
from repro_torch.env import scenarios
from repro_torch.env.bandwidth import BandwidthEnvironment
from repro_torch.env.base import (ChannelModel, DeviceProfile, Environment,
                                  FixedTierProfile, Participation,
                                  RoundSchedule, UniformParticipation,
                                  VirtualTierProfile, get, names, register,
                                  resolve, round_rng, side_rng)
from repro_torch.env.bernoulli import BernoulliEnvironment
from repro_torch.env.gilbert_elliott import GilbertElliottEnvironment
from repro_torch.env.trace import (TraceEnvironment, save_trace,
                                   synth_mobility_trace)
from repro_torch.env.virtual import (DENSE_SELECT_MAX, VIRTUAL_K_MIN,
                                     VirtualPopulation, floyd_sample,
                                     hash_u01, is_virtual,
                                     select_batch_hashed)

__all__ = ["Environment", "ChannelModel", "DeviceProfile", "Participation",
           "RoundSchedule", "FixedTierProfile", "UniformParticipation",
           "VirtualTierProfile", "VirtualPopulation", "is_virtual",
           "floyd_sample", "select_batch_hashed", "hash_u01",
           "DENSE_SELECT_MAX", "VIRTUAL_K_MIN",
           "register", "resolve", "get", "names", "round_rng", "side_rng",
           "scenarios", "BernoulliEnvironment", "GilbertElliottEnvironment",
           "BandwidthEnvironment", "TraceEnvironment", "save_trace",
           "synth_mobility_trace"]
