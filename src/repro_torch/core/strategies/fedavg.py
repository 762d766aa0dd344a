"""Naive FL baseline (the paper's "FedAvg"): weighted average of the
clients that both finished (not computing-limited) and arrived on time;
no mixing with the previous model, no staleness handling."""
from __future__ import annotations

import torch

from repro_torch.core.ama import fedavg_aggregate
from repro_torch.core.strategies.base import (ServerStrategy,
                                              reduced_mix_update, register)
from repro_torch.kernels.server_plane import (mix_coefs,
                                              server_mix_compressed_tree,
                                              server_mix_tree)


@register
class FedAvgStrategy(ServerStrategy):
    name = "fedavg"

    def aggregate(self, t, prev_global, client_params, sched, aux_state):
        del t
        keep = ~sched["delayed"] & ~sched["limited"]
        return fedavg_aggregate(prev_global, client_params,
                                sched["data_sizes"], keep,
                                use_kernel=self.fl.use_kernel), aux_state

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        if self.server_impl == "legacy":
            return self.aggregate(t, prev_global, client_params, sched,
                                  aux_state)
        keep = (~sched["delayed"] & ~sched["limited"]).float()
        # adaptive=False zeroes the alpha schedule: the plain weighted
        # average is the alpha=0 corner of the same fused pass
        new_global = server_mix_tree(
            prev_global, client_params, sched["data_sizes"], keep,
            mix_coefs(self.fl, t, adaptive=False), impl=self.server_impl)
        return new_global, aux_state

    def compressed_server_update(self, t, prev_global, groups, sched,
                                 aux_state):
        """The alpha=0 corner of the compressed mix."""
        if self.server_impl == "legacy":
            return NotImplemented
        keep = (~sched["delayed"] & ~sched["limited"]).float()
        new_global = server_mix_compressed_tree(
            prev_global, groups, sched["data_sizes"], keep,
            mix_coefs(self.fl, t, adaptive=False), impl=self.server_impl)
        return new_global, aux_state

    def reduced_server_update(self, t, prev_global, client_params, sched,
                              aux_state):
        keep = (~sched["delayed"] & ~sched["limited"]).float()
        alpha = torch.zeros((), dtype=torch.float32, device=keep.device)
        return reduced_mix_update(prev_global, client_params, sched, keep,
                                  alpha), aux_state
