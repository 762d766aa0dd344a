"""FedProx baseline (paper Eq. 4): proximal gradient pull toward the
global model plus "partial work" — computing-limited devices run a
fraction of the local steps instead of masking gradients. Server side
it is the on-time weighted average, the alpha = 0 corner of the mix."""
from __future__ import annotations

import torch

from repro_torch.core.ama import fedavg_aggregate
from repro_torch.core.strategies.base import (ServerStrategy,
                                              reduced_mix_update, register)
from repro_torch.kernels.server_plane import (mix_coefs,
                                              server_mix_compressed_tree,
                                              server_mix_tree)
from repro_torch.utils.tree import tree_map


@register
class FedProxStrategy(ServerStrategy):
    name = "fedprox"

    def local_grad_transform(self, grads, params, global_params, fes_mask,
                             limited):
        """g + 2 rho (p - p0) over the stacked (C, ...) client grads."""
        del fes_mask, limited
        rho = self.fl.fedprox_rho
        return tree_map(
            lambda g, p, p0: g + 2.0 * rho * (p.float()
                                              - p0.float()).to(g.dtype),
            grads, params, global_params)

    def local_steps(self, n_steps: int, limited):
        """Partial work: limited clients update for only
        ``static_local_steps(n_steps)`` of the steps."""
        n_partial = self.static_local_steps(n_steps)
        return torch.where(limited, n_partial, n_steps).to(torch.int32)

    def static_local_steps(self, n_steps: int) -> int:
        """``max(1, int(fedprox_partial * n_steps))``: the partitioned
        plane's limited cohorts run only this many steps, where the
        masked plane runs them all and freezes the params after."""
        return max(1, int(self.fl.fedprox_partial * n_steps))

    def aggregate(self, t, prev_global, client_params, sched, aux_state):
        del t
        return fedavg_aggregate(prev_global, client_params,
                                sched["data_sizes"], ~sched["delayed"],
                                use_kernel=self.fl.use_kernel), aux_state

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        if self.server_impl == "legacy":
            return self.aggregate(t, prev_global, client_params, sched,
                                  aux_state)
        keep = (~sched["delayed"]).float()
        new_global = server_mix_tree(
            prev_global, client_params, sched["data_sizes"], keep,
            mix_coefs(self.fl, t, adaptive=False), impl=self.server_impl)
        return new_global, aux_state

    def compressed_server_update(self, t, prev_global, groups, sched,
                                 aux_state):
        """On-time weighted average (alpha = 0) over compressed deltas."""
        if self.server_impl == "legacy":
            return NotImplemented
        keep = (~sched["delayed"]).float()
        new_global = server_mix_compressed_tree(
            prev_global, groups, sched["data_sizes"], keep,
            mix_coefs(self.fl, t, adaptive=False), impl=self.server_impl)
        return new_global, aux_state

    def reduced_server_update(self, t, prev_global, client_params, sched,
                              aux_state):
        keep = (~sched["delayed"]).float()
        alpha = torch.zeros((), dtype=torch.float32, device=keep.device)
        return reduced_mix_update(prev_global, client_params, sched, keep,
                                  alpha), aux_state
