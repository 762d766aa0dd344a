"""Synchronous AMA (paper Eq. 5) as a ServerStrategy.

Client side this is the paper's AMA-FES pairing: when FES is enabled the
gradient of computing-limited devices is masked to the classifier split
(Eq. 2) via ``masked_update`` on the masked client plane, and only the
classifier is differentiated on the partitioned one (Eq. 3).
"""
from __future__ import annotations

from repro_torch.core.ama import alpha_schedule, ama_aggregate
from repro_torch.core.strategies.base import (ServerStrategy,
                                              reduced_mix_update, register)
from repro_torch.kernels.server_plane import (mix_coefs,
                                              server_mix_compressed_tree,
                                              server_mix_tree)
from repro_torch.optim.masked import masked_update


@register
class AMAStrategy(ServerStrategy):
    name = "ama"
    aliases = ("ama_fes",)   # resolve() picks async when max_delay > 0

    def local_grad_transform(self, grads, params, global_params, fes_mask,
                             limited):
        del params, global_params
        if self.fl.fes_enabled:
            return masked_update(grads, fes_mask, limited)
        return grads

    @property
    def limited_mode(self) -> str:
        """Partitioned plane: limited cohorts differentiate only the
        classifier when FES is on, the executed counterpart of the
        masked plane's zeroed body gradients."""
        return "classifier" if self.fl.fes_enabled else "full"

    def mix_coefficient(self, t, sched, aux_state):
        """Eq. 5: alpha_t = min(alpha0 + eta * t, cap), the schedule the
        mix applies this round."""
        del sched, aux_state
        return alpha_schedule(self.fl, t)

    def aggregate(self, t, prev_global, client_params, sched, aux_state):
        new_global = ama_aggregate(
            self.fl, t, prev_global, client_params, sched["data_sizes"],
            ~sched["delayed"], use_kernel=self.fl.use_kernel)
        return new_global, aux_state

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        if self.server_impl == "legacy":
            return self.aggregate(t, prev_global, client_params, sched,
                                  aux_state)
        keep = (~sched["delayed"]).float()
        new_global = server_mix_tree(
            prev_global, client_params, sched["data_sizes"], keep,
            mix_coefs(self.fl, t), impl=self.server_impl)
        return new_global, aux_state

    def compressed_server_update(self, t, prev_global, groups, sched,
                                 aux_state):
        """Eq. 5 mix consuming compressed deltas in-kernel (q8/bf16 rows
        or top-k pairs); "legacy" has no compressed path, so the round
        densifies the payload."""
        if self.server_impl == "legacy":
            return NotImplemented
        keep = (~sched["delayed"]).float()
        new_global = server_mix_compressed_tree(
            prev_global, groups, sched["data_sizes"], keep,
            mix_coefs(self.fl, t), impl=self.server_impl)
        return new_global, aux_state

    def reduced_server_update(self, t, prev_global, client_params, sched,
                              aux_state):
        keep = (~sched["delayed"]).float()
        return reduced_mix_update(prev_global, client_params, sched, keep,
                                  alpha_schedule(self.fl, t)), aux_state
