"""FedOpt: server-side Adam on the aggregated pseudo-gradient (Reddi et
al. 2021's FedAdam).

The on-time weighted average of client models defines a pseudo-gradient
Delta_t = agg_t - omega_{t-1}; the server applies one Adam step with its
own (lr, b1, b2, tau) instead of AMA's convex mix, in one fused kernel
call per dtype group (``server_adam_tree``). Aux state is {m, v: f32
trees like the params, step: a 0-dim int32 device tensor}. Client side
it inherits AMA's FES masking.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies.ama import AMAStrategy
from repro_torch.core.strategies.base import ServerStrategy, register
from repro_torch.kernels.server_plane import device_vector, server_adam_tree
from repro_torch.utils.tree import leaves, tree_map


@register
class FedOptStrategy(AMAStrategy):
    name = "fedopt"
    aliases = ()

    # server-Adam is not linear in the client deltas (second moment,
    # square root): the round densifies a compressed payload first
    compressed_server_update = ServerStrategy.compressed_server_update

    def init_state(self, params):
        def zeros():
            return tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        fl = self.fl
        keep = (~sched["delayed"]).float()
        step = aux_state["step"] + 1
        scalars = device_vector((fl.server_b1, fl.server_b2, fl.server_lr,
                                 fl.server_tau, 0.0), t.device)
        scalars[4] = step
        new_global, m, v = server_adam_tree(
            prev_global, client_params, aux_state["m"], aux_state["v"],
            sched["data_sizes"], keep, scalars, impl=self.server_impl)
        return new_global, {"m": m, "v": v, "step": step}
