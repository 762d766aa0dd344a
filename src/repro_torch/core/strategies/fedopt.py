"""FedOpt: server-side Adam on the aggregated pseudo-gradient (Reddi et
al. 2021's FedAdam).

The on-time weighted average of client models defines a pseudo-gradient
Delta_t = agg_t - omega_{t-1}; the server applies one Adam step with its
own (lr, b1, b2, tau) instead of AMA's convex mix, in one fused kernel
call per dtype group (``server_adam_tree``), or, under ``server_plane
== "legacy"``, through the per-leaf chain whose step is the ``ama_mix``
kernel with K = 1, alpha = 1, w = [lr] when ``use_kernel``. Aux state is
{m, v: f32 trees like the params, step: a 0-dim int32 device tensor}.
Client side it inherits AMA's FES masking.
"""
from __future__ import annotations

import torch

from repro_torch.core.ama import count_plain_mix, on_time_aggregate
from repro_torch.core.strategies.ama import AMAStrategy
from repro_torch.core.strategies.base import ServerStrategy, register
from repro_torch.kernels.ops import ama_mix_tree
from repro_torch.kernels.ref import _norm_weights
from repro_torch.kernels.server_plane import device_vector, server_adam_tree
from repro_torch.utils.reduce import reduce_leading
from repro_torch.utils.tree import leaves, tree_map


@register
class FedOptStrategy(AMAStrategy):
    name = "fedopt"
    aliases = ()

    # server-Adam is not linear in the client deltas (second moment,
    # square root): the round densifies a compressed payload first
    compressed_server_update = ServerStrategy.compressed_server_update
    # an Adam step, not a convex mix: alpha_eff is 0 as for the
    # weighted-average rules
    mix_coefficient = ServerStrategy.mix_coefficient

    def init_state(self, params):
        def zeros():
            return tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    def _adam(self, delta, aux_state):
        """(m, v, step, update) of one server-Adam step on ``delta``."""
        fl = self.fl
        step = aux_state["step"] + 1
        m = tree_map(lambda mm, d: fl.server_b1 * mm
                     + (1.0 - fl.server_b1) * d, aux_state["m"], delta)
        v = tree_map(lambda vv, d: fl.server_b2 * vv
                     + (1.0 - fl.server_b2) * d * d, aux_state["v"], delta)
        sf = step.float()
        bc1 = 1.0 - torch.full_like(sf, fl.server_b1) ** sf
        bc2 = 1.0 - torch.full_like(sf, fl.server_b2) ** sf
        update = tree_map(lambda mm, vv: (mm / bc1)
                          / (torch.sqrt(vv / bc2) + fl.server_tau), m, v)
        return m, v, step, update

    def aggregate(self, t, prev_global, client_params, sched, aux_state):
        del t  # fedopt keys its schedule on its own step counter
        fl = self.fl
        agg = on_time_aggregate(prev_global, client_params,
                                sched["data_sizes"], ~sched["delayed"])
        delta = tree_map(lambda a, p: a.float() - p.float(), agg,
                         prev_global)
        m, v, step, update = self._adam(delta, aux_state)
        if fl.use_kernel:
            # prev + lr * update == 1 * prev + sum_k w_k * stacked_k
            # with K = 1, w = [lr]: the general mix kernel
            lr = torch.full((1,), fl.server_lr, dtype=torch.float32,
                            device=step.device)
            new_global = ama_mix_tree(prev_global,
                                      tree_map(lambda u: u[None], update),
                                      1.0, lr)
        else:
            def apply(p, u):
                count_plain_mix(p)
                return (p.float() + fl.server_lr * u).to(p.dtype)
            new_global = tree_map(apply, prev_global, update)
        return new_global, {"m": m, "v": v, "step": step}

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        if self.server_impl == "legacy":
            return self.aggregate(t, prev_global, client_params, sched,
                                  aux_state)
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

    def reduced_server_update(self, t, prev_global, client_params, sched,
                              aux_state):
        """``kernels.ref.server_adam_math`` with the pseudo-gradient's
        aggregate pre-reduced over the client axis (one contraction);
        the moment update is elementwise on (N,)."""
        del t
        w, tot = _norm_weights(sched["data_sizes"],
                               (~sched["delayed"]).float())
        agg = reduce_leading(client_params, w)
        delta = tree_map(lambda p, a: torch.where(tot > 0, a - p.float(),
                                                  0.0), prev_global, agg)
        m, v, step, update = self._adam(delta, aux_state)
        new_params = tree_map(
            lambda p, u: (p.float() + self.fl.server_lr * u).to(p.dtype),
            prev_global, update)
        return new_params, {"m": m, "v": v, "step": step}
