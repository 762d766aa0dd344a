"""Asynchronous AMA (paper Eqs. 6-11) as a ServerStrategy.

The O(max_delay) ring buffer of gamma^- pre-weighted pending updates is
strategy-owned aux state riding the round-loop carry.
"""
from __future__ import annotations

from repro_torch.core import async_ama
from repro_torch.core.strategies.ama import AMAStrategy
from repro_torch.core.strategies.base import ServerStrategy, register
from repro_torch.kernels.server_plane import (device_vector,
                                              server_async_tree)


@register
class AsyncAMAStrategy(AMAStrategy):
    name = "async_ama"
    aliases = ()

    # the ring buffer keeps the delayed updates dense across rounds, so
    # the mix family's compressed hook does not apply: the round
    # densifies the payload before fused_server_update
    compressed_server_update = ServerStrategy.compressed_server_update

    def init_state(self, params):
        return {"queue": async_ama.init_queue(self.fl, params)}

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        fl = self.fl
        hyp = device_vector((fl.alpha0, fl.eta, fl.alpha_cap,
                             fl.staleness_b), t.device)
        new_global, queue = server_async_tree(
            prev_global, client_params, aux_state["queue"],
            sched["data_sizes"], sched["delayed"].float(),
            sched["delays"], t, hyp, impl=self.server_impl)
        return new_global, {"queue": queue}
