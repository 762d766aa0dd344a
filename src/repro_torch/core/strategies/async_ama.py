"""Asynchronous AMA (paper Eqs. 6-11) as a ServerStrategy.

The O(max_delay) ring buffer of gamma^- pre-weighted pending updates is
strategy-owned aux state riding the round-loop carry.
"""
from __future__ import annotations

import torch

from repro_torch.core import async_ama
from repro_torch.core.ama import alpha_schedule
from repro_torch.core.strategies.ama import AMAStrategy
from repro_torch.core.strategies.base import ServerStrategy, register
from repro_torch.kernels.ref import ALPHA_UNNORM, _norm_weights, _seq_sum
from repro_torch.kernels.server_plane import (device_vector,
                                              server_async_tree)
from repro_torch.utils.reduce import reduce_leading
from repro_torch.utils.tree import tree_map


def _pop_mask(t, Q: int, device):
    """(Q,) f32 one-hot of the slot t % Q, arriving this round."""
    slots = torch.arange(Q, device=device)
    return (slots == torch.remainder(t, Q)).float()


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

    def mix_coefficient(self, t, sched, aux_state):
        """The realized Eq. 10 alpha of this round: the Eq. 8 budget A
        renormalized by the staleness mass arriving now (the popped
        slot's gamma^- after this round's enqueue). A scalar replay of
        the ring-buffer bookkeeping; the buffer itself is untouched."""
        qgamma = aux_state["queue"]["gamma"]
        Q = qgamma.shape[0]
        onehot = async_ama._onehot_gamma(self.fl, t, sched["delays"],
                                         sched["delayed"], Q)
        stale = _seq_sum((qgamma + _seq_sum(onehot))
                         * _pop_mask(t, Q, qgamma.device))
        denom = ALPHA_UNNORM + stale
        return (torch.full_like(denom, ALPHA_UNNORM) / denom
                * alpha_schedule(self.fl, t))

    def aggregate(self, t, prev_global, client_params, sched, aux_state):
        queue = async_ama.enqueue(self.fl, aux_state["queue"], t,
                                  client_params, sched["delayed"],
                                  sched["delays"])
        new_global, queue = async_ama.async_ama_aggregate(
            self.fl, t, prev_global, client_params, sched["data_sizes"],
            ~sched["delayed"], queue, use_kernel=self.fl.use_kernel)
        return new_global, {"queue": queue}

    def fused_server_update(self, t, prev_global, client_params, sched,
                            aux_state):
        if self.server_impl == "legacy":
            return self.aggregate(t, prev_global, client_params, sched,
                                  aux_state)
        fl = self.fl
        hyp = device_vector((fl.alpha0, fl.eta, fl.alpha_cap,
                             fl.staleness_b), t.device)
        new_global, queue = server_async_tree(
            prev_global, client_params, aux_state["queue"],
            sched["data_sizes"], sched["delayed"].float(),
            sched["delays"], t, hyp, impl=self.server_impl)
        return new_global, {"queue": queue}

    def reduced_server_update(self, t, prev_global, client_params, sched,
                              aux_state):
        """``kernels.ref.server_async_math`` with the client axis
        pre-reduced: the on-time aggregate AND the Q ring-buffer enqueue
        sums are ONE (C, 1+Q) ``reduce_leading`` contraction."""
        queue = aux_state["queue"]
        Q = queue["gamma"].shape[0]
        delayed = sched["delayed"].float()
        onehot = async_ama._onehot_gamma(self.fl, t, sched["delays"],
                                         sched["delayed"], Q)   # (C, Q)
        qg = queue["gamma"] + _seq_sum(onehot)
        sel = _pop_mask(t, Q, qg.device)
        stale_gamma = _seq_sum(qg * sel)
        new_qgamma = qg * (1.0 - sel)

        A = alpha_schedule(self.fl, t)
        beta = 1.0 - A
        denom = ALPHA_UNNORM + stale_gamma
        alpha = torch.full_like(denom, ALPHA_UNNORM) / denom * A  # Eq. 10
        gscale = A / denom                                        # Eq. 11
        w, tot = _norm_weights(sched["data_sizes"], 1.0 - delayed)
        a_eff = torch.where(tot > 0, alpha, alpha + beta)

        # row 0: the beta-weighted on-time aggregate; rows 1..Q: enqueue
        W = torch.cat([(beta * w)[:, None], onehot], dim=1)
        red = reduce_leading(client_params, W)        # leaves (1+Q, ...)
        rows = tree_map(lambda qs, r: qs + r[1:], queue["sum"], red)

        def selb(x):
            return sel.reshape((Q,) + (1,) * (x.ndim - 1))

        new_params = tree_map(
            lambda p, r, rw: (p.float() * a_eff + r[0]
                              + (rw * selb(rw)).sum(dim=0) * gscale
                              ).to(p.dtype),
            prev_global, red, rows)
        new_qsum = tree_map(lambda rw: rw * (1.0 - selb(rw)), rows)
        return new_params, {"queue": {"sum": new_qsum,
                                      "gamma": new_qgamma}}
