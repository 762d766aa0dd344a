"""Asynchronous AMA (paper §IV-B, Eqs. 6-11): the staleness weights and
the server's ring buffer.

Delayed updates from round n arriving at round t enter the aggregation
with a staleness weight gamma_i^- = b * (1 - sigmoid(t - n)) (Eq. 9),
alpha^- = 1 - sigmoid(1), normalised so that alpha + beta + sum(gamma)
= 1 (Eqs. 7-11). The server keeps a RING BUFFER over arrival rounds:
an update sent at round n with delay d is accumulated, pre-weighted by
gamma^-(d), into slot (n+d) % Q; at round t slot t % Q holds the sum of
the updates arriving now — O(max_delay) parameter buffers whatever the
client count. The enqueue, pop and mix run fused in
``kernels.server_plane.server_async_flat``; ``enqueue``, ``pop_slot`` and
``async_ama_aggregate`` are the legacy per-leaf chain
(``fl.server_plane == "legacy"``), whose mix is one K = 2 ``ama_mix``
launch per leaf under ``use_kernel``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.ama import (alpha_schedule, count_plain_mix,
                                  on_time_aggregate)
from repro_torch.kernels.ops import ama_mix_tree
from repro_torch.kernels.ref import ALPHA_UNNORM, _seq_sum
from repro_torch.utils.tree import leaves, tree_map

__all__ = ["ALPHA_UNNORM", "gamma_unnorm", "init_queue", "enqueue",
           "pop_slot", "async_ama_aggregate", "mixing_weights"]


def gamma_unnorm(fl: FLConfig, staleness):
    """gamma_i^- = b * (1 - sigmoid(staleness)), computed as
    b * sigmoid(-s): the same value without the catastrophic
    cancellation of 1 - sigmoid(s) in f32 for stale updates."""
    return fl.staleness_b * torch.sigmoid(-torch.as_tensor(staleness).float())


def init_queue(fl: FLConfig, params_like):
    """Ring buffer of gamma^- pre-weighted pending sums.

    Q = max_delay + 1 slots (at least 2) so an update with the maximum
    delay, enqueued at round t, never collides with the slot drained at
    round t.
    """
    Q = max(fl.max_delay, 1) + 1
    zeros = tree_map(lambda x: torch.zeros((Q,) + tuple(x.shape),
                                           dtype=torch.float32,
                                           device=x.device), params_like)
    return {"sum": zeros,
            "gamma": torch.zeros((Q,), dtype=torch.float32,
                                 device=leaves(params_like)[0].device)}


def _onehot_gamma(fl: FLConfig, t, delays, delayed, Q: int):
    """(C, Q) f32: gamma^-(delay_c) in column (t + delay_c) % Q for each
    delayed client c, zeros elsewhere."""
    arrival = torch.remainder(torch.as_tensor(t, device=delays.device)
                              + delays, Q)
    g = gamma_unnorm(fl, delays) * delayed.float()
    slots = torch.arange(Q, device=delays.device)
    return (arrival[:, None] == slots[None, :]).float() * g[:, None]


def enqueue(fl: FLConfig, queue, t, client_params, delayed, delays):
    """Accumulate this round's DELAYED updates into their arrival slots.

    client_params: leading client axis (C, ...); delayed: (C,) bool;
    delays: (C,) int32 in [1, max_delay]. The (C, Q) contraction runs one
    client at a time from c = 0 (the JAX package uses an einsum).
    """
    Q = queue["gamma"].shape[0]
    onehot = _onehot_gamma(fl, t, delays, delayed, Q)

    def acc(buf, cp):
        col = (Q,) + (1,) * (cp.ndim - 1)
        add = cp[0].float()[None] * onehot[0].reshape(col)
        for c in range(1, cp.shape[0]):
            add = add + cp[c].float()[None] * onehot[c].reshape(col)
        return buf + add

    return {"sum": tree_map(acc, queue["sum"], client_params),
            "gamma": queue["gamma"] + _seq_sum(onehot)}


def pop_slot(queue, t):
    """Read and clear the slot arriving at round t: (stale_sum,
    stale_gamma, cleared queue). The slot index stays on the device."""
    gamma = queue["gamma"]
    Q = gamma.shape[0]
    slot = torch.remainder(torch.as_tensor(t, device=gamma.device),
                           Q).reshape(1).long()
    hit = torch.arange(Q, device=gamma.device) == slot

    def clear(b):
        return torch.where(hit.reshape((Q,) + (1,) * (b.ndim - 1)), 0.0, b)

    stale_sum = tree_map(lambda b: b.index_select(0, slot)[0],
                         queue["sum"])
    stale_gamma = gamma.index_select(0, slot)[0]
    return stale_sum, stale_gamma, {"sum": tree_map(clear, queue["sum"]),
                                    "gamma": clear(gamma)}


def async_ama_aggregate(fl: FLConfig, t, prev_global, client_params,
                        data_sizes, on_time, queue, *,
                        use_kernel: bool = False):
    """One asynchronous AMA round (Eq. 6). Returns (new_global,
    new_queue). ``client_params`` are this round's local results; the
    clients with on_time False contribute nothing now (the caller
    enqueued their updates with ``enqueue``)."""
    stale_sum, stale_gamma, queue = pop_slot(queue, t)

    A = alpha_schedule(fl, t)                       # alpha0 + eta t (Eq. 8)
    beta = 1.0 - A
    denom = ALPHA_UNNORM + stale_gamma
    # true divisions (a Python number over a tensor would run as
    # reciprocal-then-multiply, which rounds differently from JAX)
    alpha = torch.full_like(denom, ALPHA_UNNORM) / denom * A    # Eq. 10
    gamma_scale = A / denom                                     # Eq. 11

    agg = on_time_aggregate(prev_global, client_params, data_sizes, on_time)
    if use_kernel:
        # alpha*prev + beta*agg + gamma*stale is one K = 2 mix over the
        # (2, n) f32 operand the JAX package stages
        stacked = tree_map(lambda a, s: torch.stack([a.float(), s]), agg,
                           stale_sum)
        new_global = ama_mix_tree(prev_global, stacked, alpha,
                                  torch.stack([beta, gamma_scale]))
        return new_global, queue

    def mix(p, a, s):
        count_plain_mix(p)
        return (alpha * p.float() + beta * a.float()
                + gamma_scale * s).to(p.dtype)

    return tree_map(mix, prev_global, agg, stale_sum), queue


def mixing_weights(fl: FLConfig, t, staleness_list):
    """Host reference of (alpha, beta, gammas) for a set of stale
    updates, in Python floats: Eqs. 7-11 checked analytically."""
    A = float(min(fl.alpha0 + fl.eta * t, fl.alpha_cap))
    g_un = [float(gamma_unnorm(fl, s)) for s in staleness_list]
    denom = ALPHA_UNNORM + sum(g_un)
    return (ALPHA_UNNORM / denom * A, 1.0 - A,
            [g / denom * A for g in g_un])
