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
``kernels.server_plane.server_async_flat``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.kernels.ref import ALPHA_UNNORM
from repro_torch.utils.tree import leaves, tree_map

__all__ = ["ALPHA_UNNORM", "gamma_unnorm", "init_queue"]


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
