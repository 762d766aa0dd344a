"""Adaptive Mixing Aggregation (paper §IV-A, Eq. 5): the legacy per-leaf
server chain.

    omega_t = alpha_t * omega_{t-1} + beta_t * sum_i w_i * omega_ti
    alpha_t = alpha0 + eta * t            beta_t = 1 - alpha_t

The port's copy of the JAX package's ``core/ama.py``. Client weights
follow the FedAvg convention the results rely on: normalised over the
participating (on-time) clients, w_i = |d_i| / sum_{j in k_t} |d_j|.

This chain runs under ``fl.server_plane == "legacy"``: a weighted client
sum, then the mix, leaf by leaf. With ``use_kernel`` the mix is the
hand-written ``ama_mix`` kernel (``kernels/ops.py``: every leaf in one
launch a round); without it, plain
PyTorch elementwise math in the same op order, so the two give the same
bits. Every scalar stays on the device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.kernels import server_plane
from repro_torch.kernels.ops import ama_mix_pairwise, as_f32
from repro_torch.kernels.ref import _norm_weights
from repro_torch.utils.tree import leaves, tree_map

__all__ = ["alpha_schedule", "weighted_client_sum", "normalize_weights",
           "on_time_aggregate", "ama_mix", "ama_aggregate",
           "fedavg_aggregate", "count_plain_mix"]


def alpha_schedule(fl: FLConfig, t):
    """alpha_t = min(alpha0 + eta * t, cap) in f32 on ``t``'s device,
    capped to keep beta > 0 on long runs."""
    a = fl.alpha0 + fl.eta * torch.as_tensor(t).float()
    return torch.minimum(a, torch.full_like(a, fl.alpha_cap))


def weighted_client_sum(stacked, weights):
    """sum_c weights[c] * stacked[c], one client at a time from c = 0 in
    f32, cast back to each leaf's dtype (the JAX package contracts with
    an einsum, whose order is XLA's)."""
    w = weights.float()

    def red(x):
        acc = x[0].float() * w[0]
        for c in range(1, x.shape[0]):
            acc = acc + x[c].float() * w[c]
        return acc.to(x.dtype)

    return tree_map(red, stacked)


def normalize_weights(data_sizes, on_time):
    """w_i = |d_i| / sum_on_time |d_j|, zero for delayed or absent
    clients; returns (w, tot)."""
    return _norm_weights(data_sizes, on_time)


def count_plain_mix(x) -> None:
    """Count one run of the legacy chain's plain mix on a CUDA leaf
    (``server_plane.plain_runs_on_cuda["ama_mix"]``)."""
    if x.is_cuda:
        server_plane.plain_runs_on_cuda["ama_mix"] += 1


def ama_mix(prev_global, client_agg, alpha, *, use_kernel: bool = False):
    """alpha * prev + (1 - alpha) * agg, leaf by leaf."""
    if use_kernel:
        return ama_mix_pairwise(prev_global, client_agg, alpha)
    a = as_f32(alpha, leaves(prev_global)[0].device)

    def mix(p, g):
        count_plain_mix(p)
        return (a * p.float() + (1.0 - a) * g.float()).to(p.dtype)

    return tree_map(mix, prev_global, client_agg)


def on_time_aggregate(prev_global, client_params, data_sizes, on_time):
    """The on-time weighted client sum; the previous model when nobody
    arrived on time (beta's budget then reverts to it)."""
    w, tot = normalize_weights(data_sizes, on_time)
    return tree_map(lambda a, p: torch.where(tot > 0, a, p),
                    weighted_client_sum(client_params, w), prev_global)


def ama_aggregate(fl: FLConfig, t, prev_global, client_params, data_sizes,
                  on_time, *, use_kernel: bool = False):
    """Synchronous AMA round (Eq. 5); ``client_params`` leaves carry a
    leading client axis."""
    agg = on_time_aggregate(prev_global, client_params, data_sizes, on_time)
    return ama_mix(prev_global, agg, alpha_schedule(fl, t),
                   use_kernel=use_kernel)


def fedavg_aggregate(prev_global, client_params, data_sizes, on_time, *,
                     use_kernel: bool = False):
    """Naive FL (the paper's baseline): the weighted average of the
    on-time updates, the previous model when none arrived. It is the
    alpha = 0 corner of the AMA mix, so the same kernel serves it."""
    agg = on_time_aggregate(prev_global, client_params, data_sizes, on_time)
    return ama_mix(prev_global, agg, 0.0, use_kernel=use_kernel)
