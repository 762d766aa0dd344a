"""The ``ama_mix`` kernel over whole parameter trees.

The counterparts of the JAX package's ``kernels/ops.py: ama_mix_tree,
ama_mix_pairwise``: the legacy server chain's mix (``core/ama.py``,
``core/async_ama.py``, ``core/strategies/fedopt.py`` under
``use_kernel``) makes ONE ``ama_mix_leaves`` call over every leaf, each
leaf mixed in its own dtype: one launch a round for each (prev dtype,
stacked dtype) group of leaves, so 1 for the paper CNN. alpha and the
weights stay on the device, so the chain reads nothing on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ama_mix import ama_mix_leaves
from repro_torch.utils.tree import leaves, unflatten

__all__ = ["ama_mix_tree", "ama_mix_pairwise", "as_f32"]


def as_f32(x, device):
    """A 0-dim f32 tensor of ``x`` on ``device``: a tensor is cast and
    moved, a Python number is filled in on the device (a copy from host
    memory would synchronize the stream inside a round)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _mix_leaves(prev_tree, rows, alpha, weights):
    """One ``ama_mix_leaves`` call; ``rows`` holds each leaf's (K, ...)
    operand in leaf order."""
    ps = leaves(prev_tree)
    outs = ama_mix_leaves([p.reshape(-1) for p in ps],
                          [r.reshape(r.shape[0], -1) for r in rows], alpha,
                          weights)
    return unflatten(prev_tree, [o.reshape(p.shape)
                                 for o, p in zip(outs, ps)])


def ama_mix_tree(prev_tree, stacked_tree, alpha, weights):
    """alpha * prev + sum_k weights[k] * stacked[k] for every leaf;
    ``stacked_tree`` leaves carry a leading (K,) axis."""
    dev = leaves(prev_tree)[0].device
    return _mix_leaves(prev_tree, leaves(stacked_tree), as_f32(alpha, dev),
                       as_f32(weights, dev))


def ama_mix_pairwise(prev_tree, agg_tree, alpha):
    """alpha * prev + (1 - alpha) * agg through the same kernel (K = 1);
    the weight 1 - alpha is computed in f32 on the device."""
    a = as_f32(alpha, leaves(prev_tree)[0].device)
    rows = [g.reshape(1, -1) for g in leaves(agg_tree)]
    return _mix_leaves(prev_tree, rows, a, (1.0 - a).reshape(1))
