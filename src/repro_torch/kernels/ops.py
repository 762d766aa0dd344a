"""The ``ama_mix`` kernel over whole parameter trees, leaf by leaf.

The counterparts of the JAX package's ``kernels/ops.py: ama_mix_tree,
ama_mix_pairwise``: the legacy server chain's mix (``core/ama.py``,
``core/async_ama.py``, ``core/strategies/fedopt.py`` under
``use_kernel``) makes ONE ``ama_mix_flat`` call per leaf, in the leaf's
own dtype: 8 launches per round for the paper CNN. alpha and the weights
stay on the device, so the chain reads nothing on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ama_mix import ama_mix_flat
from repro_torch.utils.tree import leaves, tree_map

__all__ = ["ama_mix_tree", "ama_mix_pairwise", "as_f32"]


def as_f32(x, device):
    """A 0-dim f32 tensor of ``x`` on ``device``: a tensor is cast and
    moved, a Python number is filled in on the device (a copy from host
    memory would synchronize the stream inside a round)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def ama_mix_tree(prev_tree, stacked_tree, alpha, weights):
    """alpha * prev + sum_k weights[k] * stacked[k] for every leaf;
    ``stacked_tree`` leaves carry a leading (K,) axis."""
    dev = leaves(prev_tree)[0].device
    alpha, weights = as_f32(alpha, dev), as_f32(weights, dev)

    def one(p, s):
        return ama_mix_flat(p.reshape(-1), s.reshape(s.shape[0], -1), alpha,
                            weights).reshape(p.shape)

    return tree_map(one, prev_tree, stacked_tree)


def ama_mix_pairwise(prev_tree, agg_tree, alpha):
    """alpha * prev + (1 - alpha) * agg through the same kernel (K = 1);
    the weight 1 - alpha is computed in f32 on the device."""
    dev = leaves(prev_tree)[0].device
    a = as_f32(alpha, dev)
    w = (1.0 - a).reshape(1)
    return tree_map(lambda p, g: ama_mix_flat(
        p.reshape(-1), g.reshape(1, -1), a, w).reshape(p.shape),
        prev_tree, agg_tree)
