"""The pre-reduced client axis (``fl.client_reduce == "force"``).

The port's counterpart of the JAX package's ``sharding/ctx.py:
reduce_leading``. There the contraction is constrained onto the mesh's
"client" axis, so a sharded mesh moves N bytes, not C x N, per round;
on one GPU it is a plain weighted contraction over the client axis (a
``torch.tensordot``, outside any kernel of the port, as the JAX package
leaves it to XLA). ``client_reduce="auto"`` stays off on one GPU, as it
does on a one-device mesh.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map


def reduce_leading(tree, weights):
    """Weighted sum over every leaf's LEADING (client) axis, in f32.

    weights (C,): leaf (C, ...) -> (...); weights (C, R): -> (R, ...),
    R simultaneous reductions (the async plane's on-time aggregate and
    its Q ring-buffer enqueue slots in one contraction). 0-dim leaves
    pass through.
    """
    w = weights.float()

    def red(x):
        if x.ndim == 0:
            return x
        return torch.tensordot(w, x.float(), dims=([0], [0]))

    return tree_map(red, tree)
