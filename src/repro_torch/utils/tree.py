"""Nested-dict parameter trees: flattening in ``jax.tree`` order and the
bridge to and from numpy.

Params are nested dicts of tensors with the JAX package's keys and
layouts (HWIO conv weights, ``(d_in, d_out)`` dense weights). Leaves are
ordered as ``jax.tree.leaves`` orders a dict tree — by sorted key at
every level — so the per-dtype-group flat vectors of the server plane
match the JAX ones element for element.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] in ``jax.tree`` order; paths are "a/b/c"."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves) -> dict:
    """A tree shaped like ``like`` whose leaves, in ``jax.tree`` order,
    are ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` leafwise over like-structured trees."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys
                            in zip(leaves(tree), *others, strict=True)])


def params_from_numpy(tree, device=None) -> dict:
    """A tree of array-likes (numpy, or anything ``np.asarray`` takes)
    -> the same tree of torch tensors, bits unchanged."""
    return tree_map(lambda x: torch.from_numpy(
        np.array(np.asarray(x), copy=True)).to(device), tree)


def params_to_numpy(tree) -> dict:
    """The inverse of ``params_from_numpy``."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


# --------------------------------------------------------------------------
# per-dtype-group flat vectors (the server plane's operand layout)
# --------------------------------------------------------------------------

def dtype_groups(tree_leaves) -> dict:
    """Leaf indices grouped by dtype, insertion-ordered (usually 1 group)."""
    groups: dict = {}
    for i, x in enumerate(tree_leaves):
        groups.setdefault(x.dtype, []).append(i)
    return groups


def cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def split_back(flat, leaves_like, idxs, out_leaves) -> None:
    """Cut a group's flat (..., n) vector back into the leaves ``idxs``
    of ``leaves_like``; leading (K,)/(Q,) axes, if any, are kept."""
    lead = flat.shape[:-1]
    off = 0
    for i in idxs:
        n = leaves_like[i].numel() // max(1, int(np.prod(lead)))
        out_leaves[i] = flat[..., off:off + n].reshape(leaves_like[i].shape)
        off += n
