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
    """[(path, leaf)] in ``jax.tree`` order; paths are "a/b/c". ``None``
    is an empty subtree, as in ``jax.tree`` (a transformer without body
    blocks has ``"body": None``)."""
    if tree is None:
        return []
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
        if node is None:
            return None
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


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes, as JAX hands it out) is not a
        # dtype torch.from_numpy takes: carry the bits across as int16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree, device=None) -> dict:
    """A tree of array-likes (numpy, or anything ``np.asarray`` takes,
    bfloat16 arrays included) -> the same tree of torch tensors, bits
    unchanged."""
    return tree_map(lambda x: _to_torch(x).to(device), tree)


def _to_numpy(x):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        # numpy's bfloat16 is ml_dtypes' (registered once JAX is loaded)
        return x.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return x.numpy()


def params_to_numpy(tree) -> dict:
    """The inverse of ``params_from_numpy``, bits unchanged (bf16 leaves
    need numpy's bfloat16 dtype registered, as JAX's ml_dtypes does)."""
    return tree_map(_to_numpy, tree)


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
