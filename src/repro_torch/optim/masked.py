"""Gradient masking (FES, Eq. 3: frozen feature extractor)."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map


def masked_update(grads, mask, limited):
    """Per-cohort dynamic FES over stacked (C, ...) grads: where
    ``limited`` ((C,) bool), keep only the classifier grads (``mask``
    True); elsewhere keep all."""
    def one(g, m):
        lim = limited.reshape(limited.shape + (1,) * (g.ndim - 1))
        return torch.where(lim, g * float(m), g)
    return tree_map(one, grads, mask)
