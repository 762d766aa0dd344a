"""Feature-Extractor Sharing (paper §III, Eqs. 2-3).

Computing-limited clients freeze the feature extractor omega^f and train
only the classifier omega^c (``models.api.CLASSIFIER_KEYS``). The port
has the DYNAMIC mode: ``Model.fes_mask`` marks the classifier leaves and
``optim.masked.masked_update`` zeroes the body gradients of limited
cohorts inside one program. The static split/merge mode waits for the
partitioned client plane.
"""
from __future__ import annotations

from repro_torch.utils.tree import leaves


def count_trainable(params, mask) -> tuple[int, int]:
    """(parameters under the mask, all parameters)."""
    total = sum(x.numel() for x in leaves(params))
    train = sum(x.numel() if m else 0
                for x, m in zip(leaves(params), leaves(mask), strict=True))
    return train, total
