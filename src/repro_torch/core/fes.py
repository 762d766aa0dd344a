"""Feature-Extractor Sharing (paper §III, Eqs. 2-3).

Computing-limited clients freeze the feature extractor omega^f and train
only the classifier omega^c (``models.api.CLASSIFIER_KEYS``). Two modes:

* ``split_params`` / ``merge_params`` / ``fes_loss_fn`` — the STATIC
  mode of the partitioned and ``fes_static`` client planes: only the
  classifier subtree is differentiated (``torch.func`` over the first
  argument of ``fes_loss_fn``'s loss), so the frozen body's backward is
  never built and never run — the computation reduction the paper's
  FES scheme exists for.
* ``optim.masked.masked_update`` — the DYNAMIC mode of the masked client
  plane: one program for every cohort, the body gradients of limited
  cohorts computed and then zeroed.
"""
from __future__ import annotations

from repro_torch.models.api import CLASSIFIER_KEYS
from repro_torch.utils.tree import leaves, tree_map


def split_params(params):
    """(classifier, feature extractor) by the FES boundary."""
    clf = {k: v for k, v in params.items() if k in CLASSIFIER_KEYS}
    body = {k: v for k, v in params.items() if k not in CLASSIFIER_KEYS}
    return clf, body


def merge_params(clf, body):
    return {**body, **clf}


def fes_loss_fn(model):
    """loss(classifier_params, frozen_body, batch). Differentiated with
    respect to the classifier only (``argnums=0``); the body is detached
    (the JAX package's ``stop_gradient``), so no backward through it is
    recorded."""
    def loss(clf, body, batch):
        return model.loss(merge_params(clf, tree_map(lambda x: x.detach(),
                                                     body)), batch)
    return loss


def count_trainable(params, mask) -> tuple[int, int]:
    """(parameters under the mask, all parameters)."""
    total = sum(x.numel() for x in leaves(params))
    train = sum(x.numel() if m else 0
                for x, m in zip(leaves(params), leaves(mask), strict=True))
    return train, total
