"""Batched evaluation with exact sums (the engine's eval layer).

The test set is wrap-padded to whole batches once; each evaluation
accumulates per-example sums (correct predictions, negative
log-likelihood, count) over the batches under a padding mask, so
accuracy and loss do not depend on the batch split, and reads them on
the host once.
"""
from __future__ import annotations

import numpy as np
import torch


class Evaluator:
    """``__call__(params) -> (accuracy, mean_loss)`` over the original
    (unpadded) examples."""

    def __init__(self, model, test_data: dict, batch_size: int = 512,
                 device=None):
        n = len(next(iter(test_data.values())))
        bs = min(batch_size, n)
        nb = int(np.ceil(n / bs))
        idx = np.arange(nb * bs) % n          # wrap-pad; padding is masked
        self._batches = {
            k: torch.as_tensor(np.asarray(v)[idx].reshape((nb, bs)
                                                          + v.shape[1:]),
                               device=device)
            for k, v in test_data.items()}
        self._mask = torch.as_tensor(
            (np.arange(nb * bs) < n).reshape(nb, bs), dtype=torch.float32,
            device=device)
        self.model = model

    @torch.no_grad()
    def __call__(self, params) -> tuple[float, float]:
        sums = torch.zeros(3, dtype=torch.float32, device=self._mask.device)
        for i in range(self._mask.shape[0]):
            batch = {k: v[i] for k, v in self._batches.items()}
            logits, _ = self.model.forward(params, batch)
            labels, m = batch["label"], self._mask[i]
            lf = logits.float()
            iota = torch.arange(lf.shape[-1], device=lf.device)
            gold = torch.where(iota == labels[..., None], lf,
                               torch.zeros((), device=lf.device)).sum(-1)
            nll = torch.logsumexp(lf, dim=-1) - gold
            hit = (lf.argmax(-1) == labels).float()
            sums = sums + torch.stack([(hit * m).sum(), (nll * m).sum(),
                                       m.sum()])
        c, loss, n = sums.tolist()
        return c / n, loss / n
