"""Client-side local training (paper Alg. 1, lines 11-16): the MASKED
client plane.

Every selected client starts from the global params and takes local SGD
steps on its own batches; computing-limited clients have their body
gradients masked by the strategy's ``local_grad_transform`` (FES). The
C clients of a round are batched with ``torch.func``: ``vmap`` over
``grad_and_value`` of the model's functional loss gives each client
exactly its own gradient, and PyTorch runs the vmapped convolutions as
one grouped convolution over the client axis — the counterpart of the
JAX package's ``vmap`` over one client, with no per-client Python loop.
The step loop is a Python loop over the staged steps.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core import strategies
from repro_torch.utils.tree import tree_map


def make_local_train(model, fl: FLConfig, strategy=None):
    """Returns local_train(global_params, batches, limited) ->
    (client_params (C, ...), mean_loss (C,)).

    batches: {field: (C, steps, batch, ...)} tensors; limited: (C,) bool.
    """
    strategy = strategy or strategies.resolve(fl)
    grad_fn = vmap(grad_and_value(model.loss))

    def local_train(global_params, batches, limited):
        C, n_steps = limited.shape[0], batches["label"].shape[1]
        mask = model.fes_mask(global_params)
        n_active = strategy.local_steps(n_steps, limited)        # (C,)
        params = tree_map(lambda p: p.expand((C,) + tuple(p.shape)),
                          global_params)
        losses = []
        for i in range(n_steps):
            g, loss = grad_fn(params, {k: v[:, i] for k, v in batches.items()})
            g = strategy.local_grad_transform(g, params, global_params, mask,
                                              limited)
            active = i < n_active

            def step(p, gi):
                act = active.reshape((C,) + (1,) * (p.ndim - 1))
                p32 = p.float()
                return torch.where(act, p32 - fl.lr * gi.float(),
                                   p32).to(p.dtype)
            params = tree_map(step, params, g)
            losses.append(loss)
        # the mean covers active steps only: losses past the strategy's
        # local_steps cutoff are computed at frozen params
        losses = torch.stack(losses, dim=1)                      # (C, steps)
        act = (torch.arange(n_steps, device=limited.device)[None, :]
               < n_active[:, None]).to(losses.dtype)
        mean_loss = ((losses * act).sum(dim=1)
                     / torch.clamp(n_active, min=1).to(losses.dtype))
        return params, mean_loss

    return local_train
