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
The step loop is a Python loop over the staged steps. The batch may be
any dict of (C, steps, b, ...) tensors: the paper CNN's images and
labels, or the pod path's LLM tokens.

The local SGD update ``p - lr * g`` runs in f32 and returns in the
params' dtype, as in the JAX package. For memory it is computed in
column slices of at most ``SGD_SLICE`` elements, with in-place f32 ops:
at the full width of minitron-8b the embedding alone is a (2, 256000,
4096) leaf, and its f32 operands and result at once would take about
40 GB. The op order is that of the one-shot update, so the result is
bitwise the same.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core import strategies
from repro_torch.utils.tree import leaves, tree_map

#: elements of a (C, n) leaf the f32 SGD update handles at once
SGD_SLICE = 1 << 27


def sgd_update(p, g, active, lr: float):
    """where(active, p - lr * g, p) in f32, in ``p``'s dtype, over the
    leading client axis. p, g: (C, ...); active: (C,) bool. ``p`` may be
    a stride-0 broadcast of the global params: it is never written."""
    C = p.shape[0]
    pf, gf = p.reshape(C, -1), g.reshape(C, -1)
    act = active.reshape(C, 1)
    n = pf.shape[1]
    cols = max(1, SGD_SLICE // C)

    def cut(sl):
        upd = gf[:, sl].to(torch.float32, copy=True).mul_(lr)
        new = pf[:, sl].to(torch.float32, copy=True).sub_(upd)
        del upd
        return torch.where(act, new.to(p.dtype), pf[:, sl])

    if n <= cols:
        return cut(slice(None)).reshape(p.shape)
    out = torch.empty((C, n), dtype=p.dtype, device=p.device)
    for a in range(0, n, cols):
        out[:, a:a + cols] = cut(slice(a, a + cols))
    return out.reshape(p.shape)


def make_local_train(model, fl: FLConfig, strategy=None):
    """Returns local_train(global_params, batches, limited) ->
    (client_params (C, ...), mean_loss (C,)).

    batches: {field: (C, steps, batch, ...)} tensors; limited: (C,) bool.
    """
    strategy = strategy or strategies.resolve(fl)
    grad_fn = vmap(grad_and_value(model.loss))

    def local_train(global_params, batches, limited):
        C, n_steps = limited.shape[0], leaves(batches)[0].shape[1]
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
            params = tree_map(lambda p, gi: sgd_update(p, gi, active,
                                                       fl.lr), params, g)
            del g
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
