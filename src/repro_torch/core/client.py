"""Client-side local training (paper Alg. 1, lines 11-16).

Every selected client starts from the global params and takes local SGD
steps on its own batches. Three client-plane programs
(``fl.client_plane`` / ``fl.fes_static``):

  * ``make_local_train`` — the MASKED plane: one program for every
    cohort, ``limited`` a per-cohort bool tensor. Limited cohorts pay
    the full body backward and the strategy's ``local_grad_transform``
    masks it (FES) — the reference for mixed cohorts.
  * ``make_partitioned_local_train`` — the PARTITIONED plane: the
    cohorts of a round are gathered into two programs by limited-ness
    (``data.pipeline.partition_plan``), the masked program over the
    unlimited ones and ``make_limited_local_train`` over the limited
    ones (classifier-only differentiation: the body backward is never
    built, paper Eq. 3; or a shorter step loop, FedProx's partial work,
    per the strategy's ``limited_mode``), and the outputs scattered
    back into cohort-slot order on the device.
  * ``make_fes_local_train`` — the STATIC mode: every cohort limited.

Algorithm behaviour comes from the strategy's client hooks
(``local_grad_transform``, ``local_steps``, ``limited_mode``,
``static_local_steps``); this module has no per-algorithm branching.
The C clients of a round are batched with ``torch.func``: ``vmap`` over
``grad_and_value`` of the model's functional loss gives each client
exactly its own gradient, and PyTorch runs the vmapped convolutions as
one grouped convolution over the client axis — the counterpart of the
JAX package's ``vmap`` over one client, with no per-client Python loop.
The step loop is a Python loop over the staged steps. The batch may be
any dict of (C, steps, b, ...) tensors: the paper CNN's images and
labels, or the pod path's LLM tokens.

Under a mesh (``launch.mesh``) the masked plane runs over the rank's
cohort block only: the round hands it that block of the batch and of
``limited`` (``sharding.ctx.constrain_leading``), so the FES mask and
the strategy's per-cohort hooks see the rank's slice of the schedule.

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
from repro_torch.core import fes as fes_lib
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


def _stacked(tree, n: int):
    """``tree``'s leaves as (n, ...) stride-0 views: n cohorts' copies of
    the global params, with no memory of their own."""
    return tree_map(lambda p: p.expand((n,) + tuple(p.shape)), tree)


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
        params = _stacked(global_params, C)
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


def _limited_train(model, fl: FLConfig, strategy, classifier: bool):
    """Local training of cohorts that are ALL computing-limited.

    ``classifier``: only the ``CLASSIFIER_KEYS`` subtree is
    differentiated and updated; the body enters the vmapped loss
    unbatched (``fes_loss_fn``, detached) and comes back as a stride-0
    ``expand`` of the global leaf, with no per-cohort copy. Otherwise
    every leaf is trained, as an unlimited cohort's. With a
    ``strategy``, its ``local_grad_transform`` (limited) and
    ``static_local_steps`` apply; without one (``fes_static``) no hook
    runs and every staged step is taken, as in the JAX package. The
    mean loss is over the steps run."""
    grad_fn = vmap(grad_and_value(fes_lib.fes_loss_fn(model)),
                   in_dims=(0, None, 0))

    def local_train(global_params, batches):
        first = leaves(batches)[0]
        n, n_steps = first.shape[:2]
        if strategy is not None:
            n_steps = min(strategy.static_local_steps(n_steps), n_steps)
        start, body = global_params, {}
        mask = model.fes_mask(global_params)
        if classifier:
            start, body = fes_lib.split_params(global_params)
            mask, _ = fes_lib.split_params(mask)
        limited = torch.ones(n, dtype=torch.bool, device=first.device)
        params = _stacked(start, n)
        losses = []
        for i in range(n_steps):
            g, loss = grad_fn(params, body,
                              {k: v[:, i] for k, v in batches.items()})
            if strategy is not None:
                g = strategy.local_grad_transform(g, params, start, mask,
                                                  limited)
            params = tree_map(lambda p, gi: sgd_update(p, gi, limited,
                                                       fl.lr), params, g)
            del g
            losses.append(loss)
        mean_loss = torch.stack(losses, dim=1).mean(dim=1)
        return fes_lib.merge_params(params, _stacked(body, n)), mean_loss

    return local_train


def make_limited_local_train(model, fl: FLConfig, strategy=None):
    """The limited-cohort program of the PARTITIONED client plane.

    Returns local_train(global_params, batches) -> (client_params (L,
    ...), mean_loss (L,)) for L cohorts that are ALL computing-limited,
    per the strategy's ``limited_mode``:

      * "classifier" (AMA-FES): classifier-only differentiation over the
        first ``static_local_steps`` steps; the body's backward (its
        backward kernels, the embedding gradient, its SGD update) never
        runs, instead of the masked plane's computed-then-zeroed one;
      * "full" (FedProx, the base): the gradients an unlimited cohort
        takes, over the first ``static_local_steps`` steps only: partial
        work as a shorter loop, not gradients computed and discarded.

    Both apply ``local_grad_transform(..., limited=True)``.
    """
    strategy = strategy or strategies.resolve(fl)
    return _limited_train(model, fl, strategy,
                          strategy.limited_mode == "classifier")


def _rows(x, idx):
    """``x.index_select(0, idx)``; a stride-0 leading axis (a body leaf
    of the classifier program) stays a stride-0 view."""
    if x.stride(0) == 0:
        return x[:1].expand((idx.shape[0],) + tuple(x.shape[1:]))
    return x.index_select(0, idx)


def make_partitioned_local_train(model, fl: FLConfig, strategy=None):
    """The PARTITIONED mixed-cohort client plane.

    Returns local_train(global_params, batches, sched) -> (client_params
    (C, ...), mean_loss (C,)), the masked plane's contract. The cohorts
    are grouped by limited-ness by the ``data.pipeline.partition_plan``
    arrays in ``sched``: the masked program runs over the
    ``part_full_idx`` rows and ``make_limited_local_train`` over the
    ``part_lim_idx`` rows, and both outputs are scattered back into
    cohort-slot order (``part_src_row``, ``part_from_lim``) on the
    device, so the server update downstream is oblivious to the split.
    The group widths U and L are the arrays' shapes, known on the host
    without reading a device value: per chunk, L is the chunk's least
    limited count and the overflow limited cohorts run the masked
    program (correct, just not reduced).
    """
    strategy = strategy or strategies.resolve(fl)
    full_train = make_local_train(model, fl, strategy)
    lim_train = make_limited_local_train(model, fl, strategy)

    def local_train(global_params, batches, sched):
        full_idx, lim_idx = sched["part_full_idx"], sched["part_lim_idx"]
        src_row, from_lim = sched["part_src_row"], sched["part_from_lim"]
        U, L = full_idx.shape[0], lim_idx.shape[0]
        if U:
            f_params, f_loss = full_train(
                global_params,
                {k: v.index_select(0, full_idx) for k, v in batches.items()},
                sched["limited"].index_select(0, full_idx))
        if L:
            l_params, l_loss = lim_train(
                global_params,
                {k: v.index_select(0, lim_idx) for k, v in batches.items()})
        if not L:
            return (tree_map(lambda f: _rows(f, src_row), f_params),
                    f_loss.index_select(0, src_row))
        if not U:
            return (tree_map(lambda x: _rows(x, src_row), l_params),
                    l_loss.index_select(0, src_row))
        f_row = torch.clamp(src_row, max=U - 1)
        l_row = torch.clamp(src_row, max=L - 1)

        def scatter(f, x):
            sel = from_lim.reshape(from_lim.shape + (1,) * (f.ndim - 1))
            return torch.where(sel, _rows(x, l_row), _rows(f, f_row))

        return (tree_map(scatter, f_params, l_params),
                scatter(f_loss, l_loss))

    return local_train


def make_fes_local_train(model, fl: FLConfig):
    """STATIC FES local training (``fl.fes_static``): every cohort is
    limited and differentiates only the classifier, with no strategy
    hook. Returns local_train(global_params, batches, limited=None)."""
    train = _limited_train(model, fl, None, classifier=True)

    def local_train(global_params, batches, limited=None):
        del limited
        return train(global_params, batches)

    return local_train
