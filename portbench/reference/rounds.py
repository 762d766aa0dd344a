"""The plain reference of the federated rounds the benchmark drives.

One round of the paper's Algorithm 1 at pod scale, from the JAX
package's equations (``core/round.py``, ``core/client.py``,
``core/fes.py``, ``core/ama.py``):

  * every cohort starts from the global parameters and takes
    ``local_steps`` SGD steps, p <- cast(f32(p) - lr * g), on its own
    (b, S) token rows; its loss is the mean over those steps;
  * a computing-limited cohort (FES, Eq. 2) updates only the classifier
    (``tail``, ``final_norm``, ``lm_head``); the rest stays the global
    model. The masked and the partitioned client planes both compute
    this: the first by zeroing the body's gradient, the second by never
    differentiating the body (Eq. 3);
  * the server mixes (AMA, Eq. 5): alpha_t = min(alpha0 + eta t, cap),
    w_k = |d_k| keep_k / sum_j |d_j| keep_j over the on-time cohorts, and
    new = cast(alpha_t prev + sum_k (1 - alpha_t) w_k c_k), in f32;
  * the round's loss is the mean of the cohorts' losses.

``train`` returns what the benchmark compares: each round's loss, and
the norm of each parameter leaf's change after the first round and
after the last. It needs the initial parameters twice more for those
norms and draws them again (``draw``) rather than keep a copy.
"""
from __future__ import annotations

import torch

from portbench.reference.model import (CLASSIFIER, F32, _no_tf32, leaves,
                                       loss_fn, tree_map)

#: elements of a leaf differenced at once (bounds the f32 temporaries)
_CHUNK = 1 << 27


def change_norms(tree, start: list) -> dict:
    """{path: ||f32(leaf) - f32(start leaf)||} over a tree's leaves and
    ``start``, the same leaves in the same order on any device (a slice
    at a time is brought to the tree's)."""
    out = {}
    for (name, x), y in zip(leaves(tree), start, strict=True):
        x, y = x.reshape(-1), y.reshape(-1)
        sq = 0.0
        for s in range(0, x.numel(), _CHUNK):
            d = (x[s:s + _CHUNK].float()
                 - y[s:s + _CHUNK].to(x.device, non_blocking=True).float())
            sq += float(torch.dot(d, d))
        out[name] = sq ** 0.5
    return out


def local_train(cfg, hp, g, tokens, limited: bool, ops):
    """One cohort's local steps from the global tree ``g``; tokens
    (steps, b, S). Returns (its parameters, its mean loss)."""
    p, losses = g, []
    for i in range(tokens.shape[0]):
        trained = CLASSIFIER if limited else tuple(p)
        pf = {k: (tree_map(lambda a: a.to(torch.float32, copy=True)
                           .requires_grad_(), v)
                  if k in trained else v) for k, v in p.items()}
        loss = loss_fn(pf, cfg, tokens[i], ops)
        names = [n for n, _ in leaves({k: pf[k] for k in trained})]
        grads = torch.autograd.grad(
            loss, [t for _, t in leaves({k: pf[k] for k in trained})])
        grad = dict(zip(names, grads))
        losses.append(float(loss.detach()))
        new = {}
        for k, v in p.items():
            if k not in trained:
                new[k] = v
                continue
            new[k] = _update(v, pf[k], grad, k + ".", hp["lr"])
        del pf, grads, grad, loss
        p = new
    return p, sum(losses) / len(losses)


def _update(orig, pf, grad, prefix, lr):
    if isinstance(orig, dict):
        return {k: _update(orig[k], pf[k], grad, f"{prefix}{k}.", lr)
                for k in orig}
    step = pf.detach() - lr * grad[prefix[:-1]]
    return step.to(orig.dtype)


def mix(hp, t: int, prev, rows, sizes, keep):
    """The AMA mix of round ``t`` over the cohorts' trees ``rows``."""
    f32 = torch.float32
    dev = sizes.device
    alpha = torch.minimum(torch.tensor(hp["alpha0"], dtype=f32, device=dev)
                          + torch.tensor(hp["eta"], dtype=f32, device=dev)
                          * torch.tensor(float(t), dtype=f32, device=dev),
                          torch.tensor(hp["alpha_cap"], dtype=f32,
                                       device=dev))
    beta = 1.0 - alpha
    w = sizes * keep
    tot = w.sum()
    w = w / torch.clamp(tot, min=1e-9)
    a_eff = torch.where(tot > 0, alpha, alpha + beta)
    flat = [leaves(r) for r in rows]
    out = {}
    for j, (name, x) in enumerate(leaves(prev)):
        acc = x.float() * a_eff
        for k, r in enumerate(flat):
            acc = acc + r[j][1].float() * (beta * w[k])
        out[name] = acc.to(x.dtype)
    return _rebuild(prev, out, "")


def _rebuild(tree, flat, prefix):
    return {k: (_rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
                else None if v is None else flat[f"{prefix}{k}"])
            for k, v in tree.items()}


def train(cfg, hp, draw, inputs, ops=F32) -> dict:
    """Rounds from the initial tree ``draw()`` over ``inputs``, a list
    of (tokens (C, steps, b, S), limited (C,) bool) a round, every cohort
    on time with an equal data size. Returns {"loss": [a round],
    "step1": {leaf: norm of the first round's change}, "change":
    {leaf: norm of the change over every round}}."""
    _no_tf32()
    g = draw()
    out = {"loss": []}
    for t, (tokens, limited) in enumerate(inputs):
        rows, losses = [], []
        for c in range(tokens.shape[0]):
            p, loss = local_train(cfg, hp, g, tokens[c], bool(limited[c]),
                                  ops)
            rows.append(p)
            losses.append(loss)
        C = len(rows)
        ones = torch.ones(C, dtype=torch.float32,
                          device=tokens.device)
        g_new = mix(hp, t, g, rows, ones, ones)
        del rows, g
        g = g_new
        out["loss"].append(sum(losses) / C)
        if t == 0:
            out["step1"] = change_norms(g, [x for _, x in leaves(draw())])
    out["change"] = change_norms(g, [x for _, x in leaves(draw())])
    return out
