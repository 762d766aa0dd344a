"""Neural-net primitives on params-as-dicts (the slice's part of the JAX
package's ``models/layers.py``)."""
from __future__ import annotations

import torch


def uniform_init(gen: torch.Generator, shape, scale: float, dtype):
    """U(-scale, scale) drawn in f32 from ``gen``, cast to ``dtype``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False) -> dict:
    """Fan-in scaled init (matches torch.nn.Linear default scale); the
    weight is stored ``(d_in, d_out)`` as in the JAX tree."""
    scale = (1.0 / d_in) ** 0.5
    p = {"w": uniform_init(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def dense(p: dict, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def cross_entropy_loss(logits, labels):
    """Mean cross entropy in f32: ``logsumexp - gold`` averaged over the
    batch. The gold logit is an iota-compare masked sum, as in the JAX
    package."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None], logits,
                       torch.zeros((), device=logits.device)).sum(-1)
    return (logz - gold).mean()
