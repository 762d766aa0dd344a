"""Neural-net primitives on params-as-dicts (the port of the JAX
package's ``models/layers.py``: dense, embedding, RMSNorm, LayerNorm,
rotary embeddings, the gated/GELU MLP and the cross-entropy losses),
and ``dense_serve`` / ``dense_serve_group`` / ``mlp_serve`` /
``rmsnorm_serve`` / ``add_rmsnorm_serve``, the serving steps'
projections, norm and residual add on the row-invariant kernels (the
same bits on the CPU).

The f32 casts sit exactly where the JAX package has them: RMSNorm,
LayerNorm, RoPE and the losses compute in f32 and return in the input's
dtype (the losses in f32). Initializers draw from a ``torch.Generator``
on the CPU; the JAX package's ``jax.random`` streams cannot be
reproduced, so the tests carry JAX's params across instead. The draws
land on the generator's device: a CUDA generator initialises a
full-width model on the card (the serving launcher), a CPU one gives the
same params on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.invariant_dense import (invariant_dense,
                                                invariant_dense_group)
from repro_torch.kernels.invariant_rmsnorm import (invariant_add_rmsnorm,
                                                  invariant_rmsnorm)


def uniform_init(gen: torch.Generator, shape, scale: float, dtype):
    """U(-scale, scale) drawn in f32 from ``gen`` (on its device), cast
    to ``dtype``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
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


def dense_serve(p: dict, x):
    """``dense`` on the row-invariant kernel (``kernels.invariant_dense``):
    a row's result does not depend on how many rows come with it, which
    the serving steps' bitwise contracts need on the card. The same bits
    as ``dense`` on the CPU."""
    return invariant_dense(x, p["w"], p.get("b"))


def dense_serve_group(ps, x):
    """``dense_serve`` of each params dict of ``ps`` over the same x, in
    one launch on the card (``kernels.invariant_dense_group``): each
    output the bits of its own ``dense_serve``."""
    return invariant_dense_group(x, [(p["w"], p.get("b")) for p in ps])


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    """N(0, 1) drawn in f32, cast to ``dtype``, then scaled by 0.02 in
    ``dtype`` (the JAX order)."""
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device)
    return {"table": table.to(dtype) * 0.02}


def embedding(p: dict, ids):
    """Rows of the table at ``ids`` (``jnp.take`` along axis 0)."""
    return F.embedding(ids.long(), p["table"])


def rmsnorm_init(d: int, dtype) -> dict:
    return {"g": torch.ones((d,), dtype=dtype)}


def rmsnorm(p: dict, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].float()).to(x.dtype)


def rmsnorm_serve(p: dict, x, eps: float = 1e-6):
    """``rmsnorm`` on the row-invariant kernel
    (``kernels.invariant_rmsnorm``), for the serving steps; the same bits
    as ``rmsnorm`` on the CPU."""
    return invariant_rmsnorm(x, p["g"], eps)


def add_rmsnorm_serve(p: dict, x, r, eps: float = 1e-6):
    """``(x + r, rmsnorm(x + r))`` in one launch on the card
    (``kernels.invariant_add_rmsnorm``), for the serving steps, where r is
    a residual branch not yet added; ``(x, rmsnorm_serve(x))`` when r is
    None. The same bits as ``x + r`` and ``rmsnorm`` on the CPU."""
    if r is None:
        return x, rmsnorm_serve(p, x, eps)
    return invariant_add_rmsnorm(x, r, p["g"], eps)


def layernorm_init(d: int, dtype) -> dict:
    return {"g": torch.ones((d,), dtype=dtype),
            "b": torch.zeros((d,), dtype=dtype)}


def layernorm(p: dict, x, eps: float = 1e-5):
    """LayerNorm in f32 over the last axis, returned in x's dtype. The
    variance is the population variance (``jnp.var``), not PyTorch's
    default unbiased one."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


# ---------------------------------------------------------------- rotary ----

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP ----

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True) -> dict:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype),
         "w_out": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(p: dict, x):
    """SwiGLU when the params carry ``w_gate``, else GELU (tanh
    approximation, ``jax.nn.gelu``'s default)."""
    h = dense(p["w_in"], x)
    if "w_gate" in p:
        h = F.silu(dense(p["w_gate"], x)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(p["w_out"], h)


def mlp_serve(p: dict, x):
    """``mlp`` in the serving steps: the projections on the row-invariant
    kernel, w_in and w_gate in one launch; the same ops in the same
    order, so the same bits as ``mlp`` on the CPU."""
    if "w_gate" in p:
        h, gate = dense_serve_group((p["w_in"], p["w_gate"]), x)
        h = F.silu(gate) * h
    else:
        h = F.gelu(dense_serve(p["w_in"], x), approximate="tanh")
    return dense_serve(p["w_out"], h)


# ---------------------------------------------------------------- losses ----

def _gold(logits, labels):
    """The gold logit of ``chunked_cross_entropy``. JAX sums an
    iota-compare masked row; exactly one term of that sum is non-zero, so
    a gather gives the same bits without a (..., V) mask (at a 256,000
    vocabulary that mask is the size of the logits)."""
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level cross entropy in f32: ``logsumexp - gold``
    averaged over the batch (over ``mask`` when given). The gold logit is
    an iota-compare masked sum, as in the JAX package."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None], logits,
                       torch.zeros((), device=logits.device)).sum(-1)
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def chunked_cross_entropy(x, head: dict, labels, mask, *, chunk: int = 1024):
    """Sequence-chunked CE: the logits are formed one sequence chunk at a
    time. The JAX package rematerializes each chunk in the backward
    (``jax.checkpoint``); that changes memory, not values, and the port
    keeps each chunk's logits for the backward instead.

    x: (B, S, d) final hidden states; head: lm_head param dict;
    labels/mask: (B, S). Returns the mean nll over ``mask``.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(x.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = dense(head, x[:, sl]).float()
        nll = torch.logsumexp(logits, dim=-1) - _gold(logits, labels[:, sl])
        tot = tot + torch.sum(nll * mask[:, sl].float())
    return tot / torch.clamp(torch.sum(mask.float()), min=1.0)
