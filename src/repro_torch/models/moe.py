"""Mixture-of-Experts layer (GShard-style top-k dispatch with capacity).

The port of the JAX package's ``models/moe.py``: ``moe_init``,
``_capacity``, ``_dispatch_combine``, ``_expert_ffn``, ``moe_apply``
(the global dispatch, and the blocked one over groups of
``cfg.moe_group_size`` tokens) with its Switch-style aux loss, and
``moe_apply_dense``, the decode path's dense form. Dispatch and combine
are one-hot products, as in JAX; they are plain ``torch.einsum`` products
(JAX computes them outside any Pallas kernel). JAX's ``constrain`` calls
are mesh hints and have no counterpart on one card.

Two details keep the routing JAX's:
- ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` does not promise that, a stable descending sort does
  (``_top_k``).
- One-hots are comparisons with ``torch.arange`` (``_one_hot``), not
  ``F.one_hot``, which reads its input's range on the host and so cannot
  run under the client plane's ``torch.func.vmap`` over cohorts.

``moe_serve`` is ``moe_apply_dense`` on the serving path: the router's
f32 product and every expert's projections on the row-invariant GEMM
(``kernels.invariant_dense``: the router alone, each two experts'
w_in | w_gate pairs in one launch, each w_out alone), and the gate
renormalisation and the combine as per-row elementwise steps in expert
order in f32, so a token's output does not depend on the rows beside it
on the card. The router's softmax is ``torch.softmax``: over E <= 1024
columns its CUDA kernel handles each row alone whatever the row count
(chip_smoke's row-invariance probe holds it to that). On the CPU it is ``moe_apply_dense`` bit for bit:
both run ``_dense_experts``, one with ``x @ w``, one with the kernels,
whose plain versions are ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.invariant_dense import (MAX_GROUP,
                                                invariant_dense,
                                                invariant_dense_group)
from repro_torch.models.layers import dense_init, uniform_init
from repro_torch.obs.timing import annotate


#: the profiler's names (``obs.timing.annotate``) for ``moe_apply``'s
#: parts: the routing and the dispatch product, the experts' GEMMs, the
#: combine product
DISPATCH, EXPERTS, COMBINE = "moe_dispatch", "moe_experts", "moe_combine"


def moe_init(gen: torch.Generator, cfg, dtype) -> dict:
    """router f32 (d, E); w_in, w_gate (E, d, f) at scale d**-0.5 and
    w_out (E, f, d) at f**-0.5 in the model dtype."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    scale = (1.0 / d) ** 0.5
    return {"router": dense_init(gen, d, E, torch.float32),
            "w_in": uniform_init(gen, (E, d, f), scale, dtype),
            "w_gate": uniform_init(gen, (E, d, f), scale, dtype),
            "w_out": uniform_init(gen, (E, f, d), (1.0 / f) ** 0.5, dtype)}


def _capacity(tokens: int, cfg) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, ((cap + 7) // 8) * 8)   # pad to multiple of 8


def _one_hot(idx, n: int, dtype):
    """(..., ) int -> (..., n) of ``dtype``: 1 where the index is."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(xt, probs, cfg):
    """Capacity-based one-hot dispatch for token groups.

    xt: (..., T, d); probs: (..., T, E). Returns (dispatch (..., T, E, C)
    in xt's dtype, combine (..., T, E, C) in f32). Each (token, k)
    assignment takes the next place in its expert's buffer, every k = 0
    assignment before any k = 1 and in token order; those past the
    capacity C are dropped (their gate zeroed).
    """
    *lead, T, _ = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    gate_vals, expert_idx = _top_k(probs, K)                      # (.., T, K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    C = _capacity(T, cfg)
    onehot = _one_hot(expert_idx, E, torch.int32)                 # (.., T, K, E)
    # priority: k=0 assignments first, then token order
    flat = onehot.transpose(-3, -2).reshape(*lead, K * T, E)
    pos_in_expert = torch.cumsum(flat, dim=-2, dtype=torch.int32) - flat
    pos = pos_in_expert.reshape(*lead, K, T, E).transpose(-3, -2)
    pos = torch.sum(pos * onehot, dim=-1)                         # (.., T, K)
    keep = pos < C                                                # capacity drop
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    slot = torch.where(keep, pos, torch.full_like(pos, C))
    disp = torch.sum(_one_hot(expert_idx, E, xt.dtype)[..., None]
                     * _one_hot(slot, C + 1, xt.dtype)[..., :C][..., None, :],
                     dim=-3)                                      # (.., T, E, C)
    comb = torch.sum(_one_hot(expert_idx, E, torch.float32)[..., None]
                     * _one_hot(slot, C + 1, torch.float32)[..., :C][
                         ..., None, :]
                     * gate_vals[..., None, None].float(), dim=-3)
    return disp, comb


def _expert_ffn(p, xe):
    h = torch.einsum("...ecd,edf->...ecf", xe, p["w_in"])
    g = torch.einsum("...ecd,edf->...ecf", xe, p["w_gate"])
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * h, p["w_out"])


def moe_apply(p, cfg, x):
    """x: (B, S, d) -> (B, S, d), plus the aux load-balancing loss (an f32
    scalar). T = B * S tokens: in groups of ``cfg.moe_group_size`` (each
    with its own capacity) when T is a larger multiple of it, else in one
    group."""
    B, S, d = x.shape
    E = cfg.num_experts
    T = B * S
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]["w"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)

    Gsz = cfg.moe_group_size
    if Gsz and T > Gsz and T % Gsz == 0:
        # blocked dispatch: a fixed capacity a group -> linear-in-T FLOPs
        G = T // Gsz
        xg = xt.reshape(G, Gsz, d)
        with annotate(DISPATCH):
            disp, comb = _dispatch_combine(xg, probs.reshape(G, Gsz, E), cfg)
            xe = torch.einsum("gtd,gtec->gecd", xg, disp)          # (G, E, C, d)
        with annotate(EXPERTS):
            ye = _expert_ffn(p, xe)
        with annotate(COMBINE):
            out = torch.einsum("gecd,gtec->gtd", ye.float(), comb).reshape(
                T, d)
    else:
        with annotate(DISPATCH):
            disp, comb = _dispatch_combine(xt, probs, cfg)
            xe = torch.einsum("td,tec->ecd", xt, disp)             # (E, C, d)
        with annotate(EXPERTS):
            ye = _expert_ffn(p, xe)
        with annotate(COMBINE):
            out = torch.einsum("ecd,tec->td", ye.float(), comb)

    # aux loss (Switch-style load balance)
    _, expert_idx = _top_k(probs, cfg.top_k)
    me = torch.mean(probs, dim=0)                                 # (E,)
    ce = torch.mean(_one_hot(expert_idx[:, 0], E, torch.float32), dim=0)
    aux = E * torch.sum(me * ce)

    return out.reshape(B, S, d).to(x.dtype), aux


def _combine_step(out, y, w):
    """``out + y * w`` in f32, one expert's term of the combine (``out``
    None before the first): elementwise, each row alone."""
    term = y.float() * w
    return term if out is None else out + term


def _dense_experts(p, cfg, x, proj, proj_group):
    """``moe_apply_dense`` with the projections ``proj(x, w)`` and
    ``proj_group(x, [w, ...])``: every token through every expert, its
    output the gate-weighted sum of its top-k experts' outputs."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(B * S, d)
    probs = torch.softmax(proj(xt.float(), p["router"]["w"]), dim=-1)
    gate_vals, expert_idx = _top_k(probs, K)                      # (T, K)
    total = gate_vals[:, 0]
    for k in range(1, K):
        total = total + gate_vals[:, k]
    gate_vals = gate_vals / torch.clamp(total, min=1e-9)[:, None]
    onehot = _one_hot(expert_idx, E, torch.float32)               # (T, K, E)
    w = onehot[:, 0] * gate_vals[:, :1]                           # (T, E)
    for k in range(1, K):
        w = w + onehot[:, k] * gate_vals[:, k:k + 1]
    per = MAX_GROUP // 2                    # experts' w_in|w_gate a launch
    out = None
    for e0 in range(0, E, per):
        hg = proj_group(xt, [m for e in range(e0, min(E, e0 + per))
                             for m in (p["w_in"][e], p["w_gate"][e])])
        for j in range(0, len(hg), 2):
            e = e0 + j // 2
            y = proj(F.silu(hg[j + 1]) * hg[j], p["w_out"][e])
            out = _combine_step(out, y, w[:, e:e + 1])
    return out.reshape(B, S, d).to(x.dtype), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def moe_apply_dense(p, cfg, x):
    """Decode-path MoE: tiny token count, a dense pass of every expert is
    cheaper than capacity dispatch. x: (B, S, d). Returns (out, 0.0)."""
    return _dense_experts(p, cfg, x, lambda a, w: a @ w,
                          lambda a, ws: [a @ w for w in ws])


def moe_serve(p, cfg, x):
    """``moe_apply_dense`` on the row-invariant kernels (see the module
    docstring): the router 1 launch, the experts' w_in | w_gate E / 2
    launches and their w_out E launches."""
    return _dense_experts(
        p, cfg, x, invariant_dense,
        lambda a, ws: invariant_dense_group(a, [(w, None) for w in ws]))
