"""RWKV-6 ("Finch") block: data-dependent decay linear attention (the
port of the JAX package's ``models/rwkv6.py``, full-sequence path).

Faithful to arXiv:2404.05892 at the block level:
  * token shift (learned per-channel lerp with previous token),
  * low-rank data-dependent decay  w_t = exp(-exp(w0 + tanh(x A) B)),
  * per-head state recurrence  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
  * per-head group-norm, silu(g) gate, output projection,
  * squared-ReLU channel mixing.

The JAX model runs the recurrence as a two-level ``lax.scan`` (per-chunk
remat) and leaves its gradient to XLA; the port runs it on
``kernels.rwkv6_scan.rwkv6_recurrence`` (the hand-written CUDA kernels,
forward and backward, on the card; their plain versions on the CPU). The rounding
points are the reference's: r, k and v leave ``dense`` in the model
dtype and enter the recurrence in f32, w is f32 from ``_decay``, u is
cast to f32, and y is cast to the model dtype before the group-norm.
JAX pads the sequence to a multiple of its 64-step chunk with w = 1; the
kernels take any length, so the port pads nothing and takes every S that
JAX takes (the TPU kernel's contract, S a multiple of min(chunk, S),
binds only its public ``rwkv6_scan`` entry).
Single-token decode (``time_mix_step``, ``channel_mix(single=True)``)
runs the one-step recurrence through the same
``rwkv6_recurrence`` at S = 1, so the serving path runs the ``rwkv6_fwd``
kernel on the card; the wkv state stays f32, the shift states x_tm and
x_cm in the model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_recurrence
from repro_torch.models.layers import (dense, dense_init, layernorm,
                                       layernorm_init)

HEAD_DIM = 64
DECAY_RANK = 32


def rwkv6_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The JAX tree, keys and shapes; the dense weights are drawn from
    ``gen`` in the order of the JAX package's key split."""
    d = cfg.d_model
    H = d // HEAD_DIM
    d_ff = int(3.5 * d) if cfg.d_ff == 0 else cfg.d_ff
    wr, wk, wv, wg, wo = (dense_init(gen, d, d, dtype) for _ in range(5))
    wA = dense_init(gen, d, DECAY_RANK, dtype)
    wB = dense_init(gen, DECAY_RANK, d, dtype)
    ck = dense_init(gen, d, d_ff, dtype)
    cv = dense_init(gen, d_ff, d, dtype)
    cr = dense_init(gen, d, d, dtype)
    return {
        "mix": 0.5 * torch.ones((5, d), dtype=dtype),   # r,k,v,w,g shift
        "wr": wr, "wk": wk, "wv": wv, "wg": wg, "wo": wo,
        "w0": torch.full((d,), -4.0, dtype=dtype),      # decay (low-rank)
        "wA": wA, "wB": wB,
        "u": torch.zeros((H, HEAD_DIM), dtype=dtype),   # bonus
        "ln_x": layernorm_init(d, dtype),
        "cmix": 0.5 * torch.ones((2, d), dtype=dtype),  # channel mix
        "ck": ck, "cv": cv, "cr": cr,
    }


def _token_shift(x, x_prev_last):
    """Shift x right by one along the sequence; position 0 gets
    x_prev_last."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _decay(p, xw):
    """w in (0, 1), f32: the low-rank term in the model dtype, the clip
    to [-8, 4] and the double exp in f32."""
    lr = torch.tanh(dense(p["wA"], xw)) @ p["wB"]["w"]
    logw = -torch.exp(torch.clamp(p["w0"].float() + lr.float(), -8.0, 4.0))
    return torch.exp(logw)


def init_rwkv_state(cfg, batch: int, dtype, device=None) -> dict:
    d = cfg.d_model
    H = d // HEAD_DIM
    return {
        "wkv": torch.zeros((batch, H, HEAD_DIM, HEAD_DIM),
                           dtype=torch.float32, device=device),
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def time_mix(p, cfg, x, state):
    """Full-sequence forward. x: (B, S, d). Returns (y, new_state)."""
    B, S, d = x.shape
    H = d // HEAD_DIM
    xs = _token_shift(x, state["x_tm"])
    xr, xk, xv, xw, xg = (x + p["mix"][i] * (xs - x) for i in range(5))
    r = dense(p["wr"], xr).reshape(B, S, H, HEAD_DIM)
    k = dense(p["wk"], xk).reshape(B, S, H, HEAD_DIM)
    v = dense(p["wv"], xv).reshape(B, S, H, HEAD_DIM)
    g = dense(p["wg"], xg)
    w = _decay(p, xw).reshape(B, S, H, HEAD_DIM)
    y, s_new = rwkv6_recurrence(r.float(), k.float(), v.float(), w,
                                p["u"].float(), state["wkv"])
    y = layernorm(p["ln_x"], y.reshape(B, S, d).to(x.dtype))  # group-norm
    y = y * F.silu(g)                                          # proxy
    out = dense(p["wo"], y)
    return out, dict(state, wkv=s_new, x_tm=x[:, -1, :])


def time_mix_step(p, cfg, x, state):
    """Single-token decode. x: (B, d). Returns (y (B, d), new_state)."""
    B, d = x.shape
    H = d // HEAD_DIM
    xs = state["x_tm"]
    xr, xk, xv, xw, xg = (x + p["mix"][i] * (xs - x) for i in range(5))
    r = dense(p["wr"], xr).reshape(B, 1, H, HEAD_DIM).float()
    k = dense(p["wk"], xk).reshape(B, 1, H, HEAD_DIM).float()
    v = dense(p["wv"], xv).reshape(B, 1, H, HEAD_DIM).float()
    g = dense(p["wg"], xg)
    w = _decay(p, xw).reshape(B, 1, H, HEAD_DIM)
    y, s_new = rwkv6_recurrence(r, k, v, w, p["u"].float(), state["wkv"])
    y = layernorm(p["ln_x"], y.reshape(B, d).to(x.dtype)) * F.silu(g)
    return dense(p["wo"], y), dict(state, wkv=s_new, x_tm=x)


def channel_mix(p, x, state, single: bool = False):
    """Squared-ReLU channel mix over a sequence x (B, S, d), or over one
    token x (B, d) when ``single``. Returns (out, new_state)."""
    if single:
        xs, new_last = state["x_cm"], x
    else:
        xs, new_last = _token_shift(x, state["x_cm"]), x[:, -1, :]
    xk = x + p["cmix"][0] * (xs - x)
    xr = x + p["cmix"][1] * (xs - x)
    k = torch.square(F.relu(dense(p["ck"], xk)))
    out = torch.sigmoid(dense(p["cr"], xr)) * dense(p["cv"], k)
    return out, dict(state, x_cm=new_last)
