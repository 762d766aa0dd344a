"""Mamba-2 (SSD) block, as used by Zamba2 (arXiv:2411.15242): the port of
the JAX package's ``models/mamba2.py``.

Structured state-space duality with scalar-per-head decay:
    h_t = a_t * h_{t-1} + x_t (outer) B_t        h: (P, N) per head
    y_t = h_t @ C_t + D * x_t
with a_t = exp(-softplus(dt_t) * A), dt data-dependent, plus a short causal
conv on the (x, B, C) stream and a gated output (silu(z)).

The projections, the conv, softplus and exp, the D skip and the gated
RMSNorm are PyTorch ops at the JAX package's rounding points (the conv is
JAX's sum of W products in order i = 0 .. W-1, not ``F.conv1d``, whose f32
accumulation rounds elsewhere; softplus is ``jax.nn.softplus``'s
``logaddexp(x, 0)``, not ``F.softplus``, which turns linear above 20).
The state recurrence runs on ``kernels.mamba2_scan.mamba2_recurrence``
(the hand-written CUDA kernels, forward and backward, on the card; their
plain versions on the CPU), with exactly the inputs of JAX's scan. JAX
pads the sequence to its 64-step chunk with a = 1 and x = 0, which leaves
the state unchanged; the kernels take any S, so the port pads nothing.
Single-token decode (``mamba2_step``) runs the same recurrence at S = 1
with the carried state, so serving runs the ``mamba2_fwd`` kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan import mamba2_recurrence
from repro_torch.models.layers import dense, dense_init, rmsnorm
from repro_torch.obs.timing import annotate

HEAD_DIM = 64   # P

#: the profiler's name (``obs.timing.annotate``) of the full-sequence
#: recurrence, read from a trace by chip_smoke's profile of zamba2
SCAN = "mamba2_scan"


def mamba2_init(gen: torch.Generator, cfg, dtype) -> dict:
    """The JAX tree, keys, shapes and distributions; the weights are drawn
    from ``gen`` in the order of the JAX package's key split."""
    d = cfg.d_model
    N = cfg.ssm_state
    d_inner = 2 * d
    H = d_inner // HEAD_DIM
    # in_proj -> [x (d_inner), z (d_inner), B (N), C (N), dt (H)]
    w_in = dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype)
    conv = 0.1 * torch.randn((cfg.conv_width, d_inner + 2 * N),
                             generator=gen, dtype=torch.float32,
                             device=gen.device)
    w_out = dense_init(gen, d_inner, d, dtype)
    return {
        "w_in": w_in,
        "conv": conv.to(dtype),
        "A_log": torch.zeros((H,), dtype=torch.float32),
        "D": torch.ones((H,), dtype=torch.float32),
        "dt_bias": torch.zeros((H,), dtype=torch.float32),
        "norm_g": torch.ones((d_inner,), dtype=dtype),
        "w_out": w_out,
    }


def _dims(cfg):
    d = cfg.d_model
    d_inner = 2 * d
    H = d_inner // HEAD_DIM
    return d_inner, H, cfg.ssm_state


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc, conv_w, conv_state):
    """xbc: (B, S, C); conv_w: (W, C); conv_state: (B, W-1, C) prior
    inputs. The W products summed in order i = 0 .. W-1 in the model
    dtype, as JAX's Python ``sum``."""
    W = conv_w.shape[0]
    S = xbc.shape[1]
    ext = torch.cat([conv_state, xbc], dim=1)            # (B, S+W-1, C)
    out = ext[:, 0:S, :] * conv_w[0]
    for i in range(1, W):
        out = out + ext[:, i:i + S, :] * conv_w[i]
    new_state = ext[:, -(W - 1):, :] if W > 1 else conv_state
    return F.silu(out), new_state


def init_mamba_state(cfg, batch: int, dtype, device=None) -> dict:
    d_inner, H, N = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, H, HEAD_DIM, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * N),
                            dtype=dtype, device=device),
    }


def _project(p, cfg, u):
    d_inner, H, N = _dims(cfg)
    zxbcdt = dense(p["w_in"], u)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xbc, dt


def _decay(p, dt):
    """(a, dt_s): the decay exp(softplus(dt + dt_bias) A) in (0, 1] and
    the step size, f32."""
    A = -torch.exp(p["A_log"])                             # (H,) negative
    dt_s = _softplus(dt.float() + p["dt_bias"])
    return torch.exp(dt_s * A), dt_s


def _gate_out(p, y, z, dtype):
    """The gated RMSNorm and the output projection of y (..., d_inner)."""
    y = rmsnorm({"g": p["norm_g"]}, y.to(dtype)) * F.silu(z)
    return dense(p["w_out"], y)


def mamba2_fwd(p, cfg, u, state):
    """Full-sequence forward. u: (B, S, d). Returns (out, new_state)."""
    B, S, d = u.shape
    d_inner, H, N = _dims(cfg)
    z, xbc, dt = _project(p, cfg, u)
    xbc, conv_state = _causal_conv(xbc, p["conv"], state["conv"])
    x = xbc[..., :d_inner].reshape(B, S, H, HEAD_DIM)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    a, dt_s = _decay(p, dt)                                 # (B, S, H)
    xdt = x.float() * dt_s[..., None]                       # dt-scaled input
    with annotate(SCAN):
        y, h_new = mamba2_recurrence(a, xdt, Bm.float(), Cm.float(),
                                     state["ssm"])
    y = y + p["D"][None, None, :, None] * x.float()
    out = _gate_out(p, y.reshape(B, S, d_inner), z, u.dtype)
    return out, dict(state, ssm=h_new, conv=conv_state)


def mamba2_step(p, cfg, u, state):
    """Single-token decode. u: (B, d). Returns (out (B, d), new_state)."""
    B, d = u.shape
    d_inner, H, N = _dims(cfg)
    z, xbc, dt = _project(p, cfg, u)
    # conv over the ring of the last W-1 inputs
    ext = torch.cat([state["conv"], xbc[:, None, :]], dim=1)   # (B, W, C)
    xbc_t = F.silu(torch.sum(ext * p["conv"][None], dim=1))    # (B, C)
    new_conv = ext[:, 1:, :]
    x = xbc_t[..., :d_inner].reshape(B, H, HEAD_DIM)
    Bm = xbc_t[..., d_inner:d_inner + N].float()
    Cm = xbc_t[..., d_inner + N:].float()
    a, dt_s = _decay(p, dt)                                     # (B, H)
    xdt = x.float() * dt_s[..., None]
    y, h = mamba2_recurrence(a[:, None], xdt[:, None], Bm[:, None],
                             Cm[:, None], state["ssm"])
    y = y[:, 0] + p["D"][None, :, None] * x.float()
    out = _gate_out(p, y.reshape(B, d_inner), z, u.dtype)
    return out, dict(state, ssm=h, conv=new_conv)
