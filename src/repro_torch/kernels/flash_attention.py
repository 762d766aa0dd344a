"""Flash attention, forward and backward: three hand-written CUDA kernels
and the autograd plumbing that lets ``torch.func`` differentiate and
vmap through them.

Replaces the JAX package's ``kernels/flash_attention.py: flash_attention``
(Pallas) for the forward; the backward replaces the XLA autodiff of
``models/attention.py: chunked_attention`` (the Pallas kernel has none).
The kernels are CUDA C++ for ``sm_90a``:

  * ``flash_fwd``      — online-softmax attention; also writes the row
                         log-sum-exp ``lse`` (B, H, Sq) f32;
  * ``flash_bwd_dq``   — D = rowsum(dO * O) and dQ, one block per q tile;
  * ``flash_bwd_dkdv`` — dK and dV, one block per (kv head, kv tile),
                         looping over the query heads of its kv head,
                         reading D.

Each takes q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) with H % Hkv ==
0: query head h reads kv head h // (H // Hkv), as ``repeat_interleave``
of kv would give (grouped-query attention without the copy); dk and dv
come back at Hkv heads. ``Hkv == H`` is the TPU kernel's contract (kv
already head-repeated). Any length goes: the kernels mask the ragged
last tile and store no row past Sq or Skv. Sq may differ from Skv only
without a causal mask or a window (cross-attention, every key visible,
as the JAX package's encoder-decoder uses it); other combinations are
refused. The C entries dispatch by dtype: bf16 runs on
the tensor cores (``csrc/flash_attention_sm90.cu``: wgmma, TMA tile
loads, P and dS rounded to bf16 as FlashAttention rounds them), f32 on
the CUDA cores in f32 (``csrc/flash_attention.cu``), since f32 callers
are held to f32 products. ``design_launches()`` reads the launches each
design has made on the card. The backward is two passes, so no
atomics: every launch is deterministic and the port's chunked ==
per-round contract holds bitwise. Each kernel is bound by operations
(its flops at the tensor-core or f32 rate; see the sources' notes).

Dispatch is by device: a CPU tensor takes the plain version in
``kernels/ref.py`` (``flash_attention_ref``, ``flash_bwd_dq_ref``,
``flash_bwd_dkdv_ref``, the same signatures); a CUDA tensor launches the
kernel, or the wrapper raises. Each kernel wrapper counts its launches
(``flash_fwd.launches``, ...).

``flash_attention(q, k, v, *, causal=True, window=0, scale=None)`` is
the differentiable entry, with the TPU kernel's positional signature
(and none of its 128-row blocks: any Sq, Skv >= 1). It is built from two
``torch.autograd.Function``s, ``FlashAttention`` and
``FlashAttentionBwd``, each with a ``vmap`` rule: the client plane runs
``vmap(grad_and_value(loss))`` over the cohorts, and a ctypes kernel
cannot take a batched tensor, so the rule moves the vmapped dim to the
front, folds it into B, launches once and unfolds the result. One
vmapped call is one forward launch and one launch of each backward
kernel, whatever the cohort count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check, _fold,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream, _unfold)

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
           "FlashAttention", "FlashAttentionBwd", "KERNELS", "reset_counts",
           "design_launches", "HEAD_DIMS"]

#: head dims the CUDA kernels are instantiated for
HEAD_DIMS = (64, 96, 128)


def _geometry(q, k, v, causal, window):
    """(B, Sq, Skv, H, Hkv, hd) of contiguous f32/bf16 q (B, Sq, H, hd)
    and k, v (B, Skv, Hkv, hd), H a multiple of Hkv, Sq, Skv >= 1; Sq !=
    Skv only where ``causal`` and ``window`` are off."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1] if k.dim() == 4 else Sq   # else _check refuses k
    Hkv = k.shape[2] if k.dim() == 4 else H
    dev = q.device
    _check("q", q, (B, Sq, H, hd), tuple(_DTYPE_CODE), dev)
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"k has {Hkv} heads, which must divide q's {H} "
                         f"(shape {tuple(k.shape)})")
    _check("k", k, (B, Skv, Hkv, hd), (q.dtype,), dev)
    _check("v", v, (B, Skv, Hkv, hd), (q.dtype,), dev)
    if Sq < 1 or Skv < 1:
        raise ValueError(f"flash attention takes Sq, Skv >= 1, got "
                         f"{Sq}, {Skv}")
    if Sq != Skv and (causal or window):
        raise ValueError(f"q of {Sq} rows against k, v of {Skv} "
                         f"(cross-attention) takes no causal mask and no "
                         f"window, got causal={bool(causal)}, "
                         f"window={window}")
    return B, Sq, Skv, H, Hkv, hd


def _args(causal, window, scale, hd):
    scale = hd ** -0.5 if scale is None else float(scale)
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return int(bool(causal)), int(window), scale


def _launch_checks(hd):
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernels take head dims "
                         f"{HEAD_DIMS}, got {hd}")


def flash_fwd(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd), f32/bf16. Returns (out
    (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32)."""
    B, Sq, Skv, H, Hkv, hd = _geometry(q, k, v, causal, window)
    if not _kernel_device(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    _launch_checks(hd)
    c, w, sc = _args(causal, window, scale, hd)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = build.load().flash_fwd(
        _DTYPE_CODE[q.dtype], hd, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(lse), B, Sq, Skv, H, Hkv, c, w, ctypes.c_float(sc),
        _stream(q.device))
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def _check_rows(name, x, B, H, S, dev):
    _check(name, x, (B, H, S), (torch.float32,), dev)


def flash_bwd_dq(dout, q, k, v, out, lse, *, causal=True, window=0,
                 scale=None):
    """dout/out: (B, Sq, H, hd) in q's dtype; lse: (B, H, Sq) f32 from the
    forward. Returns (dq in q's dtype, D = rowsum(dout * out) (B, H, Sq)
    f32, which ``flash_bwd_dkdv`` takes)."""
    B, Sq, Skv, H, Hkv, hd = _geometry(q, k, v, causal, window)
    dev = q.device
    _check("dout", dout, (B, Sq, H, hd), (q.dtype,), dev)
    _check("out", out, (B, Sq, H, hd), (q.dtype,), dev)
    _check_rows("lse", lse, B, H, Sq, dev)
    if not _kernel_device(q):
        return ref.flash_bwd_dq_ref(dout, q, k, v, out, lse, causal=causal,
                                    window=window, scale=scale)
    _launch_checks(hd)
    c, w, sc = _args(causal, window, scale, hd)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    err = build.load().flash_bwd_dq(
        _DTYPE_CODE[q.dtype], hd, _ptr(dout), _ptr(q), _ptr(k), _ptr(v),
        _ptr(out), _ptr(lse), _ptr(dq), _ptr(delta), B, Sq, Skv, H, Hkv, c,
        w, ctypes.c_float(sc), _stream(dev))
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkdv(dout, q, k, v, lse, delta, *, causal=True, window=0,
                   scale=None):
    """dout: (B, Sq, H, hd) in q's dtype; lse, delta: (B, H, Sq) f32
    (delta from ``flash_bwd_dq``). Returns (dk, dv) (B, Skv, Hkv, hd) in
    k's and v's dtype, summed over the query heads of each kv head."""
    B, Sq, Skv, H, Hkv, hd = _geometry(q, k, v, causal, window)
    dev = q.device
    _check("dout", dout, (B, Sq, H, hd), (q.dtype,), dev)
    _check_rows("lse", lse, B, H, Sq, dev)
    _check_rows("delta", delta, B, H, Sq, dev)
    if not _kernel_device(q):
        return ref.flash_bwd_dkdv_ref(dout, q, k, v, lse, delta,
                                      causal=causal, window=window,
                                      scale=scale)
    _launch_checks(hd)
    c, w, sc = _args(causal, window, scale, hd)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = build.load().flash_bwd_dkdv(
        _DTYPE_CODE[q.dtype], hd, _ptr(dout), _ptr(q), _ptr(k), _ptr(v),
        _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), B, Sq, Skv, H, Hkv, c,
        w, ctypes.c_float(sc), _stream(dev))
    _raise_on(err, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
           "flash_bwd_dkdv": flash_bwd_dkdv}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_counts() -> None:
    """Zero the launch count of every flash-attention kernel."""
    for fn in KERNELS.values():
        fn.launches = 0


#: the kernels' two designs, in the order of the C entries' counts
DESIGNS = ("cuda_cores", "wgmma")


def design_launches() -> dict:
    """{kernel: {"cuda_cores": n, "wgmma": m}}: the launches the C entries
    have made so far in this process, by design (f32 on the CUDA cores,
    bf16 on the tensor cores). Needs the built library (the card)."""
    counts = (ctypes.c_longlong * 6)()
    build.load().flash_design_counts(counts)
    return {name: dict(zip(DESIGNS, counts[2 * i:2 * i + 2]))
            for i, name in enumerate(KERNELS)}


# ---------------------------------------------------------------------------
# autograd and vmap
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """(q, k, v, causal, window, scale) -> (out, lse); lse is not
    differentiable. The backward is ``FlashAttentionBwd``."""

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return flash_fwd(q, k, v, causal=causal, window=window, scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.attn = (causal, window, scale)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBwd.apply(dout.contiguous(), q, k, v, out,
                                             lse, *ctx.attn)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        n = info.batch_size
        qf, kf, vf = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims))
        out, lse = FlashAttention.apply(qf, kf, vf, causal, window, scale)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class FlashAttentionBwd(torch.autograd.Function):
    """(dout, q, k, v, out, lse, causal, window, scale) -> (dq, dk, dv):
    the dQ pass, then the dK/dV pass. Not differentiable itself (no
    double backward)."""

    @staticmethod
    def forward(dout, q, k, v, out, lse, causal, window, scale):
        kw = dict(causal=causal, window=window, scale=scale)
        dq, delta = flash_bwd_dq(dout, q, k, v, out, lse, **kw)
        dk, dv = flash_bwd_dkdv(dout, q, k, v, lse, delta, **kw)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no double backward")

    @staticmethod
    def vmap(info, in_dims, dout, q, k, v, out, lse, causal, window, scale):
        n = info.batch_size
        folded = [_fold(x, d, n) for x, d
                  in zip((dout, q, k, v, out, lse), in_dims)]
        grads = FlashAttentionBwd.apply(*folded, causal, window, scale)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Differentiable flash attention. q: (B, Sq, H, hd), k/v: (B, Skv,
    Hkv, hd) f32/bf16, H a multiple of Hkv (Hkv == H: kv already
    head-repeated, the TPU kernel's contract), any Sq, Skv >= 1, Sq !=
    Skv only with ``causal`` False and ``window`` 0 (cross-attention);
    ``scale=None`` is hd**-0.5 (the TPU kernel's semantics). Returns out
    (B, Sq, H, hd) in q's dtype."""
    _geometry(q, k, v, causal, window)
    out, _ = FlashAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), bool(causal), int(window),
                                  scale)
    return out
