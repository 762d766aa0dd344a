"""The serving steps' residual add and RMSNorm on a row-invariant
hand-written kernel.

``invariant_add_rmsnorm(x, h, g, eps=1e-6)`` returns ``(s, y)``: s = x + h
rounded to x's dtype as PyTorch's ``x + h`` rounds it, and y =
``layers.rmsnorm`` of s over the last axis with the gain g (d,), in x's
dtype; one launch. ``invariant_rmsnorm(x, g, eps=1e-6)`` is the norm-only
form of the same kernel (y alone, for the one norm site with no pending
add): on the card ``invariant_rmsnorm(s, g)`` is bitwise
``invariant_add_rmsnorm(x, h, g)[1]``.

They replace no Pallas kernel: they are the XLA reduction of the JAX
package's ``models/layers.py: rmsnorm`` (:41) on the serving path, with
the residual add before it. PyTorch's CUDA ``mean`` picks its threads per
row by the number of rows, so a row's norm depended on how many rows came
with it (bf16 at d 4,096: up to 3.9e-3 apart between M = 4 and M = 256 on
an H100, chip_smoke's probe). The kernel (``csrc/invariant_rmsnorm.cu``)
gives a row 1 to 16 warps and reduces it in an order fixed by d alone, on
16-byte loads where d and the pointers allow (``plan``); it takes d up to
16,384 in bf16 and 8,192 in f32.

Only the transformer family's serving steps call them: a dense step at L
layers launches ``invariant_add_rmsnorm`` 2 L times (each block's two
norms after its adds, the final norm after the last block's MLP) and
``invariant_rmsnorm`` once (the first block's norm of the embedding).

Dispatch is by device: a CPU tensor takes the plain versions
(``ref.invariant_add_rmsnorm_ref``, ``ref.invariant_rmsnorm_ref``: ``x +
h`` and the bits of ``layers.rmsnorm``); a CUDA tensor launches the
kernel, or the wrapper raises. Each wrapper counts its launches
(``launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["invariant_add_rmsnorm", "invariant_rmsnorm", "plan", "KERNELS",
           "reset_counts"]


def _rows(x, d: int, what: str) -> int:
    M = x.numel() // d if d else 0
    if M < 1:
        raise ValueError(f"{what} takes a non-empty x, got {tuple(x.shape)}")
    return M


def invariant_add_rmsnorm(x, h, g, eps: float = 1e-6):
    """(x + h, RMSNorm of x + h with gain g (d,)) for x, h (..., d); see
    the module docstring."""
    d = x.shape[-1] if x.dim() else 0
    dev = x.device
    _check("x", x, tuple(x.shape), tuple(_DTYPE_CODE), dev)
    _check("h", h, tuple(x.shape), (x.dtype,), dev)
    _check("g", g, (d,), (x.dtype,), dev)
    if not _kernel_device(x):
        return ref.invariant_add_rmsnorm_ref(x, h, g, eps)
    M = _rows(x, d, "invariant_add_rmsnorm")
    s = torch.empty_like(x)
    y = torch.empty_like(x)
    err = build.load().invariant_rmsnorm(_DTYPE_CODE[x.dtype], _ptr(x),
                                         _ptr(h), _ptr(g), _ptr(s), _ptr(y),
                                         M, d, float(eps), _stream(dev))
    _raise_on(err, "invariant_add_rmsnorm")
    invariant_add_rmsnorm.launches += 1
    return s, y


def invariant_rmsnorm(x, g, eps: float = 1e-6):
    """RMSNorm of x (..., d) with gain g (d,): the norm-only form of
    ``invariant_add_rmsnorm``; see the module docstring."""
    d = x.shape[-1] if x.dim() else 0
    dev = x.device
    _check("x", x, tuple(x.shape), tuple(_DTYPE_CODE), dev)
    _check("g", g, (d,), (x.dtype,), dev)
    if not _kernel_device(x):
        return ref.invariant_rmsnorm_ref(x, g, eps)
    M = _rows(x, d, "invariant_rmsnorm")
    y = torch.empty_like(x)
    err = build.load().invariant_rmsnorm(_DTYPE_CODE[x.dtype], _ptr(x),
                                         None, _ptr(g), None, _ptr(y), M, d,
                                         float(eps), _stream(dev))
    _raise_on(err, "invariant_rmsnorm")
    invariant_rmsnorm.launches += 1
    return y


def plan(d: int, dtype) -> tuple[int, int, bool]:
    """The kernel's plan for rows of width d in ``dtype`` (a function of d
    alone): (warps a row, 16-byte vectors a thread, whether d takes the
    16-byte loads; otherwise the per-element form). Raises where d is
    wider than the kernel takes. Needs the built library."""
    out = (ctypes.c_int * 4)()
    build.load().invariant_rmsnorm_plan(_DTYPE_CODE[dtype], d, out)
    if out[3]:
        raise ValueError(f"invariant_rmsnorm takes d up to 16384 (bf16) or "
                         f"8192 (f32), got {d} in {dtype}")
    return out[0], out[1], bool(out[2])


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"invariant_add_rmsnorm": invariant_add_rmsnorm,
           "invariant_rmsnorm": invariant_rmsnorm}


def reset_counts() -> None:
    """Zero both forms' launch counts."""
    for fn in KERNELS.values():
        fn.launches = 0


reset_counts()
