"""The serving steps' RMSNorm on a row-invariant hand-written kernel.

``invariant_rmsnorm(x, g, eps=1e-6)``: ``layers.rmsnorm`` over the last
axis of x (..., d) with the gain g (d,), returned in x's dtype. It
replaces no Pallas kernel: it is the XLA reduction of the JAX package's
``models/layers.py: rmsnorm`` (:41) on the serving path. PyTorch's CUDA
``mean`` picks its threads per row by the number of rows, so a row's
norm depended on how many rows came with it (bf16 at d 4,096: up to
3.9e-3 apart between M = 4 and M = 256 on an H100, chip_smoke's probe).
The kernel (``csrc/invariant_rmsnorm.cu``) reduces each row in one block
in an order fixed by d alone.

Only the transformer family's serving steps call it (the two norms of a
block and the final norm): 2 a layer and 1 a step.

Dispatch is by device: a CPU tensor takes the plain version
(``ref.invariant_rmsnorm_ref``, the bits of ``layers.rmsnorm``); a CUDA
tensor launches the kernel, or the wrapper raises. The wrapper counts
its launches (``invariant_rmsnorm.launches``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["invariant_rmsnorm", "KERNELS", "reset_counts"]


def invariant_rmsnorm(x, g, eps: float = 1e-6):
    """RMSNorm of x (..., d) with gain g (d,); see the module docstring."""
    d = x.shape[-1] if x.dim() else 0
    dev = x.device
    _check("x", x, tuple(x.shape), tuple(_DTYPE_CODE), dev)
    _check("g", g, (d,), (x.dtype,), dev)
    if not _kernel_device(x):
        return ref.invariant_rmsnorm_ref(x, g, eps)
    M = x.numel() // d if d else 0
    if M < 1:
        raise ValueError(f"invariant_rmsnorm takes a non-empty x, got "
                         f"{tuple(x.shape)}")
    y = torch.empty_like(x)
    err = build.load().invariant_rmsnorm(_DTYPE_CODE[x.dtype], _ptr(x),
                                         _ptr(g), _ptr(y), M, d, float(eps),
                                         _stream(dev))
    _raise_on(err, "invariant_rmsnorm")
    invariant_rmsnorm.launches += 1
    return y


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"invariant_rmsnorm": invariant_rmsnorm}
invariant_rmsnorm.launches = 0


def reset_counts() -> None:
    """Zero the launch count of the row-invariant RMSNorm."""
    invariant_rmsnorm.launches = 0
