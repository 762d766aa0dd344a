"""The serving projections on a row-invariant hand-written GEMM.

``invariant_dense(x, w, b=None)`` computes ``x @ w (+ b)`` with x
(..., K), w (K, N) in the JAX layout (``d_in, d_out``), b (N,) or None,
returning (..., N) in x's dtype. It replaces no Pallas kernel: it is the
XLA dot of the JAX package's ``models/layers.py: dense`` (:22) on the
serving path. On the card every output element is summed over K in an
order fixed by (K, N) alone, whatever the number of rows M
(``csrc/invariant_dense.cu``: bf16 on the tensor cores, f32 with one
fmaf a k on the CUDA cores): a row of a 256-row prefill chunk equals
that row of a 4-row decode step bit for bit, which ``torch.matmul``
(cuBLAS picks its tiling and split of K by M) does not give.

Only the transformer family's serving steps call it (the attention
projections, the MLP, ``lm_head``): 7 a layer and 1 a step. Training
keeps ``layers.dense``.

Dispatch is by device: a CPU tensor takes the plain version
(``ref.invariant_dense_ref``: ``x @ w + b``, the bits of
``layers.dense``); a CUDA tensor launches the kernel, or the wrapper
raises. The wrapper counts its launches (``invariant_dense.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check, _counters,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["invariant_dense", "split_k", "KERNELS", "reset_counts"]

#: the bf16 kernel's tile of y (rows, columns) and its K step
#: (csrc/invariant_dense.cu)
TILE_M, TILE_N, BK = 64, 64, 64
#: split K until the n tiles give this many blocks ...
SPLIT_BLOCKS = 256
#: ... or a range would fall below this many k
SPLIT_MIN_K = 512

def split_k(K: int, N: int) -> int:
    """The number of K ranges of the bf16 kernel: a function of (K, N)
    alone, never of M. Doubles while the n tiles give fewer than
    SPLIT_BLOCKS blocks, the ranges stay multiples of the K step and at
    least SPLIT_MIN_K long."""
    n_tiles = -(-N // TILE_N)
    s = 1
    while (n_tiles * s < SPLIT_BLOCKS and K % (2 * s * BK) == 0
           and K // (2 * s) >= SPLIT_MIN_K):
        s *= 2
    return s


def invariant_dense(x, w, b=None):
    """x (..., K) @ w (K, N) (+ b (N,)), in x's dtype; see the module
    docstring."""
    K, N = w.shape if w.dim() == 2 else (0, 0)
    dev = x.device
    lead = tuple(x.shape[:-1])
    M = 1
    for d in lead:
        M *= d
    _check("x", x, (*lead, K), tuple(_DTYPE_CODE), dev)
    _check("w", w, (K, N), (x.dtype,), dev)
    if b is not None:
        _check("b", b, (N,), (x.dtype,), dev)
    if not _kernel_device(x):
        return ref.invariant_dense_ref(x, w, b)
    if K < 1 or N < 1 or M < 1:
        raise ValueError(f"invariant_dense takes non-empty operands: x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"invariant_dense reads 16-byte rows: K ({K}) and "
                         f"N ({N}) must be multiples of 8")
    if any(t.data_ptr() % 16 for t in (x, w) + (() if b is None else (b,))):
        raise ValueError("invariant_dense: x, w and b must start on a "
                         "16-byte boundary")
    y = torch.empty((*lead, N), dtype=x.dtype, device=dev)
    S = split_k(K, N) if x.dtype == torch.bfloat16 else 1
    null = ctypes.c_void_p(None)
    part = cnt = None       # held here until the launch is enqueued
    if S > 1:
        cnt = _counters(dev, -(-M // TILE_M) * -(-N // TILE_N))
        part = torch.empty((S, M, N), dtype=torch.float32, device=dev)
    err = build.load().invariant_dense(
        _DTYPE_CODE[x.dtype], _ptr(x), _ptr(w),
        null if b is None else _ptr(b), _ptr(y),
        null if part is None else _ptr(part),
        null if cnt is None else _ptr(cnt), M, N, K, S, _stream(dev))
    _raise_on(err, "invariant_dense")
    invariant_dense.launches += 1
    return y


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"invariant_dense": invariant_dense}
invariant_dense.launches = 0


def reset_counts() -> None:
    """Zero the launch count of the row-invariant GEMM."""
    invariant_dense.launches = 0
