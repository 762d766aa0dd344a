"""The AMA parameter-mix kernel: ``alpha * prev + sum_k w_k * stacked_k``.

Replaces the JAX package's ``kernels/ama_mix.py: ama_mix_flat`` (Pallas).
It carries the legacy per-leaf server chain (``--server-plane legacy
--use-kernel``, ``kernels/ops.py``): one launch per leaf per round.
The kernel is hand-written CUDA C++ for ``sm_90a``
(``csrc/ama_mix.cu``): one thread per element, alpha and the weights
read from device memory, f32 accumulation rounded op by op in the plain
version's order (``kernels/ref.py: ama_mix_math``), so the two are
equal bit for bit. Bound by HBM bytes: ``(K+2)·N·s`` for element size s.

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel, or the wrapper raises. ``ama_mix_flat
.launches`` counts the calls that launch the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check, _check_k,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["ama_mix_flat"]


def ama_mix_flat(prev, stacked, alpha, weights):
    """prev: (N,) f32/bf16; stacked: (K, N) f32/bf16; alpha: (1,) or
    0-dim f32; weights: (K,) f32, all on one device. Returns out (N,) in
    prev's dtype."""
    (N,) = prev.shape
    K = stacked.shape[0]
    dev = prev.device
    alpha = alpha.reshape(1)
    _check("prev", prev, (N,), tuple(_DTYPE_CODE), dev)
    _check("stacked", stacked, (K, N), tuple(_DTYPE_CODE), dev)
    _check("alpha", alpha, (1,), (torch.float32,), dev)
    _check("weights", weights, (K,), (torch.float32,), dev)
    if not _kernel_device(prev):
        return ref.ama_mix_math(prev, stacked, alpha, weights)
    _check_k("ama_mix", K)
    lib = build.load()
    out = torch.empty_like(prev)
    err = lib.ama_mix(_DTYPE_CODE[prev.dtype], _DTYPE_CODE[stacked.dtype],
                      _ptr(prev), _ptr(stacked), _ptr(alpha), _ptr(weights),
                      _ptr(out), K, N, _stream(dev))
    _raise_on(err, "ama_mix")
    ama_mix_flat.launches += 1
    return out


ama_mix_flat.launches = 0
