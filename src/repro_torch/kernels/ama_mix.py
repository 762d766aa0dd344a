"""The AMA parameter-mix kernel: ``alpha * prev + sum_k w_k * stacked_k``.

Replaces the JAX package's ``kernels/ama_mix.py: ama_mix_flat`` (Pallas).
It carries the legacy per-leaf server chain (``--server-plane legacy
--use-kernel``, ``kernels/ops.py``). The kernel is hand-written CUDA C++
for ``sm_90a`` (``csrc/ama_mix.cu``) and mixes many leaves in one
launch: ``ama_mix_leaves`` makes one launch for each (prev dtype,
stacked dtype) group of up to ``MAX_LEAVES`` leaves, so the paper CNN's
8 f32 leaves take 1 launch a round. The leaf table (``leaf_launches``,
a plain function) travels in the launch's parameters. Each leaf is read
on 16-byte loads where its N is a multiple of the vector unit
(``unit_elems``) and its pointers are aligned, one element a thread
otherwise. alpha and the weights are read from device memory; the f32
accumulation is rounded op by op in the plain version's order
(``kernels/ref.py: ama_mix_math``), so the two are equal bit for bit.
Bound by HBM bytes, ``(K+2)·N·s`` for element size s; at the CNN's
leaf sizes, by the launch. ``ama_mix_flat`` is the one-leaf call, the
counterpart of the JAX ``ama_mix_flat``.

Dispatch is by device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel, or the wrapper raises.
``ama_mix_leaves.launches`` counts the kernel's launches (every call of
either wrapper on CUDA tensors), ``ama_mix_flat.launches`` the
one-leaf calls among them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check, _check_k,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["ama_mix_flat", "ama_mix_leaves", "leaf_launches", "unit_elems",
           "MAX_LEAVES", "THREADS", "LEAF_BLOCKS"]

#: leaves one launch's table holds (csrc/ama_mix.cu: kMaxLeaves)
MAX_LEAVES = 64
#: threads a block, each taking one unit of a leaf at a time, and the
#: most blocks a leaf takes (csrc/common.cuh: kThreads, kMaxBlocks)
THREADS = 256
LEAF_BLOCKS = 132 * 16


class _LeafTable(ctypes.Structure):
    """csrc/ama_mix.cu: LeafTable, field for field."""
    _fields_ = [("prev", ctypes.c_void_p * MAX_LEAVES),
                ("stacked", ctypes.c_void_p * MAX_LEAVES),
                ("out", ctypes.c_void_p * MAX_LEAVES),
                ("n", ctypes.c_longlong * MAX_LEAVES),
                ("first_block", ctypes.c_int * (MAX_LEAVES + 1)),
                ("vec", ctypes.c_int * MAX_LEAVES),
                ("count", ctypes.c_int)]


def unit_elems(prev_dtype, stacked_dtype) -> int:
    """Elements of a 16-byte vector unit: 16 bytes of the narrower
    operand (8 where either is bf16, 4 where both are f32)."""
    return 16 // min(prev_dtype.itemsize, stacked_dtype.itemsize)


@dataclass(frozen=True)
class LeafLaunch:
    """One launch's leaf table: the leaves (indices into the caller's
    lists, in order), each leaf's N, first block (``first_block[-1]`` is
    the grid), vector flag and (prev, stacked, out) pointers."""
    prev_dtype: torch.dtype
    stacked_dtype: torch.dtype
    leaves: tuple
    n: tuple
    first_block: tuple
    vec: tuple
    ptrs: tuple

    def table(self) -> _LeafTable:
        """The table as the C entry takes it."""
        t, m = _LeafTable(), len(self.leaves)
        t.prev[:m], t.stacked[:m], t.out[:m] = zip(*self.ptrs)
        t.n[:m], t.vec[:m] = self.n, self.vec
        t.first_block[:m + 1] = self.first_block
        t.count = m
        return t


def leaf_launches(prevs, stackeds, outs) -> list[LeafLaunch]:
    """The launches of one ``ama_mix_leaves`` call: leaves grouped by
    (prev dtype, stacked dtype) in order of first appearance, each group
    split into tables of at most ``MAX_LEAVES`` in leaf order; empty
    leaves are left out. A leaf is read on 16-byte vectors where its N
    is a multiple of ``unit_elems`` and its prev, stacked and out start
    on 16-byte boundaries; it takes ceil(units / THREADS) blocks, at
    most ``LEAF_BLOCKS`` (which then walk it in a grid-stride loop)."""
    groups: dict = {}
    for j, (p, s) in enumerate(zip(prevs, stackeds, strict=True)):
        if p.numel():
            groups.setdefault((p.dtype, s.dtype), []).append(j)
    launches = []
    for (pdt, sdt), idxs in groups.items():
        E = unit_elems(pdt, sdt)
        for c in range(0, len(idxs), MAX_LEAVES):
            chunk = tuple(idxs[c:c + MAX_LEAVES])
            first, ns, vec, ptrs = [0], [], [], []
            for j in chunk:
                n = prevs[j].numel()
                ptr = (prevs[j].data_ptr(), stackeds[j].data_ptr(),
                       outs[j].data_ptr())
                v = n % E == 0 and not (ptr[0] | ptr[1] | ptr[2]) % 16
                units = n // E if v else n
                first.append(first[-1] + min(-(-units // THREADS),
                                             LEAF_BLOCKS))
                ns.append(n)
                vec.append(v)
                ptrs.append(ptr)
            if first[-1] >= 2 ** 31:
                raise ValueError(f"ama_mix: {first[-1]} blocks in one "
                                 "launch, beyond the grid")
            launches.append(LeafLaunch(pdt, sdt, chunk, tuple(ns),
                                       tuple(first), tuple(vec), tuple(ptrs)))
    return launches


def ama_mix_leaves(prevs, stackeds, alpha, weights):
    """prevs: a list of (N_j,) f32/bf16; stackeds: the matching list of
    (K, N_j) f32/bf16; alpha: (1,) or 0-dim f32; weights: (K,) f32, all
    on one device. Returns the list of outputs, (N_j,) in prevs[j]'s
    dtype."""
    if len(prevs) != len(stackeds) or not prevs:
        raise ValueError("ama_mix_leaves takes one stacked operand a leaf, "
                         "and at least one leaf")
    K = stackeds[0].shape[0]
    dev = prevs[0].device
    alpha = alpha.reshape(1)
    for j, (p, s) in enumerate(zip(prevs, stackeds)):
        if (p.dim() == 1 and s.shape == (K, p.shape[0])
                and p.dtype in _DTYPE_CODE and s.dtype in _DTYPE_CODE
                and p.device == dev == s.device and p.is_contiguous()
                and s.is_contiguous()):
            continue                    # the common case, checked cheaply
        (N,) = p.shape
        _check(f"prevs[{j}]", p, (N,), tuple(_DTYPE_CODE), dev)
        _check(f"stackeds[{j}]", s, (K, N), tuple(_DTYPE_CODE), dev)
    _check("alpha", alpha, (1,), (torch.float32,), dev)
    _check("weights", weights, (K,), (torch.float32,), dev)
    if not _kernel_device(prevs[0]):
        return ref.ama_mix_leaves_math(prevs, stackeds, alpha, weights)
    _check_k("ama_mix", K)
    lib = build.load()
    outs = [torch.empty_like(p) for p in prevs]
    stream = _stream(dev)
    for launch in leaf_launches(prevs, stackeds, outs):
        table = launch.table()
        err = lib.ama_mix_leaves(
            _DTYPE_CODE[launch.prev_dtype], _DTYPE_CODE[launch.stacked_dtype],
            ctypes.byref(table), ctypes.sizeof(table), _ptr(alpha),
            _ptr(weights), K, stream)
        _raise_on(err, "ama_mix")
        ama_mix_leaves.launches += 1
    return outs


def ama_mix_flat(prev, stacked, alpha, weights):
    """prev: (N,) f32/bf16; stacked: (K, N) f32/bf16; alpha: (1,) or
    0-dim f32; weights: (K,) f32, all on one device. Returns out (N,) in
    prev's dtype: ``ama_mix_leaves`` over the one leaf."""
    (out,) = ama_mix_leaves([prev], [stacked], alpha, weights)
    if prev.is_cuda and prev.numel():
        ama_mix_flat.launches += 1
    return out


ama_mix_leaves.launches = 0
ama_mix_flat.launches = 0
