"""The Mamba-2 (SSD) state recurrence, forward and backward: two
hand-written CUDA kernels and the autograd plumbing that lets
``torch.func`` differentiate and vmap through them.

The JAX package has no Pallas kernel here: it runs the recurrence as a
``lax.scan`` over 64-step chunks under ``jax.checkpoint``
(``models/mamba2.py: mamba2_fwd``) and leaves its gradient to XLA. The
kernels are CUDA C++ for ``sm_90a`` (``csrc/mamba2_scan.cu``), in
Mamba-2's chunked (SSD) form with their products on the tensor cores in
3xTF32:

  * ``mamba2_fwd`` — y and h_final, and the state entering every
                     ``MAMBA2_CKPT``-step chunk, which the backward starts
                     each chunk from (three launches a call: the chunks'
                     own contributions, the scan over chunk boundaries,
                     the outputs; below S = ``MAMBA2_CKPT`` one launch of
                     the per-step form);
  * ``mamba2_bwd`` — da, dxdt, dB, dC and dh0 in the same form run in
                     reverse (four launches a call: the chunks' adjoint
                     contributions, the reverse scan, the chunk gradients
                     with dB and dC summed over groups of heads, the sum
                     over the groups in order).

A call is counted as one launch whatever its device kernels. Dispatch is
by device: a CPU tensor takes the plain version in ``kernels/ref.py``
(``mamba2_scan_ref``, ``mamba2_scan_bwd_ref``, the same signatures); a
CUDA tensor launches the kernel, or the wrapper raises. Each kernel
wrapper counts its launches (``mamba2_fwd.launches``, ...).

``mamba2_recurrence(a, xdt, Bm, Cm, h0)`` is the differentiable entry the
model calls, for any S. It is built from two ``torch.autograd.Function``s,
``Mamba2Scan`` and ``Mamba2ScanBwd``, each with a ``vmap`` rule: the
client plane runs ``vmap(grad_and_value(loss))`` over the cohorts, where
a, xdt, Bm and Cm carry the cohort dim and h0 (made inside the loss) does
not. The rule folds the cohort dim into B, launches once and unfolds. One
vmapped call is one call of each kernel wrapper, whatever the cohort
count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_check, _fold, _kernel_device,
                                         _ptr, _raise_on, _stream, _unfold)

__all__ = ["mamba2_recurrence", "mamba2_fwd", "mamba2_bwd", "Mamba2Scan",
           "Mamba2ScanBwd", "KERNELS", "reset_counts", "STATE_SIZES",
           "HEAD_DIM"]

#: state sizes N the CUDA kernels are instantiated for
STATE_SIZES = (16, 32, 64)
#: the head dim P the kernels take (models/mamba2.py: HEAD_DIM)
HEAD_DIM = 64
#: the most heads a block of the output and gradient kernels takes; the
#: backward's dB and dC leave a partial sum per group of heads
_HEAD_GROUP = 8

_F32 = (torch.float32,)


def _geometry(a, xdt, Bm, Cm):
    """(B, S, H, P, N) of contiguous f32 a (B, S, H), xdt (B, S, H, P) and
    Bm, Cm (B, S, N) on one device."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    _check("a", a, (B, S, H), _F32, dev)
    _check("xdt", xdt, (B, S, H, P), _F32, dev)
    _check("Bm", Bm, (B, S, N), _F32, dev)
    _check("Cm", Cm, (B, S, N), _F32, dev)
    return B, S, H, P, N


def _states_shape(B, S, H, P, N):
    return (B, H, -(-S // ref.MAMBA2_CKPT), P, N)


def _decay_scratch(B, S, H, dev):
    """The chunks' decay products A_c, (B, H, ceil(S / MAMBA2_CKPT))."""
    return torch.empty((B, H, -(-S // ref.MAMBA2_CKPT)), dtype=torch.float32,
                       device=dev)


def _launch_checks(what, P, N, *operands):
    """Refuse a (P, N) the kernels are not built for, and operands that do
    not start on a 16-byte boundary (the kernels stage rows 16 bytes at a
    time)."""
    if P != HEAD_DIM or N not in STATE_SIZES:
        raise ValueError(f"the mamba2 kernels take P = {HEAD_DIM} and N in "
                         f"{STATE_SIZES}, got P={P}, N={N}")
    if any(x.data_ptr() % 16 for x in operands):
        raise ValueError(f"{what} takes its operands starting on a 16-byte "
                         "boundary")


def mamba2_fwd(a, xdt, Bm, Cm, h0):
    """a: (B, S, H) f32; xdt: (B, S, H, P) f32; Bm, Cm: (B, S, N) f32; h0:
    (B, H, P, N) f32. Returns (y (B, S, H, P), h_final (B, H, P, N),
    states (B, H, ceil(S / MAMBA2_CKPT), P, N)), all f32."""
    B, S, H, P, N = _geometry(a, xdt, Bm, Cm)
    _check("h0", h0, (B, H, P, N), _F32, xdt.device)
    if not _kernel_device(xdt):
        return ref.mamba2_scan_ref(a, xdt, Bm, Cm, h0)
    _launch_checks("mamba2_fwd", P, N, xdt, Bm, Cm, h0)
    y = torch.empty_like(xdt)
    h_final = torch.empty_like(h0)
    states = torch.empty(_states_shape(B, S, H, P, N), dtype=torch.float32,
                         device=xdt.device)
    decay = _decay_scratch(B, S, H, xdt.device)
    err = build.load().mamba2_fwd(
        N, ref.MAMBA2_CKPT, _ptr(a), _ptr(xdt), _ptr(Bm), _ptr(Cm), _ptr(h0),
        _ptr(y), _ptr(h_final), _ptr(states), _ptr(decay), B, S, H, P,
        min(_HEAD_GROUP, H), _stream(xdt.device))
    _raise_on(err, "mamba2_fwd")
    mamba2_fwd.launches += 1
    return y, h_final, states


def mamba2_bwd(dy, dh, a, xdt, Bm, Cm, states):
    """dy: (B, S, H, P) f32; dh: (B, H, P, N) f32, the gradient of
    h_final; a, xdt, Bm, Cm as the forward took them and ``states`` as it
    returned them. Returns (da, dxdt, dB, dC, dh0), f32, shaped as a,
    xdt, Bm, Cm and h0."""
    B, S, H, P, N = _geometry(a, xdt, Bm, Cm)
    dev = xdt.device
    _check("dy", dy, (B, S, H, P), _F32, dev)
    _check("dh", dh, (B, H, P, N), _F32, dev)
    _check("states", states, _states_shape(B, S, H, P, N), _F32, dev)
    if not _kernel_device(xdt):
        return ref.mamba2_scan_bwd_ref(dy, dh, a, xdt, Bm, Cm, states)
    _launch_checks("mamba2_bwd", P, N, dy, dh, xdt, Bm, Cm, states)
    da, dxdt, dB, dC = (torch.empty_like(x) for x in (a, xdt, Bm, Cm))
    dh0 = torch.empty_like(dh)
    # dB and dC per group of heads, summed over the groups by the last
    # launch
    hg = min(_HEAD_GROUP, H)
    groups = -(-H // hg)
    dBp, dCp = (torch.empty((B, S, groups, N), dtype=torch.float32,
                            device=dev) for _ in range(2))
    # the adjoint of the state leaving every chunk, from the steps after it
    adj = torch.empty(_states_shape(B, S, H, P, N), dtype=torch.float32,
                      device=dev)
    decay = _decay_scratch(B, S, H, dev)
    err = build.load().mamba2_bwd(
        N, ref.MAMBA2_CKPT, _ptr(dy), _ptr(dh), _ptr(a), _ptr(xdt), _ptr(Bm),
        _ptr(Cm), _ptr(states), _ptr(da), _ptr(dxdt), _ptr(dB), _ptr(dC),
        _ptr(dh0), _ptr(dBp), _ptr(dCp), _ptr(adj), _ptr(decay), B, S, H, P,
        hg, _stream(dev))
    _raise_on(err, "mamba2_bwd")
    mamba2_bwd.launches += 1
    return da, dxdt, dB, dC, dh0


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"mamba2_fwd": mamba2_fwd, "mamba2_bwd": mamba2_bwd}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_counts() -> None:
    """Zero the launch count of every mamba2 kernel."""
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# autograd and vmap
# ---------------------------------------------------------------------------

class Mamba2Scan(torch.autograd.Function):
    """(a, xdt, Bm, Cm, h0) -> (y, h_final, states); states is not
    differentiable. The backward is ``Mamba2ScanBwd``."""

    @staticmethod
    def forward(a, xdt, Bm, Cm, h0):
        return mamba2_fwd(a, xdt, Bm, Cm, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, xdt, Bm, Cm, _ = inputs
        states = output[2]
        ctx.save_for_backward(a, xdt, Bm, Cm, states)
        ctx.mark_non_differentiable(states)

    @staticmethod
    def backward(ctx, dy, dh, _dstates):
        a, xdt, Bm, Cm, states = ctx.saved_tensors
        return Mamba2ScanBwd.apply(dy.contiguous(), dh.contiguous(), a, xdt,
                                   Bm, Cm, states)

    @staticmethod
    def vmap(info, in_dims, a, xdt, Bm, Cm, h0):
        n = info.batch_size
        out = Mamba2Scan.apply(*(_fold(x, d, n) for x, d
                                 in zip((a, xdt, Bm, Cm, h0), in_dims)))
        return tuple(_unfold(x, n) for x in out), (0, 0, 0)


class Mamba2ScanBwd(torch.autograd.Function):
    """(dy, dh, a, xdt, Bm, Cm, states) -> (da, dxdt, dB, dC, dh0). Not
    differentiable itself (no double backward)."""

    @staticmethod
    def forward(dy, dh, a, xdt, Bm, Cm, states):
        return mamba2_bwd(dy, dh, a, xdt, Bm, Cm, states)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("mamba2_scan has no double backward")

    @staticmethod
    def vmap(info, in_dims, dy, dh, a, xdt, Bm, Cm, states):
        n = info.batch_size
        out = Mamba2ScanBwd.apply(*(_fold(x, d, n) for x, d in zip(
            (dy, dh, a, xdt, Bm, Cm, states), in_dims)))
        return tuple(_unfold(x, n) for x in out), (0,) * 5


def mamba2_recurrence(a, xdt, Bm, Cm, h0):
    """Differentiable Mamba-2 recurrence, any S. a: (B, S, H) f32 (the
    decay); xdt: (B, S, H, P) f32; Bm, Cm: (B, S, N) f32; h0: (B, H, P, N)
    f32. Returns (y (B, S, H, P) f32, h_final (B, H, P, N) f32)."""
    y, h_final, _ = Mamba2Scan.apply(a.contiguous(), xdt.contiguous(),
                                     Bm.contiguous(), Cm.contiguous(),
                                     h0.contiguous())
    return y, h_final
