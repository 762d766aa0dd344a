"""The RWKV-6 recurrence, forward and backward: two hand-written CUDA
kernels and the autograd plumbing that lets ``torch.func`` differentiate
and vmap through them.

Replaces the JAX package's ``kernels/rwkv6_scan.py: rwkv6_scan``
(Pallas) for the forward; the backward replaces the XLA autodiff of the
scan in ``models/rwkv6.py: time_mix`` (the Pallas kernel has none). The
kernels are CUDA C++ for ``sm_90a`` (``csrc/rwkv6_scan.cu``):

  * ``rwkv6_fwd`` — y and s_final; also the state entering every
                    ``RWKV6_CKPT``-th step, which the backward restarts
                    from; in chunk-parallel form: a scan of the state
                    over segment boundaries only (its column groups in
                    parallel), then every segment's y from its saved
                    state in matrix form (two launches a call, counted
                    as one), without atomics;
  * ``rwkv6_bwd`` — dr, dk, dv, dw, du and ds0 by the adjoint recurrence
                    in chunk-parallel form: a scan of the adjoint over
                    segment boundaries only, then every segment's outputs
                    from its saved state in matrix form (two launches a
                    call, counted as one), without atomics.

Dispatch is by device: a CPU tensor takes the plain version in
``kernels/ref.py`` (``rwkv6_scan_ref``, ``rwkv6_scan_bwd_ref``, the same
signatures); a CUDA tensor launches the kernel, or the wrapper raises.
Each kernel wrapper counts its launches (``rwkv6_fwd.launches``, ...).
The kernel wrappers take u with one row per batch row (B, H, hd) and
return du likewise.

``rwkv6_scan(r, k, v, w, u, s0, *, chunk=128)`` is the differentiable
entry, with the TPU kernel's positional signature and its shape
contract (S a multiple of min(chunk, S)). ``rwkv6_recurrence(r, k, v,
w, u, s0)`` is the same for any S, which the kernels take: the model
calls it. Both expand the shared u (H, hd) to its rows once, so autograd
sums du over them. They are built from two ``torch.autograd.Function``s,
``RWKV6Scan`` and ``RWKV6ScanBwd``, each with a ``vmap`` rule: the client
plane runs ``vmap(grad_and_value(loss))`` over the cohorts, where r, k,
v, w and the per-cohort parameter u carry the cohort dim and s0 (made
inside the loss) does not. The rule folds the cohort dim into B, launches
once and unfolds. One vmapped call is one call of each kernel wrapper,
whatever the cohort count: two launches of each kernel (one a pass), and
each wrapper counts its calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_check, _fold, _kernel_device,
                                         _ptr, _raise_on, _stream, _unfold)

__all__ = ["rwkv6_scan", "rwkv6_recurrence", "rwkv6_fwd", "rwkv6_bwd",
           "RWKV6Scan", "RWKV6ScanBwd", "KERNELS", "reset_counts",
           "HEAD_DIMS"]

#: head dims the CUDA kernels are instantiated for
HEAD_DIMS = (16, 32, 64)

_F32 = (torch.float32,)


def _check_seq(S: int, chunk: int) -> None:
    """The TPU kernel's shape contract (its time chunks)."""
    c = min(chunk, S)
    if S < 1 or c < 1 or S % c:
        raise ValueError(f"rwkv6_scan takes S a multiple of min(chunk, S) "
                         f"(its time chunks), got S={S}, chunk={chunk}")


def _geometry(r, k, v, w, u):
    """(B, S, H, hd) of matching, contiguous f32 r, k, v, w, and u of
    shape (B, H, hd)."""
    B, S, H, hd = r.shape
    dev = r.device
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, x, (B, S, H, hd), _F32, dev)
    _check("u", u, (B, H, hd), _F32, dev)
    return B, S, H, hd


def _states_shape(B, S, H, hd):
    return (B, H, -(-S // ref.RWKV6_CKPT), hd, hd)


def _launch_checks(what, hd, **aligned):
    """Refuse an hd the kernels are not built for, and operands in
    ``aligned`` that do not start on a 16-byte boundary (the kernels stage
    them into shared memory 16 bytes at a time)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the rwkv6 kernels take head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if any(x.data_ptr() % 16 for x in aligned.values()):
        raise ValueError(f"{what} takes {', '.join(aligned)} starting on a "
                         "16-byte boundary")


def rwkv6_fwd(r, k, v, w, u, s0):
    """r/k/v/w: (B, S, H, hd) f32; u: (B, H, hd) f32; s0:
    (B, H, hd, hd) f32. Returns (y (B, S, H, hd), s_final (B, H, hd, hd),
    states (B, H, ceil(S / RWKV6_CKPT), hd, hd)), all f32."""
    B, S, H, hd = _geometry(r, k, v, w, u)
    _check("s0", s0, (B, H, hd, hd), _F32, r.device)
    if not _kernel_device(r):
        return ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    _launch_checks("rwkv6_fwd", hd, r=r, k=k, v=v, w=w)
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    states = torch.empty(_states_shape(B, S, H, hd), dtype=torch.float32,
                         device=r.device)
    err = build.load().rwkv6_fwd(
        hd, ref.RWKV6_CKPT, _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u),
        _ptr(s0), _ptr(y), _ptr(s_final), _ptr(states), B, S, H,
        _stream(r.device))
    _raise_on(err, "rwkv6_fwd")
    rwkv6_fwd.launches += 1
    return y, s_final, states


def rwkv6_bwd(dy, ds, r, k, v, w, u, states):
    """dy: (B, S, H, hd) f32; ds: (B, H, hd, hd) f32, the gradient of
    s_final; r, k, v, w, u as the forward took them and ``states`` as it
    returned them. Returns (dr, dk, dv, dw, du (B, H, hd), ds0), f32."""
    B, S, H, hd = _geometry(r, k, v, w, u)
    dev = r.device
    _check("dy", dy, (B, S, H, hd), _F32, dev)
    _check("ds", ds, (B, H, hd, hd), _F32, dev)
    _check("states", states, _states_shape(B, S, H, hd), _F32, dev)
    if not _kernel_device(r):
        return ref.rwkv6_scan_bwd_ref(dy, ds, r, k, v, w, u, states)
    _launch_checks("rwkv6_bwd", hd, r=r, k=k, v=v, w=w, dy=dy)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty_like(ds)
    # the adjoint leaving every segment, the boundary scan's output
    scratch = torch.empty(_states_shape(B, S, H, hd), dtype=torch.float32,
                          device=dev)
    err = build.load().rwkv6_bwd(
        hd, ref.RWKV6_CKPT, _ptr(dy), _ptr(ds), _ptr(r), _ptr(k), _ptr(v),
        _ptr(w), _ptr(u), _ptr(states), _ptr(dr), _ptr(dk), _ptr(dv),
        _ptr(dw), _ptr(du), _ptr(ds0), _ptr(scratch), B, S, H, _stream(dev))
    _raise_on(err, "rwkv6_bwd")
    rwkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


#: kernel name -> its wrapper (each carries a ``launches`` count)
KERNELS = {"rwkv6_fwd": rwkv6_fwd, "rwkv6_bwd": rwkv6_bwd}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_counts() -> None:
    """Zero the launch count of every rwkv6 kernel."""
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# autograd and vmap
# ---------------------------------------------------------------------------

class RWKV6Scan(torch.autograd.Function):
    """(r, k, v, w, u, s0) -> (y, s_final, states); states is not
    differentiable. The backward is ``RWKV6ScanBwd``."""

    @staticmethod
    def forward(r, k, v, w, u, s0):
        return rwkv6_fwd(r, k, v, w, u, s0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, w, u, _ = inputs
        states = output[2]
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.mark_non_differentiable(states)

    @staticmethod
    def backward(ctx, dy, ds, _dstates):
        r, k, v, w, u, states = ctx.saved_tensors
        return RWKV6ScanBwd.apply(dy.contiguous(), ds.contiguous(), r, k, v,
                                  w, u, states)

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0):
        n = info.batch_size
        out = RWKV6Scan.apply(*(_fold(x, d, n) for x, d
                                in zip((r, k, v, w, u, s0), in_dims)))
        return tuple(_unfold(x, n) for x in out), (0, 0, 0)


class RWKV6ScanBwd(torch.autograd.Function):
    """(dy, ds, r, k, v, w, u, states) -> (dr, dk, dv, dw, du, ds0). Not
    differentiable itself (no double backward)."""

    @staticmethod
    def forward(dy, ds, r, k, v, w, u, states):
        return rwkv6_bwd(dy, ds, r, k, v, w, u, states)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("rwkv6_scan has no double backward")

    @staticmethod
    def vmap(info, in_dims, dy, ds, r, k, v, w, u, states):
        n = info.batch_size
        out = RWKV6ScanBwd.apply(*(_fold(x, d, n) for x, d in zip(
            (dy, ds, r, k, v, w, u, states), in_dims)))
        return tuple(_unfold(x, n) for x in out), (0,) * 6


def rwkv6_recurrence(r, k, v, w, u, s0):
    """Differentiable RWKV-6 recurrence, any S. r/k/v/w: (B, S, H, hd) f32
    (w in (0, 1)); u: (H, hd) f32, shared by the batch rows; s0: (B, H,
    hd, hd) f32. Returns (y (B, S, H, hd) f32, s_final (B, H, hd, hd)
    f32)."""
    u_rows = u.expand(r.shape[0], *u.shape).contiguous()
    y, s_final, _ = RWKV6Scan.apply(r.contiguous(), k.contiguous(),
                                    v.contiguous(), w.contiguous(), u_rows,
                                    s0.contiguous())
    return y, s_final


def rwkv6_scan(r, k, v, w, u, s0, *, chunk=128):
    """``rwkv6_recurrence`` under the TPU kernel's signature and shape
    contract: S a multiple of min(chunk, S). Returns (y, s_final), as the
    TPU kernel does."""
    _check_seq(r.shape[1], chunk)
    return rwkv6_recurrence(r, k, v, w, u, s0)
