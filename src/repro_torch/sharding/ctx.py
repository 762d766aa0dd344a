"""Mesh-context-aware operations on the stacked client axis.

The port's counterpart of the JAX package's ``sharding/ctx.py``. Model
and strategy code is mesh-agnostic: each function here reads the mesh
that ``use(mesh)`` made active (``exec.engine.ChunkRunner`` activates
its mesh around a dispatch, as the JAX engine runs under ``with mesh``)
and is the identity, with no op issued, when none is active or it has no
process group. So a run without a mesh computes exactly what it did
before the mesh existed.

Under a mesh of client width > 1 (``launch.mesh.FLMesh``) a rank holds
only its own cohort block of the stacked client axis:

  * ``constrain_leading`` takes that block of a full (C, ...) stack;
  * ``gather_leading`` all-gathers the blocks back into the (C, ...)
    stack in cohort order (a copy: the rows keep their bits), before the
    fused server plane;
  * ``reduce_leading`` is the pre-reduced client axis: each rank
    contracts its own cohorts into a weighted f32 partial, and the
    partials are summed across client shards in shard order
    (``shard_sum``: an all-to-all of 1/W slices, each rank adds its
    slices in shard order, an all-gather of the sums), never by an
    all-reduce or atomics, so the sum is the same bits from run to run.
    It moves 2 (W - 1) / W x R x 4N bytes a round per rank where the
    gather moves (C - C / W) x N x s.

Every collective books its wall time under the active timer's
"collective" phase, opened and closed by a device sync. Under gloo the
collectives stage device tensors through the host (gloo's CUDA support
does not cover all-gather).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.utils.tree import leaves, tree_map, unflatten

#: (mesh, timer, stats) of the innermost ``use`` block, or None
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_fl_mesh", default=None)


class CollectiveStats:
    """Bytes this rank received through the collectives, and the calls."""

    def __init__(self):
        self.bytes_in = 0
        self.calls = 0


@contextlib.contextmanager
def use(mesh, timer=None, stats: CollectiveStats | None = None):
    """Make ``mesh`` the active mesh inside the block; ``timer`` (a
    ``obs.timing.PhaseTimes``) books the "collective" phase and ``stats``
    counts the bytes received."""
    token = _ACTIVE.set((mesh, timer, stats))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    act = _ACTIVE.get()
    return act[0] if act is not None else None


def axis_size(name: str) -> int:
    """Size of a mesh axis ("client" or "dsub") in the active mesh; 1
    when no mesh is active or the axis does not exist."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    return {"client": mesh.client, "dsub": mesh.dsub}.get(name, 1)


def constrain_leading(tree, C: int, dim: int = 0):
    """The rank's cohort block of every leaf whose dim ``dim`` holds all
    C cohorts (numpy arrays or tensors; other leaves, a rank's block
    among them, pass through). The identity at client width 1."""
    mesh = active_mesh()
    if mesh is None or mesh.client == 1:
        return tree
    block = (slice(None),) * dim + (mesh.cohorts(C),)

    def take(x):
        shape = getattr(x, "shape", ())
        return x[block] if len(shape) > dim and shape[dim] == C else x

    return tree_map(take, tree)


@contextlib.contextmanager
def _collective(like):
    """The "collective" span: a device sync before (earlier work is not
    booked) and, through the yielded list of outputs, after."""
    timer = _ACTIVE.get()[1]
    if like.is_cuda:
        torch.cuda.synchronize(like.device)
    held: list = []
    if timer is None:
        yield held
        return
    with timer.phase("collective") as span:
        yield held
        span.sync(held)


def _count(nbytes: int) -> None:
    stats = _ACTIVE.get()[2]
    if stats is not None:
        stats.bytes_in += nbytes
        stats.calls += 1


def _gather(mesh, x):
    """(W, *x.shape): every rank's ``x`` in rank order, on x's device."""
    if mesh.backend == "nccl":
        out = x.new_empty((mesh.world,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    else:
        src = x.detach().cpu().contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(parts, src, group=mesh.group)
        out = torch.stack(parts).to(x.device)
    _count((mesh.world - 1) * x.numel() * x.element_size())
    return out


def gather_leading(tree):
    """The (C, ...) stack from every client shard's (C / client, ...)
    block, in cohort order (one replica a shard), leaf by leaf; 0-dim
    leaves pass through. The identity without a process group."""
    mesh = active_mesh()
    if mesh is None or mesh.group is None:
        return tree
    first = next(x for x in leaves(tree) if x.ndim)

    def one(x):
        if not x.ndim:
            return x
        out = _gather(mesh, x)
        if mesh.dsub > 1:
            out = out[::mesh.dsub]
        return out.reshape((-1,) + tuple(x.shape[1:]))

    with _collective(first) as held:
        out = tree_map(one, tree)
        held.append(leaves(out))
    return out


def shard_sum(mesh, x):
    """Sum of every client shard's (R, n) f32 ``x``, added in shard order
    (one replica a shard): rank j owns the j-th 1/W of the elements; an
    all-to-all brings it every rank's slice, it adds them in shard order,
    and an all-gather returns the sums. The same bits as gathering the W
    partials and adding them in that order, run after run."""
    W, (R, n) = mesh.world, x.shape
    m = -(-n // W)
    dev = x.device
    if mesh.backend == "gloo":
        x = x.cpu()
    send = F.pad(x, (0, m * W - n)).reshape(R, W, m).transpose(0, 1)
    send = send.contiguous()                                 # (W, R, m)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    _count((W - 1) * R * m * send.element_size())
    acc = recv[0].clone()
    for s in range(1, mesh.client):
        acc += recv[s * mesh.dsub]
    full = _gather(mesh, acc)                                # (W, R, m)
    return full.transpose(0, 1).reshape(R, W * m)[:, :n].to(dev)


def sum_shards(x):
    """``x`` (f32) summed across the client shards of the active mesh in
    shard order (``shard_sum``); the identity at client width 1."""
    mesh = active_mesh()
    if mesh is None or mesh.client == 1:
        return x
    with _collective(x) as held:
        total = shard_sum(mesh, x.reshape(1, -1) if x.ndim < 2
                          else x.reshape(x.shape[0], -1))
        held.append(total)
    return total.reshape(x.shape)


def reduce_leading(tree, weights):
    """Weighted sum over every leaf's LEADING (client) axis, in f32.

    weights (C,): leaf (C, ...) -> (...); weights (C, R): -> (R, ...),
    R simultaneous reductions (the async plane's on-time aggregate and
    its Q ring-buffer enqueue slots in one contraction). 0-dim leaves
    pass through. Under a mesh of client width > 1 the leaves hold the
    rank's cohort block: it contracts them against its rows of
    ``weights`` and the partials of every leaf are summed across the
    client shards in one ``shard_sum``; otherwise one plain contraction
    (a ``torch.tensordot``, outside any kernel of the port, as the JAX
    package leaves it to XLA).
    """
    w = weights.float()
    mesh = active_mesh()
    sharded = mesh is not None and mesh.client > 1
    if sharded:
        w = w[mesh.cohorts(w.shape[0])]

    def red(x):
        if x.ndim == 0:
            return x
        return torch.tensordot(w, x.float(), dims=([0], [0]))

    out = tree_map(red, tree)
    if not sharded:
        return out
    R = w.shape[1] if w.ndim == 2 else 1
    parts = leaves(out)
    idx = [i for i, x in enumerate(leaves(tree)) if x.ndim]
    total = sum_shards(torch.cat([parts[i].reshape(R, -1) for i in idx],
                                 dim=1))
    off = 0
    for i in idx:
        n = parts[i].numel() // R
        parts[i] = total[:, off:off + n].reshape(parts[i].shape)
        off += n
    return unflatten(out, parts)


def pre_reduced(fl, mesh) -> bool:
    """Whether the round pre-reduces the client axis: "force" always,
    "auto" when ``mesh`` splits it (client width > 1)."""
    return fl.client_reduce == "force" or (
        fl.client_reduce == "auto" and mesh is not None and mesh.client > 1)


def round_bytes(mesh, C: int, payload: int, n: int, R: int,
                reduced: bool) -> int:
    """Bytes one rank receives a round through the client-axis
    collectives, the per-cohort losses aside. Gathered: (W - 1) x C /
    client rows of ``payload`` bytes (one cohort's params, n elements).
    Pre-reduced over a split axis: ``shard_sum``'s all-to-all and
    all-gather of (R, n) f32 in W slices of ceil(n / W), 2 (W - 1) x R x
    4 ceil(n / W). 0 without a process group."""
    if mesh is None or mesh.group is None:
        return 0
    W = mesh.world
    if not reduced:
        return (W - 1) * (C // mesh.client) * payload
    if mesh.client == 1:
        return 0
    return 2 * (W - 1) * R * 4 * -(-n // W)
