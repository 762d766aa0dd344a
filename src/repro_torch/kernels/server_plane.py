"""Fused server-plane kernels: the whole server update in one HBM pass.

Replaces the JAX package's ``kernels/server_plane.py: server_mix_flat,
server_async_flat, server_adam_flat, server_mix_delta_flat`` and
``server_mix_scatter_flat`` (Pallas). Each round's server update is ONE
wrapper call per dtype group:

  * ``server_mix_flat``    — sync plane (ama / fedavg / fedprox):
        streams K+1 rows in, 1 out; participation weights and the alpha
        schedule are computed in-kernel from the device arrays.
  * ``server_async_flat``  — async plane (async_ama, Eqs. 6-11): streams
        K+Q+1 rows in, Q+1 out; gamma^-(delays), ring-buffer enqueue,
        slot pop and the alpha/beta/gamma mix fused.
  * ``server_adam_flat``   — FedOpt server-Adam: streams K+3 rows in, 3
        out; pseudo-gradient, moments, bias correction and the step.
  * ``server_mix_delta_flat`` — the sync mix over compressed deltas
        (int8 / bf16 rows, de-quantized in-kernel): streams the
        compressed bytes, not a dense f32 copy.
  * ``server_mix_scatter_flat`` — the sync mix over top-k (value,
        position) pairs: one cooperative launch whose grid runs a dense
        phase, then one conflict-free scatter phase per client, in
        client order behind grid barriers; deterministic and
        atomic-free.

All are bound by HBM bytes on the H100: per element the mix reads K+1
values and writes one, ``(K+2)·N·s`` bytes for element size s; the
async plane moves ``(K+2)·N·s + 2·Q·N·4`` bytes (the f32 ring buffer is
read and written). Their arithmetic is a handful of flops per byte, far
below the card's ridge point. The design is simple: a grid-stride loop,
f32 accumulation, no atomics (each output element is written by one
thread, so a launch is deterministic). ``server_mix``,
``server_async``, ``server_adam`` and ``server_mix_delta`` each have two
kernels with one op order, picked by the operands' layout: whole 16-byte
words where N is a multiple of the vector and every operand starts on a
16-byte boundary (for the async plane also K <= 8; for
``server_mix_delta`` the vector is 16 bytes of the narrower of prev and
the rows, 16 elements under int8 rows), a thread's first words loaded
before the block's prologue; one element a thread otherwise (several of
its grid-stride elements at once in ``server_adam`` and
``server_mix_delta``). ``server_mix_designs()``,
``server_async_designs()``, ``server_adam_designs()`` and
``server_mix_delta_designs()`` read the launches of each. The async
vector kernel holds a thread's K client values in registers and walks
the ring slots over them, so every byte of the function moves once; its
per-element kernel re-reads each client row once a slot (from L1/L2).
``server_mix_scatter`` is one cooperative launch.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
version (``kernels/ref.py``); CUDA tensors take the kernel, or the
wrapper raises. The tree-level functions choose the kernel (``impl="fused"``)
or the plain version (``impl="ref"``), which is the only way the plain
version runs on the card.

Each wrapper counts its calls that launch its kernel
(``server_mix_flat.launches``, ...); ``plain_runs_on_cuda`` counts the
tree-level functions' runs of the plain version on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (MAX_K, _DTYPE_CODE, _check,
                                         _check_k, _kernel_device, _ptr,
                                         _raise_on, _stream)
from repro_torch.kernels.ama_mix import ama_mix_flat, ama_mix_leaves
from repro_torch.utils import tree

__all__ = ["server_mix_flat", "server_async_flat", "server_adam_flat",
           "server_mix_delta_flat", "server_mix_scatter_flat",
           "server_mix_tree", "server_async_tree", "server_adam_tree",
           "server_mix_compressed_tree", "mix_coefs", "device_vector",
           "reset_counts", "plain_runs_on_cuda", "KERNELS", "MAX_K",
           "MAX_Q", "MIX_DESIGNS", "server_mix_designs",
           "server_async_designs", "server_adam_designs",
           "server_mix_delta_designs"]

#: limit of the async kernel's ring (its shared-memory prologue table)
MAX_Q = 32

#: delta row dtypes of server_mix_delta
_ROWS_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: runs of the plain version on CUDA tensors through the tree-level
#: functions; "ama_mix" counts the legacy chain's plain mix on CUDA
#: leaves (``core/ama.py``: the chain without ``use_kernel``)
plain_runs_on_cuda = {"server_mix": 0, "server_async": 0, "server_adam": 0,
                      "server_mix_delta": 0, "server_mix_scatter": 0,
                      "ama_mix": 0}


def reset_counts() -> None:
    """Zero every launch and plain-run counter of this module (and
    ``ama_mix_flat``'s count of its one-leaf calls)."""
    for fn in (*KERNELS.values(), ama_mix_flat):
        fn.launches = 0
    for k in plain_runs_on_cuda:
        plain_runs_on_cuda[k] = 0


def device_vector(values, device):
    """A small f32 vector on ``device`` made by in-place fills: a copy
    from host memory would synchronize the stream inside a round."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i] = v
    return out


def mix_coefs(fl, t, *, adaptive: bool = True):
    """(4,) f32 = [alpha0, eta, alpha_cap, t] on ``t``'s device.
    ``adaptive=False`` zeroes the schedule (fedavg: alpha == 0)."""
    head = (fl.alpha0, fl.eta, fl.alpha_cap) if adaptive else (0.0,) * 3
    out = device_vector(head + (0.0,), t.device)
    out[3] = t
    return out


def server_mix_flat(prev, stacked, sizes, keep, coefs):
    """prev: (N,) f32/bf16; stacked: (K, N) in prev's dtype; sizes/keep:
    (K,) f32; coefs: (4,) f32. Returns out (N,) in prev's dtype."""
    (N,) = prev.shape
    K = stacked.shape[0]
    dev = prev.device
    _check("prev", prev, (N,), tuple(_DTYPE_CODE), dev)
    _check("stacked", stacked, (K, N), (prev.dtype,), dev)
    for name, x, n in (("sizes", sizes, K), ("keep", keep, K),
                       ("coefs", coefs, 4)):
        _check(name, x, (n,), (torch.float32,), dev)
    if not _kernel_device(prev):
        return ref.server_mix_math(prev, stacked, sizes, keep, coefs)
    _check_k("server_mix", K)
    lib = build.load()
    out = torch.empty_like(prev)
    err = lib.server_mix(
        _DTYPE_CODE[prev.dtype], _ptr(prev), _ptr(stacked), _ptr(sizes),
        _ptr(keep), _ptr(coefs), _ptr(out), K, N, _stream(dev))
    _raise_on(err, "server_mix")
    server_mix_flat.launches += 1
    return out


#: the two kernels of server_mix, server_async, server_adam and
#: server_mix_delta, in the order of the C entries' counts
MIX_DESIGNS = ("per_element", "vector")


def _designs(entry: str) -> dict:
    counts = (ctypes.c_longlong * len(MIX_DESIGNS))()
    getattr(build.load(), entry)(counts)
    return dict(zip(MIX_DESIGNS, counts))


def server_mix_designs() -> dict:
    """{"per_element": n, "vector": m}: the launches of each of
    server_mix's kernels so far in this process. Needs the built library
    (the card)."""
    return _designs("server_mix_design_counts")


def server_async_designs() -> dict:
    """The same for server_async's two kernels."""
    return _designs("server_async_design_counts")


def server_adam_designs() -> dict:
    """The same for server_adam's two kernels."""
    return _designs("server_adam_design_counts")


def server_mix_delta_designs() -> dict:
    """The same for server_mix_delta's two kernels."""
    return _designs("server_mix_delta_design_counts")


def server_async_flat(prev, stacked, qsum, qgamma, sizes, delayed, delays,
                      tq, hyp):
    """prev: (N,) f32/bf16; stacked: (K, N) in prev's dtype; qsum: (Q, N)
    f32; qgamma: (Q,) f32; sizes/delayed: (K,) f32; delays: (K,) int32;
    tq: (2,) int32 = [t, t % Q]; hyp: (4,) f32 = [alpha0, eta,
    alpha_cap, staleness_b]. Returns (out (N,), new_qsum (Q, N) f32,
    new_qgamma (Q,) f32)."""
    (N,) = prev.shape
    K, Q = stacked.shape[0], qgamma.shape[0]
    dev = prev.device
    _check("prev", prev, (N,), tuple(_DTYPE_CODE), dev)
    _check("stacked", stacked, (K, N), (prev.dtype,), dev)
    _check("qsum", qsum, (Q, N), (torch.float32,), dev)
    for name, x, n in (("qgamma", qgamma, Q), ("sizes", sizes, K),
                       ("delayed", delayed, K), ("hyp", hyp, 4)):
        _check(name, x, (n,), (torch.float32,), dev)
    _check("delays", delays, (K,), (torch.int32,), dev)
    _check("tq", tq, (2,), (torch.int32,), dev)
    if not _kernel_device(prev):
        return ref.server_async_math(prev, stacked, qsum, qgamma, sizes,
                                     delayed, delays, tq, hyp)
    if not (1 <= K <= MAX_K and 1 <= Q <= MAX_Q):
        raise ValueError(f"server_async kernel takes 1 <= K <= {MAX_K} "
                         f"and 1 <= Q <= {MAX_Q}, got K={K}, Q={Q}")
    lib = build.load()
    out = torch.empty_like(prev)
    new_qsum = torch.empty_like(qsum)
    new_qgamma = torch.empty_like(qgamma)
    err = lib.server_async(
        _DTYPE_CODE[prev.dtype], _ptr(prev), _ptr(stacked), _ptr(qsum),
        _ptr(qgamma), _ptr(sizes), _ptr(delayed), _ptr(delays), _ptr(tq),
        _ptr(hyp), _ptr(out), _ptr(new_qsum), _ptr(new_qgamma), K, Q, N,
        _stream(dev))
    _raise_on(err, "server_async")
    server_async_flat.launches += 1
    return out, new_qsum, new_qgamma


def server_adam_flat(prev, stacked, m, v, sizes, keep, scalars):
    """prev: (N,) f32/bf16; stacked: (K, N) in prev's dtype; m/v: (N,)
    f32; sizes/keep: (K,) f32; scalars: (5,) f32 = [b1, b2, lr, tau,
    step] (step already incremented). Returns (out (N,) in prev's dtype,
    new_m (N,) f32, new_v (N,) f32)."""
    (N,) = prev.shape
    K = stacked.shape[0]
    dev = prev.device
    _check("prev", prev, (N,), tuple(_DTYPE_CODE), dev)
    _check("stacked", stacked, (K, N), (prev.dtype,), dev)
    for name, x in (("m", m), ("v", v)):
        _check(name, x, (N,), (torch.float32,), dev)
    for name, x, n in (("sizes", sizes, K), ("keep", keep, K),
                       ("scalars", scalars, 5)):
        _check(name, x, (n,), (torch.float32,), dev)
    if not _kernel_device(prev):
        return ref.server_adam_math(prev, stacked, m, v, sizes, keep,
                                    scalars)
    _check_k("server_adam", K)
    lib = build.load()
    out = torch.empty_like(prev)
    new_m, new_v = torch.empty_like(m), torch.empty_like(v)
    err = lib.server_adam(
        _DTYPE_CODE[prev.dtype], _ptr(prev), _ptr(stacked), _ptr(m), _ptr(v),
        _ptr(sizes), _ptr(keep), _ptr(scalars), _ptr(out), _ptr(new_m),
        _ptr(new_v), K, N, _stream(dev))
    _raise_on(err, "server_adam")
    server_adam_flat.launches += 1
    return out, new_m, new_v


def server_mix_delta_flat(prev, dstacked, rowscale, sizes, keep, coefs):
    """prev: (N,) f32/bf16; dstacked: (K, N) int8/bf16/f32 quantized
    deltas; rowscale/sizes/keep: (K,) f32; coefs: (4,) f32. Returns out
    (N,) in prev's dtype."""
    (N,) = prev.shape
    K = dstacked.shape[0]
    dev = prev.device
    _check("prev", prev, (N,), tuple(_DTYPE_CODE), dev)
    _check("dstacked", dstacked, (K, N), tuple(_ROWS_CODE), dev)
    for name, x, n in (("rowscale", rowscale, K), ("sizes", sizes, K),
                       ("keep", keep, K), ("coefs", coefs, 4)):
        _check(name, x, (n,), (torch.float32,), dev)
    if not _kernel_device(prev):
        return ref.server_mix_delta_math(prev, dstacked, rowscale, sizes,
                                         keep, coefs)
    _check_k("server_mix_delta", K)
    lib = build.load()
    out = torch.empty_like(prev)
    err = lib.server_mix_delta(
        _DTYPE_CODE[prev.dtype], _ROWS_CODE[dstacked.dtype], _ptr(prev),
        _ptr(dstacked), _ptr(rowscale), _ptr(sizes), _ptr(keep), _ptr(coefs),
        _ptr(out), K, N, _stream(dev))
    _raise_on(err, "server_mix_delta")
    server_mix_delta_flat.launches += 1
    return out


def server_mix_scatter_flat(prev, vals, idx, sizes, keep, coefs):
    """prev: (N,) f32/bf16; vals: (K, kk) f32; idx: (K, kk) int32 flat
    positions, distinct within a row; sizes/keep: (K,) f32; coefs: (4,)
    f32. Returns out (N,) in prev's dtype. One call is one cooperative
    kernel launch (its K + 1 phases, K + 2 for bf16 prev, separated by
    grid barriers) and counts once."""
    (N,) = prev.shape
    K, kk = vals.shape
    dev = prev.device
    _check("prev", prev, (N,), tuple(_DTYPE_CODE), dev)
    _check("vals", vals, (K, kk), (torch.float32,), dev)
    _check("idx", idx, (K, kk), (torch.int32,), dev)
    for name, x, n in (("sizes", sizes, K), ("keep", keep, K),
                       ("coefs", coefs, 4)):
        _check(name, x, (n,), (torch.float32,), dev)
    if not _kernel_device(prev):
        return ref.server_mix_scatter_math(prev, vals, idx, sizes, keep,
                                           coefs)
    _check_k("server_mix_scatter", K)
    lib = build.load()
    out = torch.empty_like(prev)
    acc = out if prev.dtype == torch.float32 else torch.empty(
        N, dtype=torch.float32, device=dev)
    err = lib.server_mix_scatter(
        _DTYPE_CODE[prev.dtype], _ptr(prev), _ptr(vals), _ptr(idx),
        _ptr(sizes), _ptr(keep), _ptr(coefs), _ptr(out), _ptr(acc), K, kk,
        N, _stream(dev))
    _raise_on(err, "server_mix_scatter")
    server_mix_scatter_flat.launches += 1
    return out


#: kernel name -> its flat wrapper (each carries a ``launches`` count)
KERNELS = {"server_mix": server_mix_flat, "server_async": server_async_flat,
           "server_adam": server_adam_flat,
           "server_mix_delta": server_mix_delta_flat,
           "server_mix_scatter": server_mix_scatter_flat,
           "ama_mix": ama_mix_leaves}
for _fn in KERNELS.values():
    _fn.launches = 0


# ---------------------------------------------------------------------------
# tree level: whole param tree -> one flat vector per dtype group ->
# one kernel launch per round per group
# ---------------------------------------------------------------------------

def _flat_fn(impl: str, kernel, plain, key: str):
    if impl == "fused":
        return kernel
    if impl != "ref":
        raise ValueError(f"unknown server-plane impl {impl!r}; expected "
                         "'fused' or 'ref'")

    def run_plain(prev, *args):
        if prev.is_cuda:
            plain_runs_on_cuda[key] += 1
        return plain(prev, *args)
    return run_plain


def server_mix_tree(prev, stacked, sizes, keep, coefs, *, impl="fused"):
    """Sync server plane over param trees; ``stacked`` leaves carry a
    leading client axis. The per-round concat/split copies of the flat
    group vectors are kept for now; keeping params flat-resident would
    remove them."""
    fn = _flat_fn(impl, server_mix_flat, ref.server_mix_math, "server_mix")
    leaves_p, leaves_s = tree.leaves(prev), tree.leaves(stacked)
    out = [None] * len(leaves_p)
    for idxs in tree.dtype_groups(leaves_p).values():
        K = leaves_s[idxs[0]].shape[0]
        fp = tree.cat([leaves_p[i].reshape(-1) for i in idxs])
        fs = tree.cat([leaves_s[i].reshape(K, -1) for i in idxs])
        tree.split_back(fn(fp, fs, sizes, keep, coefs), leaves_p, idxs, out)
    return tree.unflatten(prev, out)


def server_async_tree(prev, stacked, queue, sizes, delayed, delays, t, hyp,
                      *, impl="fused"):
    """Async server plane over param trees: one fused enqueue+pop+mix per
    round per dtype group. ``queue`` = {"sum": tree with leading (Q,),
    "gamma": (Q,)}. Returns (new_global, new_queue)."""
    fn = _flat_fn(impl, server_async_flat, ref.server_async_math,
                  "server_async")
    qgamma = queue["gamma"]
    Q = qgamma.shape[0]
    tq = torch.stack([t, torch.remainder(t, Q)]).to(torch.int32)
    leaves_p, leaves_s = tree.leaves(prev), tree.leaves(stacked)
    leaves_q = tree.leaves(queue["sum"])
    out = [None] * len(leaves_p)
    qs = [None] * len(leaves_p)
    new_qgamma = qgamma
    for idxs in tree.dtype_groups(leaves_p).values():
        K = leaves_s[idxs[0]].shape[0]
        fp = tree.cat([leaves_p[i].reshape(-1) for i in idxs])
        fs = tree.cat([leaves_s[i].reshape(K, -1) for i in idxs])
        fq = tree.cat([leaves_q[i].reshape(Q, -1) for i in idxs])
        of, oq, new_qgamma = fn(fp, fs, fq, qgamma, sizes, delayed, delays,
                                tq, hyp)
        tree.split_back(of, leaves_p, idxs, out)
        tree.split_back(oq, leaves_q, idxs, qs)
    return (tree.unflatten(prev, out),
            {"sum": tree.unflatten(prev, qs), "gamma": new_qgamma})


def server_adam_tree(prev, stacked, m, v, sizes, keep, scalars, *,
                     impl="fused"):
    """FedOpt server plane over param trees. ``m``/``v`` are f32 trees
    shaped like ``prev``. Returns (new_global, new_m, new_v)."""
    fn = _flat_fn(impl, server_adam_flat, ref.server_adam_math,
                  "server_adam")
    leaves_p, leaves_s = tree.leaves(prev), tree.leaves(stacked)
    leaves_m, leaves_v = tree.leaves(m), tree.leaves(v)
    outs = ([None] * len(leaves_p), [None] * len(leaves_p),
            [None] * len(leaves_p))
    for idxs in tree.dtype_groups(leaves_p).values():
        K = leaves_s[idxs[0]].shape[0]
        flat = fn(tree.cat([leaves_p[i].reshape(-1) for i in idxs]),
                  tree.cat([leaves_s[i].reshape(K, -1) for i in idxs]),
                  tree.cat([leaves_m[i].reshape(-1) for i in idxs]),
                  tree.cat([leaves_v[i].reshape(-1) for i in idxs]),
                  sizes, keep, scalars)
        for f, like, o in zip(flat, (leaves_p, leaves_m, leaves_v), outs):
            tree.split_back(f, like, idxs, o)
    return tuple(tree.unflatten(prev, o) for o in outs)


def server_mix_compressed_tree(prev, groups, sizes, keep, coefs, *,
                               impl="fused"):
    """The sync server plane consuming a comm plane's compressed payload
    (``repro_torch.comm``): ``groups`` is ``[(leaf_idxs, payload)]``, one
    entry per dtype group of ``prev``, with payload ``{"kind": "delta",
    "d": (K, N) int8|bf16, "scale": (K,) f32}`` or ``{"kind": "topk",
    "v": (K, kk) f32, "i": (K, kk) int32}``. One call per round per
    group, with no dense intermediate."""
    delta = _flat_fn(impl, server_mix_delta_flat, ref.server_mix_delta_math,
                     "server_mix_delta")
    scatter = _flat_fn(impl, server_mix_scatter_flat,
                       ref.server_mix_scatter_math, "server_mix_scatter")
    leaves_p = tree.leaves(prev)
    out = [None] * len(leaves_p)
    for idxs, payload in groups:
        fp = tree.cat([leaves_p[i].reshape(-1) for i in idxs])
        if payload["kind"] == "delta":
            of = delta(fp, payload["d"], payload["scale"], sizes, keep, coefs)
        elif payload["kind"] == "topk":
            of = scatter(fp, payload["v"], payload["i"], sizes, keep, coefs)
        else:
            raise ValueError(f"unknown payload kind {payload['kind']!r}")
        tree.split_back(of, leaves_p, idxs, out)
    return tree.unflatten(prev, out)
