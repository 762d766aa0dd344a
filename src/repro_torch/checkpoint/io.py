"""Checkpointing: flat-key npz save/restore of tensor trees and of the
engine's full round state ``{params, t, aux}``.

The port's copy of the JAX package's ``checkpoint/io.py``, in the same
layout: one npz member per leaf under its ``/``-joined path, bf16
leaves stored as f32 (lossless), the round index as a 0-dim int32. A
checkpoint one package writes therefore restores in the other. Writes
are atomic (a private temp file, then a rename), so a checkpoint taken
mid-run is never half-written. ``save_state``/``restore_state`` round
trip the whole round carry (global params, ``t``, and the aux state:
async-AMA ring buffer, fedopt moments and step, comm residuals) bit for
bit, which is what makes ``--resume`` continue exactly. Under a mesh
(``launch.mesh.FLMesh``) the round state is replicated on every rank:
``save_state`` writes it on rank 0 and every rank waits at a barrier
for the file, and every rank reads ``--resume``, so a checkpoint taken
at one world size resumes at any other.
"""
from __future__ import annotations

import os
import uuid

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:     # numpy has no bf16: store as f32
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                # '/' is the flat-key separator: {"a/b": x} and
                # {"a": {"b": y}} would land on the same key
                raise ValueError(
                    f"checkpoint dict key {k!r} contains '/': flat npz "
                    "keys are '/'-joined paths, so it could collide with "
                    "another leaf; rename the key")
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _with_npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _tmp_path(final: str) -> str:
    """A temp name unique to this writer (.npz suffix, so savez keeps
    it), so two writers of one path never clobber each other."""
    return f"{final}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp.npz"


def save(path: str, tree) -> None:
    final = _with_npz(path)
    os.makedirs(os.path.dirname(os.path.abspath(final)), exist_ok=True)
    flat = _flatten(tree)              # validate keys before touching disk
    tmp = _tmp_path(final)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def restore(path: str, like, prefix: str = ""):
    """Restore into the structure of ``like``: each tensor leaf takes the
    dtype and device of ``like``'s leaf. Only the members ``like`` asks
    for are read."""
    with np.load(_with_npz(path)) as zf:

        def rebuild(tree, pfx):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{pfx}{k}/") for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(rebuild(v, f"{pfx}{i}/")
                                  for i, v in enumerate(tree))
            leaf = torch.from_numpy(np.array(zf[pfx[:-1]], copy=True))
            if isinstance(tree, torch.Tensor):
                return leaf.to(device=tree.device, dtype=tree.dtype)
            return leaf

        return rebuild(like, prefix)


def restore_params(path: str, like_params):
    """Restore a params tree from either a bare params checkpoint or a
    full round-state file written by ``save_state`` (``params/``-prefixed
    keys plus ``t`` and ``aux``), slicing out the params subtree: the
    serving launcher's ``--checkpoint`` takes both, so a model trained by
    either package's ``--checkpoint`` serves as it is."""
    with np.load(_with_npz(path)) as zf:
        keys = set(zf.files)
    if "t" in keys and any(k.startswith("params/") for k in keys):
        return restore(path, like_params, prefix="params/")
    return restore(path, like_params)


def save_state(path: str, state: dict, mesh=None) -> None:
    """Checkpoint a full round state ``{params, t, aux}``; under ``mesh``
    rank 0 writes it and every rank returns once it is written."""
    missing = {"params", "t"} - set(state)
    if missing:
        raise ValueError(f"round state missing keys: {sorted(missing)}")
    if mesh is None or mesh.writer:
        save(path, state)
    if mesh is not None:
        mesh.barrier()


def restore_state(path: str, like_state: dict) -> dict:
    """Restore a full round state into the structure of ``like_state``
    (``core.round.init_state`` builds the template)."""
    with np.load(_with_npz(path)) as zf:
        keys = set(zf.files)
    if "t" not in keys or not any(k.startswith("params/") for k in keys):
        raise ValueError(
            f"{path} is not a full round-state checkpoint ({{params, t, "
            "aux}}); save one with save_state / --checkpoint")
    return restore(path, like_state)
