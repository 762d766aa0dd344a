"""The provenance block of every metrics JSONL header.

The port's counterpart of the JAX package's ``obs/provenance.py``: the
same role (say WHAT produced an artifact, so two runs can be compared
with their differences named), with torch, its CUDA build and the card
in place of the jax version and backend.
"""
from __future__ import annotations

import os
import platform
import subprocess
import time

import torch

#: provenance keys whose mismatch between two runs is worth flagging
COMPARE_KEYS = ("torch_version", "cuda_version", "backend", "device_name",
                "device_count", "git_sha", "python")


def git_sha(cwd: str | None = None) -> str:
    """Short HEAD sha of the repository holding this file ("" when it
    is not a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def provenance(mesh=None) -> dict:
    """Environment fingerprint of the producing process. ``backend`` is
    "cuda" when a CUDA device is visible (the port's default device),
    else "cpu"; ``device_name`` is the card's name or null. ``mesh`` (a
    ``launch.mesh.FLMesh``) adds the world size, the client width and
    the collectives' backend ("none" without a process group)."""
    cuda = torch.cuda.is_available()
    mesh_keys = {} if mesh is None else {
        "world_size": mesh.world, "client_width": mesh.client,
        "dist_backend": mesh.backend}
    return {
        **mesh_keys,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "host": platform.node(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "git_sha": git_sha(),
        "generated_unix": round(time.time(), 3),
    }


def diff(a: dict | None, b: dict | None) -> list[str]:
    """Human-readable provenance mismatches between two artifacts
    ("torch_version: 2.10.0 -> 2.11.0"); [] when identical or either
    side has no provenance."""
    if not a or not b:
        return []
    return [f"{k}: {a[k]} -> {b[k]}"
            for k in COMPARE_KEYS
            if k in a and k in b and a[k] != b[k]]
