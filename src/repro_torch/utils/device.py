"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU
(``device="cpu"``, ``--device cpu``). Asking for CUDA on a machine
without a CUDA device is an error, never a silent move to the CPU.
Under ``torchrun`` (``LOCAL_RANK`` set) "cuda" is the rank's card,
``cuda:{LOCAL_RANK % device_count}``: ranks beyond the card count share
cards (``launch.mesh.engine_mesh`` then picks gloo over NCCL).
"""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises when there is
    none), the rank's card when ``LOCAL_RANK`` is set; "cpu" -> the CPU.
    Also fixes the numerics flags below."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected "
                         "'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    # The JAX reference computes in full f32. cuDNN convolutions default
    # to TF32 (about 10 mantissa bits), which would change the conv
    # numerics; matmuls are kept at full f32 for the same reason.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Deterministic conv algorithms: chunked == per-round execution is
    # held bitwise, which needs run-to-run identical gradients.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev
