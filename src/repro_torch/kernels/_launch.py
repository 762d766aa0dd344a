"""What every kernel wrapper of the port shares: operand checks, the
device dispatch (a CUDA tensor launches the kernel, a CPU tensor takes
the plain version, anything else is refused), the ctypes plumbing of a
launch (pointers, PyTorch's current stream, the error code), and the
folding of a vmapped dim into a kernel's batch axis."""
from __future__ import annotations

import ctypes

import torch

#: limit of the kernels' per-client tables in shared memory
MAX_K = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _check(name, x, shape, dtypes, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {x.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_device(prev):
    """True when the kernel runs (CUDA), False for the plain version
    (CPU); anything else is refused."""
    if prev.device.type == "cuda":
        return True
    if prev.device.type == "cpu":
        return False
    raise ValueError(f"kernel wrapper: unsupported device {prev.device}")


def _check_k(what: str, K: int) -> None:
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{what} kernel takes 1 <= K <= {MAX_K}, got K={K}")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


#: device -> int32 counters, zero between launches: a kernel that folds
#: partials in its last block to arrive counts the arrivals there and
#: resets each counter it used (serve_attention; it runs on the stream
#: that owns its data, so the launches never overlap)
_COUNTERS: dict = {}


def _counters(dev, n: int):
    """At least ``n`` zeroed int32 counters on ``dev``."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _fold(x, dim, size):
    """The vmapped dim of ``x`` (or a broadcast of an unbatched ``x``)
    folded into its leading B axis, contiguous."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(size, *x.shape)
    return x.reshape(size * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x, size):
    return x.reshape(size, x.shape[0] // size, *x.shape[1:])
