"""The serving projections on a row-invariant hand-written GEMM.

``invariant_dense(x, w, b=None)`` computes ``x @ w (+ b)`` with x
(..., K), w (K, N) in the JAX layout (``d_in, d_out``), b (N,) or None,
returning (..., N) in x's dtype. ``invariant_dense_group(x, [(w, b),
...])`` computes up to MAX_GROUP such projections of the same x in one
launch (wq|wk|wv, w_in|w_gate) and returns their outputs in order; each
equals that problem's single call bit for bit (each keeps its own tiles,
split, partials and fold). It replaces no Pallas kernel: it is the XLA
dot of the JAX package's ``models/layers.py: dense`` (:22) on the serving
path. On the card every output element is summed over K in an order
fixed by (K, N) alone, whatever the number of rows M
(``csrc/invariant_dense.cu``: bf16 on the tensor cores, f32 on the CUDA
cores, a warp a column summing K in 32 strided lanes and a fixed fold): a row of a 256-row prefill chunk equals
that row of a 4-row decode step bit for bit, which ``torch.matmul``
(cuBLAS picks its tiling and split of K by M) does not give. M picks only
the kernel's form (``form``: how many 64-row tiles a block carries).

The bf16 kernel reads the weight's rows 16 bytes at a time (by TMA), so
N must be a multiple of 8 there: a head whose N is not (whisper's
lm_head, 1024 x 51,865) is carried in a copy padded once with zero
columns when serving starts (``pad_columns``; the caller drops the
extra outputs), never padded per call.

Only the serving steps call it: the attention's wq|wk|wv as one group
and wo, the MLP's w_in|w_gate as one group and w_out, and ``lm_head``: 4
launches a layer and 1 a step; a moe block (``models/moe.py:
moe_serve``) the f32 router, each two experts' w_in|w_gate and each
expert's w_out in place of the MLP; an encoder-decoder block
(``models/encdec.py``) also the cross-attention's wq and wo, and a
plain MLP's w_in alone: 6 a layer. Training keeps ``layers.dense``.

Dispatch is by device: a CPU tensor takes the plain version
(``ref.invariant_dense_ref``: ``x @ w + b``, the bits of
``layers.dense``), once per problem; a CUDA tensor launches the kernel,
or the wrapper raises. The wrapper counts its launches
(``invariant_dense.launches``; a group is one).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels._launch import (_DTYPE_CODE, _check,
                                         _kernel_device, _ptr, _raise_on,
                                         _stream)

__all__ = ["invariant_dense", "invariant_dense_group", "split_k", "form",
           "pad_columns", "KERNELS", "reset_counts"]

#: the bf16 kernel's n tile (the wgmma n width) and its K step
#: (csrc/invariant_dense.cu)
TILE_N, BK = 128, 64
#: split K until the n tiles give this many blocks (half the SMs: a
#: split's f32 partials cross between SMs in the fold, and at a prefill
#: chunk more of them cost more than the SMs they fill) ...
SPLIT_BLOCKS = 64
#: ... or a range would fall below this many k, or the split pass this
#: (a tile's ranges fold in one cluster of blocks, at most 8)
SPLIT_MIN_K = 512
SPLIT_MAX = 8
#: M up to this takes the decode form (one 64-row tile a block)
DECODE_ROWS = 64
#: rows of a block tile in each form (decode, prefill 1, prefill 2)
FORM_ROWS = (64, 128, 256)
#: projections one launch takes (csrc/invariant_dense.cu: kMaxProblems)
MAX_GROUP = 4


@functools.cache
def split_k(K: int, N: int) -> int:
    """The number of K ranges of the bf16 kernel: a function of (K, N)
    alone, never of M. Doubles while the n tiles give fewer than
    SPLIT_BLOCKS blocks, the ranges stay multiples of the K step and at
    least SPLIT_MIN_K long, up to SPLIT_MAX."""
    n_tiles = -(-N // TILE_N)
    s = 1
    while (n_tiles * s < SPLIT_BLOCKS and s < SPLIT_MAX
           and K % (2 * s * BK) == 0 and K // (2 * s) >= SPLIT_MIN_K):
        s *= 2
    return s


def form(M: int, K: int, Ns, sms: int) -> int:
    """The bf16 kernel's form for M rows of the problems (K, N) in Ns on a
    card of ``sms`` SMs: 0 (decode) up to DECODE_ROWS rows; else 2 (256
    rows a block: the least traffic from L2) where no problem splits K
    and its blocks fill 7/8 of the SMs, 1 (128 rows) otherwise (a split's
    fold and clusters cost less in smaller tiles). It never changes a bit
    of the result, only how many 64-row tiles a block carries."""
    if M <= DECODE_ROWS:
        return 0
    if any(split_k(K, N) > 1 for N in Ns):
        return 1
    blocks = sum(-(-M // FORM_ROWS[2]) * -(-N // TILE_N) for N in Ns)
    return 2 if 8 * blocks >= 7 * sms else 1


@functools.lru_cache(maxsize=4096)
def _plan(M: int, K: int, Ns: tuple, bf16: bool, sms: int):
    """(form, splits) of one launch."""
    if not bf16:
        return 0, (1,) * len(Ns)
    return form(M, K, Ns, sms), tuple(split_k(K, N) for N in Ns)


@functools.cache
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _dense(x, problems):
    """Every projection of ``problems`` ((w, b) pairs) of x, in order."""
    if not 1 <= len(problems) <= MAX_GROUP:
        raise ValueError(f"invariant_dense takes 1 to {MAX_GROUP} "
                         f"projections a launch, got {len(problems)}")
    dev = x.device
    _check("x", x, tuple(x.shape), tuple(_DTYPE_CODE), dev)
    K = x.shape[-1] if x.dim() else 0
    for w, b in problems:
        N = w.shape[1] if w.dim() == 2 else -1
        _check("w", w, (K, N), (x.dtype,), dev)
        if b is not None:
            _check("b", b, (N,), (x.dtype,), dev)
    if not _kernel_device(x):
        return [ref.invariant_dense_ref(x, w, b) for w, b in problems]
    lead = tuple(x.shape[:-1])
    M = x.numel() // K if K else 0
    Ns = tuple(w.shape[1] for w, _ in problems)
    if K < 1 or M < 1 or min(Ns) < 1:
        raise ValueError(f"invariant_dense takes non-empty operands: x "
                         f"{tuple(x.shape)}, w (K, N) {Ns}")
    if K % 8 or (x.dtype == torch.bfloat16 and any(N % 8 for N in Ns)):
        raise ValueError(f"invariant_dense reads 16-byte rows: K ({K}) and, "
                         f"in bf16, N {Ns} must be multiples of 8")
    if x.data_ptr() % 16 or any(
            t is not None and t.data_ptr() % 16 for p in problems for t in p):
        raise ValueError("invariant_dense: x, w and b must start on a "
                         "16-byte boundary")
    fm, splits = _plan(M, K, Ns, x.dtype == torch.bfloat16, _sms(dev))
    y = torch.empty(M * sum(Ns), dtype=x.dtype, device=dev)
    ys = [t.view(*lead, N) for t, N in zip(y.split([M * N for N in Ns]),
                                           Ns)]
    table = (ctypes.c_longlong * (5 * len(problems)))()
    for i, ((w, b), out, N, S) in enumerate(zip(problems, ys, Ns, splits)):
        table[5 * i:5 * i + 5] = (w.data_ptr(), 0 if b is None else
                                  b.data_ptr(), out.data_ptr(), N, S)
    err = build.load().invariant_dense(
        _DTYPE_CODE[x.dtype], _ptr(x), M, K, len(problems), table, fm,
        _stream(dev))
    _raise_on(err, "invariant_dense")
    invariant_dense.launches += 1
    return ys


def invariant_dense(x, w, b=None):
    """x (..., K) @ w (K, N) (+ b (N,)), in x's dtype; see the module
    docstring."""
    return _dense(x, ((w, b),))[0]


def invariant_dense_group(x, problems):
    """[x @ w (+ b) for (w, b) in problems], up to MAX_GROUP projections
    of the same x (their K and dtype x's) in one launch; see the module
    docstring."""
    return _dense(x, tuple(problems))


def pad_columns(w, b=None, multiple: int = 8):
    """(w, b) with N padded by zero columns (and zero bias) to a
    multiple of ``multiple``; the same tensors when N already is one.
    The first N outputs are the unpadded problem's (each summed over K in
    an order fixed by K and the padded N, whatever M); the extra ones are
    0 (or the zero bias), for the caller to drop."""
    N = w.shape[-1]
    pad = -N % multiple
    if pad == 0:
        return w, b
    wp = torch.nn.functional.pad(w, (0, pad)).contiguous()
    return wp, None if b is None else torch.nn.functional.pad(b, (0, pad))


#: kernel name -> its wrapper (each carries a ``launches`` count; a group
#: counts on ``invariant_dense``)
KERNELS = {"invariant_dense": invariant_dense}
invariant_dense.launches = 0


def reset_counts() -> None:
    """Zero the launch count of the row-invariant GEMM."""
    invariant_dense.launches = 0
