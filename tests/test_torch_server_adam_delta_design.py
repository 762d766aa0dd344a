"""The designs of server_adam and server_mix_delta, held on the CPU.

Each has a 16-byte kernel (``csrc/server_adam.cu: server_adam_vec_kernel``,
``csrc/server_mix_compressed.cu: server_mix_delta_vec_kernel``): a thread
owns E elements, 16 bytes of the narrower operand, loads its words and
those of up to ``kVecRows`` client rows before it combines them, and the
block forms the round's scalars in parallel, with only the sums the
plain version takes in order (tot, sum_k w_k) in one thread. The plain
mirrors below follow that order on plain tensors: words of E elements,
the rows in batches, each 32-bit word widened lane by lane as
``Vec16<T>::unpack`` does (int8 lanes sign-extended by shifts), and hold
it bit for bit against ``server_adam_math`` / ``server_mix_delta_math``.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import server_plane as tsp

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
CSRC = Path(tsp.__file__).parent / "csrc"
#: client rows a thread of the 16-byte kernels loads before combining
VEC_ROWS = int(re.search(r"constexpr int kVecRows = (\d+);",
                         (CSRC / "common.cuh").read_text()).group(1))


def _bits(x):
    """x's bits as integers: equality of these is bit-for-bit equality
    (-0.0 differs from +0.0, a NaN equals the same NaN)."""
    return x.view(torch.int32 if x.dtype == F32 else torch.int16)


def _unit(*dtypes):
    """E: elements in 16 bytes of the narrowest dtype."""
    return 16 // min(torch.empty(0, dtype=d).element_size() for d in dtypes)


def _unpack(x, E):
    """(n,) -> (n // E, E) f32 from the 32-bit words of x, lane by lane
    as Vec16<T>::unpack widens them (little-endian: lane 0 is the low
    bits of a word)."""
    w = x.contiguous().view(torch.int32).reshape(x.shape[0] // E, -1)
    if x.dtype == F32:
        lanes = w.view(F32)[..., None]
    elif x.dtype == BF16:                    # bf16 bits into the high half
        lanes = torch.stack([w << 16, w & -65536], -1).view(F32)
    else:                                    # int8: sign-extended by shifts
        lanes = torch.stack([(w << (24 - 8 * b)) >> 24 for b in range(4)],
                            -1).float()
    return lanes.reshape(x.shape[0] // E, E)


def _seq(v):
    """The one-thread sum from k = 0."""
    acc = v[0]
    for x in v[1:]:
        acc = acc + x
    return acc


def _delta_vector_mirror(prev, dstacked, rowscale, sizes, keep, coefs):
    """server_mix_delta in the order of its 16-byte kernel."""
    K, n = dstacked.shape
    # delta_prologue: products one a thread; tot in one thread; weights
    # and row coefficients one a thread; sum_k w_k and c in one thread
    prod = [sizes[k] * keep[k] for k in range(K)]
    tot = _seq(prod)
    alpha = torch.minimum(coefs[0] + coefs[1] * coefs[3], coefs[2])
    beta = 1.0 - alpha
    denom = torch.clamp(tot, min=1e-9)
    w = [prod[k] / denom for k in range(K)]
    rc = [beta * w[k] * rowscale[k] for k in range(K)]
    c = torch.where(tot > 0, alpha, 1.0) + beta * _seq(w)
    E = _unit(prev.dtype, dstacked.dtype)
    acc = _unpack(prev, E) * c
    for k0 in range(0, K, VEC_ROWS):
        batch = [_unpack(dstacked[k], E)
                 for k in range(k0, min(k0 + VEC_ROWS, K))]
        for q, d in enumerate(batch):
            acc = acc + d * rc[k0 + q]
    return acc.reshape(n).to(prev.dtype)


def _adam_vector_mirror(prev, stacked, m, v, sizes, keep, scalars):
    """server_adam in the order of its 16-byte kernel."""
    K, n = stacked.shape
    b1, b2, lr, tau, step = (scalars[i] for i in range(5))
    # adam_prologue: products one a thread beside the bias corrections;
    # tot in one thread; the weights one a thread
    prod = [sizes[k] * keep[k] for k in range(K)]
    omb1, bc1 = 1.0 - b1, 1.0 - b1 ** step
    omb2, bc2 = 1.0 - b2, 1.0 - b2 ** step
    tot = _seq(prod)
    w = [prod[k] / torch.clamp(tot, min=1e-9) for k in range(K)]
    E = _unit(prev.dtype)
    agg = torch.zeros(n // E, E)
    for k0 in range(0, K, VEC_ROWS):
        batch = [_unpack(stacked[k], E)
                 for k in range(k0, min(k0 + VEC_ROWS, K))]
        for q, x in enumerate(batch):
            agg = agg + x * w[k0 + q]
    p = _unpack(prev, E)
    delta = torch.where(tot > 0, agg - p, 0.0)
    nm = b1 * _unpack(m, E) + omb1 * delta
    nv = b2 * _unpack(v, E) + omb2 * delta * delta
    update = (nm / bc1) / (torch.sqrt(nv / bc2) + tau)
    return ((p + lr * update).reshape(n).to(prev.dtype), nm.reshape(n),
            nv.reshape(n))


def _weights(rng, K, kept):
    sizes = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32))
    keep = torch.from_numpy((rng.rand(K) < 0.7).astype(np.float32))
    keep[0] = 1.0
    return sizes, keep * float(kept)


@pytest.mark.parametrize("kept", [True, False], ids=["kept", "nobody_kept"])
@pytest.mark.parametrize("rt", [I8, BF16, F32], ids=["i8", "bf16", "f32"])
@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 5, 10])
def test_server_mix_delta_vector_loop_order_equals_plain(K, dt, rt, kept):
    """K 10 spans two row batches; prev holds a -0.0, int8 rows the
    extremes -127 and 127 (and -1, 0), float rows a NaN; nobody kept
    takes a_eff = 1."""
    rng = np.random.RandomState(K * 10 + kept)
    N = 96                                   # 6 int8 words, 12 bf16, 24 f32
    assert N % _unit(dt, rt) == 0
    prev = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dt)
    prev[7] = -0.0
    if rt == I8:
        rows = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(np.int8))
        rows[0, :5] = torch.tensor([-127, 127, -1, 0, 1], dtype=I8)
        rs = torch.from_numpy((rng.rand(K) * 1e-2).astype(np.float32))
    else:
        rows = torch.from_numpy((0.1 * rng.randn(K, N)).astype(np.float32)
                                ).to(rt)
        rows[K - 1, 11] = float("nan")
        rs = torch.ones(K)
    sizes, keep = _weights(rng, K, kept)
    coefs = torch.tensor([0.1, 2.5e-3, 0.95, 7.0])
    args = (prev, rows, rs, sizes, keep, coefs)
    want = tref.server_mix_delta_math(*args)
    got = _delta_vector_mirror(*args)
    assert got.dtype == dt and torch.equal(_bits(got), _bits(want))
    if rt != I8:        # a NaN row value propagates, kept or not: a row
        assert torch.isnan(want[11].float())  # of weight 0 is still added
    if not kept:        # a_eff = 1: prev comes back (-0.0 + 0 is +0.0)
        fin = ~torch.isnan(want.float())
        assert torch.equal(want[fin], prev[fin])
        assert _bits(want)[7] == 0 and _bits(prev)[7] != 0


@pytest.mark.parametrize("kept", [True, False], ids=["kept", "nobody_kept"])
@pytest.mark.parametrize("step", [1.0, 37.0], ids=["step1", "step37"])
@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [1, 5, 10])
def test_server_adam_vector_loop_order_equals_plain(K, dt, step, kept):
    """K 10 spans two row batches; prev holds a -0.0, a client row a NaN;
    nobody kept takes delta = 0."""
    rng = np.random.RandomState(K * 10 + int(step) + kept)
    N = 64                                   # 16 f32 words, 8 bf16
    prev = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dt)
    prev[7] = -0.0
    stacked = (prev.float()[None] + 0.01 * torch.from_numpy(
        rng.randn(K, N).astype(np.float32))).to(dt)
    stacked[K - 1, 11] = float("nan")
    m = torch.from_numpy((1e-3 * rng.randn(N)).astype(np.float32))
    v = torch.from_numpy((1e-6 * rng.rand(N)).astype(np.float32))
    sizes, keep = _weights(rng, K, kept)
    sc = torch.tensor([0.9, 0.99, 0.1, 1e-3, step])
    args = (prev, stacked, m, v, sizes, keep, sc)
    want = tref.server_adam_math(*args)
    got = _adam_vector_mirror(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert torch.isnan(want[0][11].float()) == kept
    if not kept:                             # delta = 0: m and v decay
        assert torch.equal(want[1], sc[0] * m)


def test_unpack_widens_every_lane_exactly():
    """The word-wise widening of each row dtype equals PyTorch's .float()
    lane for lane, int8 over all 256 values."""
    q = torch.arange(-128, 128, dtype=torch.int16).to(I8)
    assert torch.equal(_unpack(q, 16).reshape(-1), q.float())
    x = torch.from_numpy(np.random.RandomState(0).randn(64)
                         .astype(np.float32))
    for dt in (F32, BF16):
        y = x.to(dt)
        assert torch.equal(_bits(_unpack(y, 16).reshape(-1)),
                           _bits(y.float()))


@pytest.mark.parametrize("name,src", [("server_adam", "server_adam.cu"),
                                      ("server_mix_delta",
                                       "server_mix_compressed.cu")])
def test_adam_and_delta_design_entries_are_bound(name, src):
    """The C entries that count each kernel's launches are declared to
    ctypes and read by server_plane, in MIX_DESIGNS' order."""
    entry = f"{name}_design_counts"
    assert build.VOID_SIGNATURES[entry] == (build._P,)
    text = (CSRC / src).read_text()
    assert f'extern "C" void {entry}(long long* counts)' in text
    assert callable(getattr(tsp, f"{name}_designs"))
    assert tsp.MIX_DESIGNS == ("per_element", "vector")
    # the vector kernel's thread owns E = 16 bytes of the narrower operand
    assert re.search(r"struct Vec16<int8_t> \{\s*static constexpr int E = 16;",
                     (CSRC / "common.cuh").read_text())
