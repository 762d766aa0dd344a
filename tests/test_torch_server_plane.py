"""The port's server plane (repro_torch.kernels) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions; they are
held against the JAX Pallas kernels in interpret mode and against the JAX
``ref`` oracles, f32 and bf16, K=1, N not a multiple of 128, the round
where nobody is kept (tot == 0), and for the async plane over more
rounds than the ring has slots (the ring wraps). The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_kernels_gpu.py, marker ``gpu``; chip_smoke.py).
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs.base import FLConfig as JFL
from repro.core.async_ama import ALPHA_UNNORM as J_ALPHA_UNNORM
from repro.core.async_ama import gamma_unnorm as jgamma
from repro.kernels import ref as jref
from repro.kernels import server_plane as jsp
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core.async_ama import gamma_unnorm as tgamma
from repro_torch.core.async_ama import init_queue
from repro_torch.kernels import ref as tref
from repro_torch.kernels import server_plane as tsp

# f32: the same op order on both sides; XLA may contract a multiply-add
# into one FMA where PyTorch rounds twice, a few ulp at the terms' scale.
# bf16: one bf16 ulp (2^-7 relative) when an f32 difference crosses a
# rounding boundary of the bf16 output.
TOL = {"float32": dict(rtol=2e-6, atol=2e-6),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(x, dtype=None):
    """A JAX array -> a CPU torch tensor with the same values (bf16 goes
    through f32, which holds it exactly)."""
    a = np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                   else x)
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


def _mix_world(rng, K, N, dt, nobody_kept=False):
    jdt, tdt = DTYPES[dt]
    keep = (rng.rand(K) < 0.7).astype(np.float32)
    keep[0] = 1.0
    if nobody_kept:
        keep[:] = 0.0
    j = dict(prev=jnp.asarray(rng.randn(N), jdt),
             stacked=jnp.asarray(rng.randn(K, N), jdt),
             sizes=jnp.asarray(rng.rand(K) + 0.5, jnp.float32),
             keep=jnp.asarray(keep),
             coefs=jnp.asarray([0.1, 2.5e-3, 0.95, 7.0], jnp.float32))
    t = {k: _t(v, tdt if k in ("prev", "stacked") else None)
         for k, v in j.items()}
    return j, t


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,nobody_kept", [(1, 100, False),
                                             (7, 4096 + 17, False),
                                             (5, 300, True)])
def test_server_mix_matches_jax_interpret_and_ref(dt, K, N, nobody_kept):
    j, t = _mix_world(np.random.RandomState(K * N), K, N, dt, nobody_kept)
    args = ("prev", "stacked", "sizes", "keep", "coefs")
    interp = jsp.server_mix_flat(*(j[a] for a in args), block=1024,
                                 interpret=True)
    oracle = jref.server_mix_math(*(j[a] for a in args))
    got = tsp.server_mix_flat(*(t[a] for a in args))
    assert got.dtype == DTYPES[dt][1] and got.shape == (N,)
    _close(got, interp, dt)
    _close(got, oracle, dt)
    if nobody_kept:      # tot == 0: the whole beta budget reverts to prev
        _close(got, j["prev"], dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,Q,N", [(1, 3, 129), (6, 5, 1000)])
def test_server_async_matches_jax_over_ring_wrap(dt, K, Q, N):
    """3Q consecutive rounds, random delays, some rounds with nobody on
    time: out, qsum and qgamma each round. Both sides take the same
    inputs every round (the JAX outputs of the round before)."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(K + Q + N)
    prev = jnp.asarray(rng.randn(N), jdt)
    qsum = jnp.zeros((Q, N), jnp.float32)
    qgamma = jnp.zeros((Q,), jnp.float32)
    sizes = jnp.asarray(rng.rand(K) + 0.5, jnp.float32)
    hyp = jnp.asarray([0.1, 2.5e-3, 0.95, 0.6], jnp.float32)
    for t in range(3 * Q):
        stacked = jnp.asarray(rng.randn(K, N), jdt)
        delayed = (rng.rand(K) < 0.4).astype(np.float32)
        if t % 4 == 1:
            delayed[:] = 1.0                      # nobody on time
        delays = np.where(delayed > 0, rng.randint(1, Q, K), 1)
        j = (prev, stacked, qsum, qgamma, sizes, jnp.asarray(delayed),
             jnp.asarray(delays, jnp.int32),
             jnp.asarray([t, t % Q], jnp.int32), hyp)
        interp = jsp.server_async_flat(*j, block=256, interpret=True)
        oracle = jref.server_async_math(*j)
        got = tsp.server_async_flat(
            *(_t(x, tdt if i < 2 else None) for i, x in enumerate(j)))
        for g, a, b, d in zip(got, interp, oracle, (dt, "float32",
                                                    "float32")):
            _close(g, a, d)
            _close(g, b, d)
        prev, qsum, qgamma = interp
    assert float(jnp.abs(qsum).sum()) > 0        # the ring carried updates


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tsp.reset_counts()
    _, t = _mix_world(np.random.RandomState(0), 3, 257, "float32")
    args = [t[a] for a in ("prev", "stacked", "sizes", "keep", "coefs")]
    assert torch.equal(tsp.server_mix_flat(*args), tref.server_mix_math(*args))
    fl = TFL(max_delay=2)
    params = {"a": {"w": torch.randn(4, 3)}, "b": torch.randn(5)}
    stacked = {"a": {"w": torch.randn(3, 4, 3)}, "b": torch.randn(3, 5)}
    tsp.server_async_tree(params, stacked, init_queue(fl, params),
                          torch.ones(3), torch.tensor([0.0, 1.0, 0.0]),
                          torch.tensor([1, 2, 1], dtype=torch.int32),
                          torch.tensor(4, dtype=torch.int32),
                          tsp.device_vector((0.1, 2.5e-3, 0.95, 0.6), "cpu"),
                          impl="ref")
    assert tsp.server_mix_flat.launches == 0
    assert tsp.server_async_flat.launches == 0
    assert tsp.plain_runs_on_cuda == dict.fromkeys(tsp.KERNELS, 0)
    assert {"server_mix", "server_async"} <= set(tsp.plain_runs_on_cuda)


def test_kernel_entries_keep_their_plain_versions_signatures():
    """The port's counterpart of fedlint FED204: each kernel wrapper takes
    exactly its plain version's positional parameters."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import rwkv6_scan as trs
    from repro_torch.kernels.ama_mix import ama_mix_flat, ama_mix_leaves
    for kernel, plain in ((tsp.server_mix_flat, tref.server_mix_math),
                          (tsp.server_async_flat, tref.server_async_math),
                          (ama_mix_flat, tref.ama_mix_math),
                          (ama_mix_leaves, tref.ama_mix_leaves_math),
                          (tfa.flash_fwd, tref.flash_attention_ref),
                          (tfa.flash_bwd_dq, tref.flash_bwd_dq_ref),
                          (tfa.flash_bwd_dkdv, tref.flash_bwd_dkdv_ref),
                          (tfa.flash_attention, tref.flash_attention_ref),
                          (trs.rwkv6_fwd, tref.rwkv6_scan_ref),
                          (trs.rwkv6_bwd, tref.rwkv6_scan_bwd_ref)):
        assert (list(inspect.signature(kernel).parameters)
                == list(inspect.signature(plain).parameters))


def test_wrappers_refuse_malformed_operands():
    _, t = _mix_world(np.random.RandomState(1), 2, 64, "float32")
    with pytest.raises(TypeError):
        tsp.server_mix_flat(t["prev"], t["stacked"].double(), t["sizes"],
                            t["keep"], t["coefs"])
    with pytest.raises(ValueError):
        tsp.server_mix_flat(t["prev"], t["stacked"][:, :32], t["sizes"],
                            t["keep"], t["coefs"])
    with pytest.raises(ValueError):
        tsp.server_mix_flat(t["prev"], t["stacked"].T.contiguous().T,
                            t["sizes"], t["keep"], t["coefs"])
    with pytest.raises(ValueError):
        tsp.server_mix_tree({"w": t["prev"]}, {"w": t["stacked"]}, t["sizes"],
                            t["keep"], t["coefs"], impl="interpret")


def test_schedule_constants_match_jax():
    """alpha^- (and the CUDA source's literal of it), gamma^- and the
    mix coefficients equal the JAX package's."""
    assert tref.ALPHA_UNNORM == float(J_ALPHA_UNNORM)
    cu = (Path(tsp.__file__).parent / "csrc" / "server_plane.cu").read_text()
    lit = re.search(r"kAlphaUnnorm = (0x[0-9a-fA-Fp.+-]+)f;", cu).group(1)
    assert float.fromhex(lit) == tref.ALPHA_UNNORM
    d = np.arange(1, 21, dtype=np.int32)
    np.testing.assert_allclose(tgamma(TFL(), torch.from_numpy(d)).numpy(),
                               np.asarray(jgamma(JFL(), d)), rtol=1e-6)
    t = torch.tensor(9, dtype=torch.int32)
    for adaptive in (True, False):
        np.testing.assert_array_equal(
            tsp.mix_coefs(TFL(), t, adaptive=adaptive).numpy(),
            np.asarray(jsp.mix_coefs(JFL(), 9, adaptive=adaptive)))
