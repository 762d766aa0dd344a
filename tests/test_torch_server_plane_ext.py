"""The port's FedOpt and compressed-uplink server planes against the JAX
package's: ``server_adam``, ``server_mix_delta`` and
``server_mix_scatter``.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX ``ref`` oracles and the Pallas kernels in interpret
mode on the same seeded numpy inputs: f32 and bf16 prev, int8 and bf16
delta rows, K = 1, the round where nobody is kept (tot == 0), lengths
that are not a multiple of the block, and top-k positions that collide
across clients. The tree-level functions are held against their JAX
counterparts. The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels import server_plane as jsp
from repro_torch.kernels import ref as tref
from repro_torch.kernels import server_plane as tsp
from repro_torch.utils.tree import (leaves, params_from_numpy,
                                    params_to_numpy, unflatten)

# f32: the same op order on both sides; XLA may contract a multiply-add
# into one FMA where PyTorch rounds twice, and computes pow, sqrt and the
# weight sum (jnp.sum against the port's sequential sum) with its own
# rounding: a few ulp at the terms' scale. bf16: one bf16 ulp (2^-7
# relative) when an f32 difference crosses a rounding boundary.
TOL = {"float32": dict(rtol=2e-6, atol=2e-6),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROWS = {"int8": (jnp.int8, torch.int8), "bfloat16": DTYPES["bfloat16"]}


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


def _weights(rng, K, nobody_kept):
    keep = (rng.rand(K) < 0.7).astype(np.float32)
    keep[0] = 1.0
    if nobody_kept:
        keep[:] = 0.0
    return (jnp.asarray(rng.rand(K) + 0.5, jnp.float32), jnp.asarray(keep))


COEFS = jnp.asarray([0.1, 2.5e-3, 0.95, 7.0], jnp.float32)


# ------------------------------------------------------------- B3 adam ----

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,nobody_kept", [(1, 100, False),
                                             (5, 2048 + 37, False),
                                             (3, 300, True)])
def test_server_adam_matches_jax_interpret_and_ref(dt, K, N, nobody_kept):
    """Three consecutive steps (the moments carried from JAX's output),
    so the bias corrections take step = 1, 2, 3."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(K * N + 3)
    sizes, keep = _weights(rng, K, nobody_kept)
    prev = jnp.asarray(rng.randn(N), jdt)
    m = jnp.zeros((N,), jnp.float32)
    v = jnp.zeros((N,), jnp.float32)
    for step in (1, 2, 3):
        stacked = jnp.asarray(prev.astype(jnp.float32)[None]
                              + 0.1 * rng.randn(K, N), jdt)
        scalars = jnp.asarray([0.9, 0.99, 0.1, 1e-3, step], jnp.float32)
        j = (prev, stacked, m, v, sizes, keep, scalars)
        interp = jsp.server_adam_flat(*j, block=1024, interpret=True)
        oracle = jref.server_adam_math(*j)
        got = tsp.server_adam_flat(
            *(_t(x, tdt if i < 2 else None) for i, x in enumerate(j)))
        assert got[0].dtype == tdt and got[1].dtype == torch.float32
        for g, a, b, d in zip(got, interp, oracle, (dt, "float32",
                                                    "float32")):
            _close(g, a, d)
            _close(g, b, d)
        if nobody_kept:     # zero pseudo-gradient: the model stays put
            _close(got[0], prev, dt)
            assert float(got[1].abs().max()) == 0.0
        prev, m, v = interp


# ------------------------------------------------------------ B4 delta ----

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", ["int8", "bfloat16"])
@pytest.mark.parametrize("K,N,nobody_kept", [(1, 129, False),
                                             (7, 4096 + 17, False),
                                             (4, 300, True)])
def test_server_mix_delta_matches_jax_interpret_and_ref(dt, rows, K, N,
                                                        nobody_kept):
    jdt, tdt = DTYPES[dt]
    jr, tr = ROWS[rows]
    rng = np.random.RandomState(K * N + len(rows))
    sizes, keep = _weights(rng, K, nobody_kept)
    if rows == "int8":
        d = jnp.asarray(rng.randint(-127, 128, (K, N)), jnp.int8)
        scale = jnp.asarray(rng.rand(K) * 0.01 + 1e-4, jnp.float32)
    else:
        d = jnp.asarray(0.1 * rng.randn(K, N), jr)
        scale = jnp.ones((K,), jnp.float32)
    j = (jnp.asarray(rng.randn(N), jdt), d, scale, sizes, keep, COEFS)
    interp = jsp.server_mix_delta_flat(*j, block=1024, interpret=True)
    oracle = jref.server_mix_delta_math(*j)
    got = tsp.server_mix_delta_flat(_t(j[0], tdt), _t(j[1], tr),
                                    *(_t(x) for x in j[2:]))
    assert got.dtype == tdt and got.shape == (N,)
    _close(got, interp, dt)
    _close(got, oracle, dt)
    if nobody_kept:
        _close(got, j[0], dt)


# ---------------------------------------------------------- B5 scatter ----

def _topk_world(rng, K, N, kk, jdt):
    """Distinct positions within a row; rows 1.. reuse half of row 0's
    positions, so positions collide across clients."""
    idx = np.stack([rng.choice(N, kk, replace=False) for _ in range(K)])
    for k in range(1, K):
        idx[k, :kk // 2] = idx[0, rng.permutation(kk)[:kk // 2]]
        rest = np.setdiff1d(np.arange(N), idx[k, :kk // 2])
        idx[k, kk // 2:] = rng.choice(rest, kk - kk // 2, replace=False)
    assert all(len(set(r)) == kk for r in idx)
    return (jnp.asarray(rng.randn(N), jdt),
            jnp.asarray(rng.randn(K, kk), jnp.float32),
            jnp.asarray(idx, jnp.int32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,kk,nobody_kept", [(1, 100, 7, False),
                                                (4, 3000 + 11, 300, False),
                                                (3, 257, 20, True)])
def test_server_mix_scatter_matches_jax_interpret_and_ref(dt, K, N, kk,
                                                          nobody_kept):
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(K * N + kk)
    sizes, keep = _weights(rng, K, nobody_kept)
    prev, vals, idx = _topk_world(rng, K, N, kk, jdt)
    j = (prev, vals, idx, sizes, keep, COEFS)
    interp = jsp.server_mix_scatter_flat(*j, block=512, interpret=True)
    oracle = jref.server_mix_scatter_math(*j)
    got = tsp.server_mix_scatter_flat(_t(prev, tdt),
                                      *(_t(x) for x in j[1:]))
    assert got.dtype == tdt and got.shape == (N,)
    _close(got, interp, dt)
    _close(got, oracle, dt)
    if nobody_kept:
        _close(got, prev, dt)


def test_scatter_equals_delta_on_the_densified_rows():
    """The scatter is the delta mix over rows that are zero off the
    top-k positions: the same function, bit for bit, with collisions."""
    rng = np.random.RandomState(5)
    K, N, kk = 4, 1000, 120
    prev, vals, idx = (_t(x) for x in _topk_world(rng, K, N, kk,
                                                  jnp.float32))
    sizes, keep = (_t(x) for x in _weights(rng, K, False))
    coefs = _t(COEFS)
    dense = torch.zeros(K, N).scatter_add_(1, idx.long(), vals)
    a = tsp.server_mix_scatter_flat(prev, vals, idx, sizes, keep, coefs)
    b = tsp.server_mix_delta_flat(prev, dense, torch.ones(K), sizes, keep,
                                  coefs)
    assert torch.equal(a, b)


# ---------------------------------------------------------- tree level ----

def _tree_world(rng, K):
    p = {"a": {"w": rng.randn(4, 3).astype(np.float32)},
         "b": rng.randn(5).astype(np.float32),
         "c": jnp.asarray(rng.randn(6), jnp.bfloat16)}
    s = jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x, np.float32)[None] + 0.1 * rng.randn(K, *x.shape),
        jnp.asarray(x).dtype), p)
    return jax.tree.map(jnp.asarray, p), s


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
        else np.asarray(x), tree))


def _bf16_like(t_tree, j_tree):
    """Cast the leaves that are bf16 in the JAX tree back to bf16."""
    flat_j = jax.tree.leaves(j_tree)
    return unflatten(t_tree, [x.to(torch.bfloat16) if y.dtype == jnp.bfloat16
                              else x for x, y in zip(leaves(t_tree), flat_j)])


def _assert_trees_close(t_tree, j_tree):
    for (x, y) in zip(jax.tree.leaves(params_to_numpy(
            jax.tree.map(lambda a: a.float(), t_tree))), jax.tree.leaves(
            jax.tree.map(lambda a: np.asarray(a, np.float32), j_tree))):
        np.testing.assert_allclose(x, y, **TOL["bfloat16"])


def test_server_adam_tree_matches_jax():
    """Two dtype groups (f32 and bf16 leaves): one call per group."""
    rng = np.random.RandomState(11)
    K = 3
    jp, js = _tree_world(rng, K)
    jm = jax.tree.map(lambda x: jnp.asarray(rng.rand(*x.shape) * 0.01,
                                            jnp.float32), jp)
    jv = jax.tree.map(lambda x: jnp.asarray(rng.rand(*x.shape) * 0.01,
                                            jnp.float32), jp)
    sizes, keep = _weights(rng, K, False)
    scalars = jnp.asarray([0.9, 0.99, 0.1, 1e-3, 4.0], jnp.float32)
    want = jsp.server_adam_tree(jp, js, jm, jv, sizes, keep, scalars,
                                impl="ref")
    tsp.reset_counts()
    got = tsp.server_adam_tree(
        _bf16_like(_to_torch(jp), jp), _bf16_like(_to_torch(js), js),
        _to_torch(jm), _to_torch(jv), _t(sizes), _t(keep), _t(scalars))
    for g, w in zip(got, want):
        _assert_trees_close(g, w)
    assert got[0]["c"].dtype == torch.bfloat16
    assert got[1]["c"].dtype == torch.float32
    assert tsp.server_adam_flat.launches == 0      # CPU: the plain version


@pytest.mark.parametrize("kind", ["delta", "topk"])
def test_server_mix_compressed_tree_matches_jax(kind):
    rng = np.random.RandomState(12)
    K = 3
    jp, _ = _tree_world(rng, K)
    sizes, keep = _weights(rng, K, False)
    leaves = jax.tree.leaves(jp)
    groups_j, groups_t = [], []
    for idxs in jsp._dtype_groups(leaves).values():
        n = sum(leaves[i].size for i in idxs)
        if kind == "delta":
            d = jnp.asarray(rng.randint(-127, 128, (K, n)), jnp.int8)
            s = jnp.asarray(rng.rand(K) * 0.01, jnp.float32)
            groups_j.append((idxs, {"kind": "delta", "d": d, "scale": s}))
            groups_t.append((idxs, {"kind": "delta", "d": _t(d),
                                    "scale": _t(s)}))
        else:
            kk = max(1, n // 4)
            _, v, i = _topk_world(rng, K, n, kk, jnp.float32)
            groups_j.append((idxs, {"kind": "topk", "v": v, "i": i}))
            groups_t.append((idxs, {"kind": "topk", "v": _t(v),
                                    "i": _t(i)}))
    want = jsp.server_mix_compressed_tree(jp, groups_j, sizes, keep, COEFS,
                                          impl="ref")
    got = tsp.server_mix_compressed_tree(
        _bf16_like(_to_torch(jp), jp), groups_t, _t(sizes), _t(keep),
        _t(COEFS), impl="ref")
    _assert_trees_close(got, want)
    assert got["c"].dtype == torch.bfloat16
    assert tsp.plain_runs_on_cuda["server_mix_delta"] == 0   # CPU tensors


# --------------------------------------------------- wrapper contracts ----

def test_kernel_entries_keep_their_plain_versions_signatures():
    """The port's counterpart of fedlint FED204 for this slice's kernels:
    each wrapper takes exactly its plain version's positional
    parameters, and every wrapper has a launch counter."""
    for kernel, plain in (
            (tsp.server_adam_flat, tref.server_adam_math),
            (tsp.server_mix_delta_flat, tref.server_mix_delta_math),
            (tsp.server_mix_scatter_flat, tref.server_mix_scatter_math)):
        assert (list(inspect.signature(kernel).parameters)
                == list(inspect.signature(plain).parameters))
    tsp.reset_counts()
    assert {k: f.launches for k, f in tsp.KERNELS.items()} == dict.fromkeys(
        ["server_mix", "server_async", "server_adam", "server_mix_delta",
         "server_mix_scatter", "ama_mix"], 0)
    assert set(tsp.plain_runs_on_cuda) == set(tsp.KERNELS)


def test_new_wrappers_refuse_malformed_operands():
    N, K = 64, 2
    z = torch.zeros
    with pytest.raises(TypeError):      # int16 rows are not a payload type
        tsp.server_mix_delta_flat(z(N), z(K, N, dtype=torch.int16), z(K),
                                  z(K), z(K), z(4))
    with pytest.raises(TypeError):      # positions must be int32
        tsp.server_mix_scatter_flat(z(N), z(K, 3), z(K, 3, dtype=torch.int64),
                                    z(K), z(K), z(4))
    with pytest.raises(TypeError):      # moments are f32 for bf16 prev too
        tsp.server_adam_flat(z(N, dtype=torch.bfloat16),
                             z(K, N, dtype=torch.bfloat16),
                             z(N, dtype=torch.bfloat16), z(N), z(K), z(K),
                             z(5))
    with pytest.raises(ValueError):
        tsp.server_adam_flat(z(N), z(K, N), z(N), z(N), z(K), z(K), z(4))
    with pytest.raises(ValueError):
        tsp.server_mix_compressed_tree(
            {"w": z(N)}, [([0], {"kind": "fp8"})], z(K), z(K), z(4))
