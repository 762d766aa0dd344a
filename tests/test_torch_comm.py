"""The port's comm plane (repro_torch.comm) and bandwidth environment
against the JAX package's.

The bf16 codec equals JAX bit for bit. The q8 codec equals JAX bit for
bit when it is handed JAX's uniform draw; the port's own noise stream is
a splitmix64 stream (not JAX's threefry), checked for purity in
(t, group), for its bits against the JAX package's numpy ``hash_bits``
and for the codec's bound. top-k is compared on distinct magnitudes as
sets of (position, value) pairs per row (``torch.topk`` and
``jax.lax.top_k`` order ties differently). Bandwidth schedules equal the
JAX environment's bitwise on the dense and the virtual population path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import comm as jcomm
from repro import env as jenv
from repro.comm import plane as jplane
from repro.configs.base import FLConfig as JFL
from repro.env.virtual import hash_bits
from repro_torch import comm as tcomm
from repro_torch import env as tenv
from repro_torch.comm import plane as tplane
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.round import init_state
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import leaves, params_from_numpy, unflatten

SALT = 0x00C0FFEE


def _e(rng, K=4, N=257):
    return rng.randn(K, N).astype(np.float32) * np.float32(0.05)


def _eq(t, j):
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    b = np.asarray(jnp.asarray(j, jnp.float32) if j.dtype == jnp.bfloat16
                   else j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _jax_uniform(seed, t, group, shape):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed ^ SALT), jnp.uint32(t)), group)
    return key, np.array(jax.random.uniform(key, shape, jnp.float32))


def test_bf16_encode_is_bitwise_jax():
    e = _e(np.random.RandomState(0))
    tp, tdq = tplane.bf16_encode(torch.from_numpy(e))
    jp, jdq = jplane.bf16_encode(jnp.asarray(e))
    assert tp["kind"] == jp["kind"] == "delta"
    assert tp["d"].dtype == torch.bfloat16
    _eq(tp["d"], jp["d"])
    _eq(tp["scale"], jp["scale"])
    _eq(tdq, jdq)


def test_q8_encode_with_jax_uniforms_is_bitwise_jax():
    e = _e(np.random.RandomState(1))
    e[2] = 0.0                               # an all-zero row: scale floor
    key, u = _jax_uniform(3, 7, 1, e.shape)
    tp, tdq = tplane.q8_encode(torch.from_numpy(e),
                               torch.from_numpy(u))
    jp, jdq = jplane.q8_encode(key, jnp.asarray(e))
    assert tp["d"].dtype == torch.int8
    _eq(tp["d"], jp["d"])
    _eq(tp["scale"], jp["scale"])
    _eq(tdq, jdq)


def test_q8_stream_is_pure_in_t_and_group_and_is_hash_bits():
    """The port's own stream: a function of (seed, t, group, element)
    only, the top 24 bits of the JAX package's numpy hash_bits."""
    seed, shape = 5, (3, 50)
    t = torch.tensor(9, dtype=torch.int32)
    u = tplane.q8_uniforms(seed, t, 2, shape)
    assert u.dtype == torch.float32 and u.shape == shape
    assert torch.equal(u, tplane.q8_uniforms(seed, t.clone(), 2, shape))
    assert not torch.equal(u, tplane.q8_uniforms(seed, t + 1, 2, shape))
    assert not torch.equal(u, tplane.q8_uniforms(seed, t, 3, shape))
    bits = hash_bits(seed, SALT, np.int64(9), np.int64(2),
                     np.arange(150, dtype=np.int64))
    want = (bits >> np.uint64(40)).astype(np.float32) * np.float32(2 ** -24)
    np.testing.assert_array_equal(u.numpy().reshape(-1), want)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    e = torch.from_numpy(_e(np.random.RandomState(2), 3, 50))
    payload, dq = tplane.q8_encode(e, u)
    bound = payload["scale"][:, None]
    assert bool(((e - dq).abs() <= bound).all())
    assert int(payload["d"].abs().max()) <= 127


def test_topk_encode_matches_jax_as_sets():
    rng = np.random.RandomState(3)
    K, N, kk = 3, 200, 17
    e = (rng.permutation(K * N).reshape(K, N).astype(np.float32) + 1.0) \
        * np.where(rng.rand(K, N) < 0.5, -1.0, 1.0).astype(np.float32)
    tp, tdq = tplane.topk_encode(torch.from_numpy(e), kk)
    jp, jdq = jplane.topk_encode(jnp.asarray(e), kk)
    assert tp["i"].dtype == torch.int32 and tp["v"].shape == (K, kk)
    for k in range(K):
        assert (set(zip(tp["i"][k].tolist(), tp["v"][k].tolist()))
                == set(zip(np.asarray(jp["i"][k]).tolist(),
                           np.asarray(jp["v"][k]).tolist())))
    _eq(tdq, jdq)


def _params(rng):
    return {"a": {"w": rng.randn(6, 5).astype(np.float32)},
            "b": rng.randn(7).astype(np.float32),
            "c": np.asarray(jnp.asarray(rng.randn(9), jnp.bfloat16))}


def _stacked(rng, p, K):
    return {k: (_stacked(rng, v, K) if isinstance(v, dict) else np.asarray(
        jnp.asarray(np.asarray(v, np.float32)[None]
                    + 0.1 * rng.randn(K, *v.shape), v.dtype)))
            for k, v in p.items()}


def _torch(tree):
    return params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        if x.dtype == jnp.bfloat16 else x, tree))


def _bf16_back(t_tree, np_tree):
    return unflatten(t_tree, [
        x.to(torch.bfloat16) if y.dtype == jnp.bfloat16 else x
        for x, y in zip(leaves(t_tree), jax.tree.leaves(np_tree))])


@pytest.mark.parametrize("name", ["bf16", "q8", "topk"])
def test_compress_decode_reconstruct_match_jax(name, monkeypatch):
    """compress (two dtype groups, carried residual), decode and
    reconstruct against JAX; q8 gets JAX's uniforms injected."""
    rng = np.random.RandomState(4)
    K, t = 3, 6
    p = _params(rng)
    s = _stacked(rng, p, K)
    kw = dict(comm_plane=name, comm_topk_frac=0.2, seed=2)
    jpl, tpl = jcomm.resolve(JFL(**kw)), tcomm.resolve(TFL(**kw))
    monkeypatch.setattr(tplane, "q8_uniforms",
                        lambda seed, tt, g, shape, row0=0:
                        torch.from_numpy(_jax_uniform(
                            seed, int(tt), g, shape)[1]))
    jres = {k: jnp.asarray(0.01 * rng.randn(*v.shape), jnp.float32)
            for k, v in jpl.init_residual(p, K).items()}
    tres = {k: torch.from_numpy(np.array(v)) for k, v in jres.items()}
    jg, jnew = jpl.compress(jnp.int32(t), jax.tree.map(jnp.asarray, p),
                            jax.tree.map(jnp.asarray, s), jres)
    tp = _bf16_back(_torch(p), p)
    tg, tnew = tpl.compress(torch.tensor(t, dtype=torch.int32), tp,
                            _bf16_back(_torch(s), s), tres)
    assert [i for i, _ in tg] == [i for i, _ in jg] and len(tg) == 2
    for (idxs, a), (_, b) in zip(tg, jg):
        assert a.keys() == b.keys()
        for key in a:       # top-k pairs may be ordered differently
            if key != "kind" and not (name == "topk" and key in "iv"):
                _eq(a[key], b[key])
        n = sum(jax.tree.leaves(p)[i].size for i in idxs)
        _eq(tplane.decode(a, n), jplane.decode(b, n))
    assert tnew.keys() == jnew.keys() == {"g0", "g1"}
    for key in jnew:        # the residual e - dq, bit for bit
        _eq(tnew[key], jnew[key])
    jrec = jpl.reconstruct(jax.tree.map(jnp.asarray, p), jg)
    trec = tpl.reconstruct(tp, tg)
    for x, y in zip(leaves(trec), jax.tree.leaves(jrec)):
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))


def test_registry_bytes_and_wire_fraction_match_jax():
    rng = np.random.RandomState(5)
    p = _params(rng)
    tp = _bf16_back(_torch(p), p)
    assert tcomm.dense_bytes(tp) == jcomm.dense_bytes(
        jax.tree.map(jnp.asarray, p))
    assert tcomm.names() == jcomm.names() == ["bf16", "int8", "q8", "topk"]
    for name in ("none", "bf16", "q8", "int8", "topk"):
        for frac in (0.01, 0.3, 0.9):
            kw = dict(comm_plane=name, comm_topk_frac=frac)
            assert (tcomm.wire_fraction(TFL(**kw))
                    == jcomm.wire_fraction(JFL(**kw)))
            tpl, jpl = tcomm.resolve(TFL(**kw)), jcomm.resolve(JFL(**kw))
            if name == "none":
                assert tpl is None and jpl is None
                continue
            assert type(tpl).__name__ == type(jpl).__name__
            assert tpl.payload_bytes(tp) == jpl.payload_bytes(
                jax.tree.map(jnp.asarray, p))
    assert type(tcomm.resolve(TFL(comm_plane="int8"))) is tplane.Q8Plane
    with pytest.raises(ValueError, match="unknown comm plane"):
        tcomm.resolve(TFL(comm_plane="fp4"))
    for frac in (0.0, 1.5):
        with pytest.raises(ValueError, match="comm_topk_frac"):
            tcomm.resolve(TFL(comm_plane="topk", comm_topk_frac=frac))


def test_error_feedback_off_carries_no_residual():
    model = tbuild(TARCHS["paper-cnn"])
    gen = torch.Generator().manual_seed(0)
    on = init_state(model, TFL(comm_plane="q8"), gen, "cpu")
    assert set(on["aux"]["comm"]) == {"g0"}
    assert on["aux"]["comm"]["g0"].shape == (10, 54_784)
    off = init_state(model, TFL(comm_plane="q8", comm_error_feedback=False),
                     gen, "cpu")
    assert "comm" not in off["aux"]
    assert "comm" not in init_state(model, TFL(), gen, "cpu")["aux"]


# ------------------------------------------------------- bandwidth env ----

def _assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("plane", ["none", "q8"])
@pytest.mark.parametrize("population,K,max_delay", [("auto", 20, 5),
                                                    ("virtual", 100_000, 5),
                                                    ("auto", 20, 0)])
def test_bandwidth_schedule_bitwise(plane, population, K, max_delay):
    kw = dict(num_clients=K, clients_per_round=5, p_limited=0.5,
              env="bandwidth", max_delay=max_delay, population=population,
              comm_plane=plane, seed=3)
    je, te = jenv.resolve(JFL(**kw)), tenv.resolve(TFL(**kw))
    assert type(te).__name__ == "BandwidthEnvironment"
    a, b = je.batch(4, 30), te.batch(4, 30)
    _assert_dicts_equal(a, b)
    r = te.round(10)                       # batch row i == round(t0 + i)
    for k in ("selected", "delayed", "delays"):
        np.testing.assert_array_equal(getattr(r, k), b[k][6])
    if max_delay:
        assert b["delayed"].any() and (b["delays"] <= max_delay).all()
    else:
        assert not b["delayed"].any()


def test_bandwidth_on_time_share_rises_with_compression():
    """FLConfig's bandwidth defaults (4 Mbit upload, 2 Mbps median, sigma
    0.8, 1 s deadline): the q8 upload (a quarter of the bits) is on time
    far more often than the dense one."""
    on_time = {}
    for plane in ("none", "q8"):
        sb = tenv.resolve(TFL(num_clients=20, clients_per_round=5,
                              env="bandwidth", max_delay=5,
                              comm_plane=plane)).batch(0, 400)
        on_time[plane] = float(np.mean(~sb["delayed"]))
    assert 0.1 < on_time["none"] < 0.3 and 0.7 < on_time["q8"] < 0.9
    assert tenv.names() == ["bandwidth", "bernoulli", "bursty", "ge",
                            "gilbert_elliott", "iid_delay", "mobility",
                            "snr", "trace"]
