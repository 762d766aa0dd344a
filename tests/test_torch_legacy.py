"""The port's legacy server chain (``--server-plane legacy``, with and
without ``use_kernel``) against the JAX package's, the ``ama_mix``
kernel's plain version against the JAX Pallas kernel, the pre-reduced
client axis (``client_reduce="force"``) and the telemetry series.

On the CPU the port's ``ama_mix_flat`` runs its plain version
(``kernels/ref.py: ama_mix_math``); the JAX kernel runs in interpret
mode. Inputs are made from numpy seeds and cross through
``params_from_numpy``. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FLConfig as JFL
from repro.configs.registry import ARCHS as JARCHS
from repro.core import async_ama as jasync
from repro.core import strategies as jstrategies
from repro.core.simulation import FederatedSimulation as JSim
from repro.data.partition import shard_partition
from repro.data.pipeline import build_clients
from repro.data.synth import make_image_classification
from repro.kernels import ama_mix as jam
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.api import build_model as jbuild
from repro.obs import metrics as jmetrics
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import async_ama as tasync
from repro_torch.core import strategies as tstrategies
from repro_torch.core.round import as_scan_scheds, init_state, make_round_step
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.pipeline import build_clients as tbuild_clients
from repro_torch.data.pipeline import stage_chunk as tstage_chunk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import server_plane as tsp
from repro_torch.kernels.ama_mix import ama_mix_flat
from repro_torch.models.api import build_model as tbuild
from repro_torch.obs import metrics as tmetrics
from repro_torch.utils.tree import flatten, params_from_numpy, params_to_numpy

# ama_mix: the same op order on both sides; XLA may contract a
# multiply-add into one FMA where PyTorch rounds twice (a few f32 ulp at
# the terms' scale), and a bf16 output may then round to the next bf16
# value (one bf16 ulp, 2^-7 relative)
KTOL = {"float32": dict(rtol=2e-6, atol=2e-6),
        "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
# one server update: the port's weighted client sum runs one client at a
# time where JAX contracts with an einsum (another summation order)
STEP_TOL = dict(rtol=2e-6, atol=2e-6)
# legacy vs fused and the pre-reduced axis, as the JAX package holds its
# own legacy and fused planes (tests/test_server_plane.py)
IMPL_TOL = dict(rtol=1e-5, atol=1e-6)
# ten rounds of the engine: the per-op differences of local SGD and the
# server chain compounded over ~40 SGD steps and 10 updates; fedopt's
# server Adam amplifies a difference in a small pseudo-gradient by up to
# lr / tau = 100 (the JAX package's own fused and legacy planes drift
# apart by as much, see tests/test_torch_strategies_ext.py)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
FEDOPT_RUN_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ALGOS = [("ama_fes", 0), ("fedavg", 0), ("fedprox", 0), ("fedopt", 0),
         ("async_ama", 10)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one machine; at these tiny
    shapes torch's intra-op thread pool in each worker would only
    oversubscribe the cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    """A JAX array -> a CPU tensor with the same values (bf16 through
    f32, which holds it exactly)."""
    a = np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                   else x)
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype) if dtype is not None else t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


def _assert_trees_close(t_tree, j_tree, tol):
    jflat = dict(flatten(jax.tree.map(np.asarray, j_tree)))
    tflat = dict(flatten(params_to_numpy(t_tree)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **tol)


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), k


# ------------------------------------------------------------- kernel --

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("N", [100, 4096 + 17])
def test_ama_mix_math_matches_jax_kernel_and_ref(dt, K, N):
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(K * N)
    prev = jnp.asarray(rng.randn(N), jdt)
    stacked = jnp.asarray(rng.randn(K, N), jdt)
    alpha = jnp.float32(rng.rand())
    w = jnp.asarray(rng.rand(K), jnp.float32)
    interp = jam.ama_mix_flat(prev, stacked, alpha, w, block=1024,
                              interpret=True)
    oracle = jref.ama_mix_ref(prev, stacked, alpha, w)
    targs = (_t(prev, tdt), _t(stacked, tdt), _t(alpha).reshape(1), _t(w))
    tsp.reset_counts()
    got = ama_mix_flat(*targs)
    assert got.dtype == tdt and got.shape == (N,)
    assert torch.equal(got, tref.ama_mix_math(*targs))
    assert ama_mix_flat.launches == 0          # CPU: the plain version
    _close(got, interp, KTOL[dt])
    _close(got, oracle, KTOL[dt])


def test_ama_mix_math_takes_f32_rows_under_bf16_prev():
    """The async operand: a bf16 leaf mixed with the (2, n) f32 stack of
    the on-time aggregate and the popped stale sum."""
    rng = np.random.RandomState(5)
    prev = jnp.asarray(rng.randn(1003), jnp.bfloat16)
    stacked = jnp.asarray(rng.randn(2, 1003), jnp.float32)
    alpha, w = jnp.float32(0.3), jnp.asarray([0.5, 0.2], jnp.float32)
    interp = jam.ama_mix_flat(prev, stacked, alpha, w, block=256,
                              interpret=True)
    got = ama_mix_flat(_t(prev, torch.bfloat16), _t(stacked),
                       _t(alpha).reshape(1), _t(w))
    assert got.dtype == torch.bfloat16
    _close(got, interp, KTOL["bfloat16"])


def test_ama_mix_tree_and_pairwise_match_jax():
    rng = np.random.RandomState(0)
    prev = {"w": jnp.asarray(rng.randn(7, 9), jnp.float32),
            "b": jnp.asarray(rng.randn(13), jnp.bfloat16)}
    stacked = {"w": jnp.asarray(rng.randn(3, 7, 9), jnp.float32),
               "b": jnp.asarray(rng.randn(3, 13), jnp.bfloat16)}
    agg = {"w": jnp.asarray(rng.randn(7, 9), jnp.float32),
           "b": jnp.asarray(rng.randn(13), jnp.bfloat16)}
    alpha = jnp.float32(0.35)
    wts = jnp.asarray([0.2, 0.3, 0.25], jnp.float32)

    def tt(tree):
        return {k: _t(v, torch.bfloat16 if v.dtype == jnp.bfloat16 else None)
                for k, v in tree.items()}

    jt = jops.ama_mix_tree(prev, stacked, alpha, wts, interpret=True)
    tt_ = tops.ama_mix_tree(tt(prev), tt(stacked), _t(alpha), _t(wts))
    jp = jops.ama_mix_pairwise(prev, agg, alpha, interpret=True)
    tp = tops.ama_mix_pairwise(tt(prev), tt(agg), _t(alpha))
    for k in prev:
        dt = "bfloat16" if prev[k].dtype == jnp.bfloat16 else "float32"
        assert tt_[k].shape == tuple(prev[k].shape)
        _close(tt_[k], jt[k], KTOL[dt])
        _close(tp[k], jp[k], KTOL[dt])
    # a Python alpha is filled in on the device, as fedavg's 0.0 is
    tp0 = tops.ama_mix_pairwise(tt(prev), tt(agg), 0.0)
    assert torch.equal(tp0["w"], tt(agg)["w"])


# ------------------------------------------------------ legacy chain --

def _server_world(rng, C, md):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    prev = {"a": f(3, 4), "b": {"c": f(5)}}
    cp = {"a": prev["a"][None] + 0.1 * f(C, 3, 4),
          "b": {"c": prev["b"]["c"][None] + 0.1 * f(C, 5)}}
    delayed = rng.rand(C) < 0.4
    delayed[0] = False
    sched = {"limited": rng.rand(C) < 0.5, "delayed": delayed,
             "delays": np.where(delayed, rng.randint(1, max(md, 1) + 1, C),
                                1).astype(np.int32),
             "data_sizes": (rng.rand(C) + 0.5).astype(np.float32)}
    return prev, cp, sched


def _strategies(algo, md, **kw):
    base = dict(algorithm=algo, max_delay=md, p_delay=0.4 if md else 0.0,
                **kw)
    return (jstrategies.resolve(JFL(**base)),
            tstrategies.resolve(TFL(**base)))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("algo,md", ALGOS)
def test_legacy_server_updates_match_jax(algo, md, use_kernel):
    """Four consecutive legacy server updates (the ring buffer fills and
    pops; fedopt's step counts up) on the same inputs in both packages."""
    js, ts = _strategies(algo, md, server_plane="legacy",
                         use_kernel=use_kernel)
    rng = np.random.RandomState(7)
    prev, _, _ = _server_world(rng, 4, md)
    jprev, tprev = prev, params_from_numpy(prev)
    jaux, taux = js.init_state(jprev), ts.init_state(tprev)
    for t in range(4):
        _, cp, sched = _server_world(rng, 4, md)
        jnew, jaux = js.fused_server_update(
            jnp.int32(t), jprev, cp, {k: jnp.asarray(v)
                                      for k, v in sched.items()}, jaux)
        tnew, taux = ts.fused_server_update(
            torch.tensor(t, dtype=torch.int32), tprev,
            params_from_numpy(cp), as_scan_scheds(sched, "cpu"), taux)
        _assert_trees_close(tnew, jnew, STEP_TOL)
        _assert_trees_close(taux, jaux, STEP_TOL)
        jprev, tprev = jnew, params_from_numpy(jax.tree.map(np.asarray,
                                                            jnew))
    if md:
        assert float(taux["queue"]["gamma"].sum()) > 0


@pytest.mark.parametrize("algo,md", ALGOS)
def test_use_kernel_equals_the_plain_chain_bitwise(algo, md):
    """The kernel's plain version runs the plain chain's op order: over
    eight consecutive legacy updates (the async ring pops non-empty
    slots, fedopt's step counts up) the chain gives the same bits with
    and without use_kernel."""
    runs = []
    for uk in (False, True):
        _, ts = _strategies(algo, md, server_plane="legacy", use_kernel=uk)
        rng = np.random.RandomState(11)
        prev, _, _ = _server_world(rng, 5, 3)
        tprev = params_from_numpy(prev)
        aux, outs, popped = ts.init_state(tprev), [], 0
        for t in range(8):
            _, cp, sched = _server_world(rng, 5, 3)   # delays 1..3 < Q
            tt = torch.tensor(t, dtype=torch.int32)
            tsched = as_scan_scheds(sched, "cpu")
            if md:      # a popped slot with stale mass lowers alpha_eff
                popped += bool(ts.mix_coefficient(tt, tsched, aux)
                               < ts.fl.alpha0 + ts.fl.eta * t - 1e-6)
            tprev, aux = ts.fused_server_update(tt, tprev,
                                                params_from_numpy(cp),
                                                tsched, aux)
            outs.append({"p": tprev, "a": aux})
        runs.append(outs)
        if md:
            assert popped >= 2
    for a, b in zip(*runs):
        _assert_trees_equal(a, b)


@pytest.mark.parametrize("algo,md", ALGOS)
def test_legacy_and_reduced_match_the_fused_plane(algo, md):
    """Port legacy (with and without the kernel) and client_reduce =
    "force" against the port's fused plane, params and aux allclose."""
    rng = np.random.RandomState(42)
    prev, cp, sched = _server_world(rng, 4, md)
    tprev, tcp = params_from_numpy(prev), params_from_numpy(cp)
    tsched = as_scan_scheds(sched, "cpu")
    t = torch.tensor(2, dtype=torch.int32)
    _, fused = _strategies(algo, md)
    want = flatten(dict(zip("pa", fused.fused_server_update(
        t, tprev, tcp, tsched, fused.init_state(tprev)))))
    gots = []
    for kw in (dict(server_plane="legacy"),
               dict(server_plane="legacy", use_kernel=True)):
        _, s = _strategies(algo, md, **kw)
        gots.append(s.fused_server_update(t, tprev, tcp, tsched,
                                          s.init_state(tprev)))
    gots.append(fused.reduced_server_update(t, tprev, tcp, tsched,
                                            fused.init_state(tprev)))
    for got in gots:
        for g, w in zip(flatten(dict(zip("pa", got))), want, strict=True):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1].float().numpy(),
                                       w[1].float().numpy(), err_msg=g[0],
                                       **IMPL_TOL)


@pytest.fixture(scope="module")
def world():
    train, test = make_image_classification(n_train=240, n_test=60, seed=0)
    part = shard_partition(train["label"], 8, seed=0)
    jp = jbuild(JARCHS["paper-cnn"]).init(jax.random.PRNGKey(0))
    return train, test, part, jax.tree.map(np.asarray, jp)


def _fl_kw(algo, md, **kw):
    return dict(num_clients=8, clients_per_round=4, local_epochs=1,
                local_batch_size=10, lr=0.1, p_limited=0.5, algorithm=algo,
                max_delay=md, p_delay=0.4 if md else 0.0, seed=0, **kw)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("algo,md", ALGOS)
def test_ten_legacy_rounds_match_jax(world, algo, md, use_kernel):
    """The engine end to end under the legacy chain: 10 rounds in chunks
    of 5, params and aux within RUN_TOL of the JAX package's, the same
    accuracy within one test example."""
    train, test, part, p0 = world
    kw = _fl_kw(algo, md, server_plane="legacy", use_kernel=use_kernel)
    js = JSim(jbuild(JARCHS["paper-cnn"]), JFL(**kw),
              build_clients(train, part), test, donate=False, prefetch=False)
    jh = js.run(rounds=10, eval_every=5)
    ts = TSim(tbuild(TARCHS["paper-cnn"]), TFL(**kw),
              tbuild_clients(train, part), test, device="cpu")
    ts.state["params"] = params_from_numpy(p0)
    tsp.reset_counts()
    th = ts.run(rounds=10, eval_every=5)
    assert ts.t == 10 and th.eval_rounds == jh.eval_rounds == [5, 10]
    tol = FEDOPT_RUN_TOL if algo == "fedopt" else RUN_TOL
    _assert_trees_close(ts.params, js.params, tol)
    _assert_trees_close(ts.aux, js.aux, tol)
    assert abs(th.final_accuracy() - jh.final_accuracy()) <= 1.0 / 60
    # CPU tensors: no kernel launch, no plain run counted on the card
    assert all(fn.launches == 0 for fn in tsp.KERNELS.values())
    assert tsp.plain_runs_on_cuda == dict.fromkeys(tsp.KERNELS, 0)


@pytest.mark.parametrize("algo,md", [("ama_fes", 0), ("async_ama", 3),
                                     ("fedopt", 0)])
def test_client_reduce_force_runs_close_to_fused(world, algo, md):
    """Three rounds with the pre-reduced client axis against three fused
    rounds in the port: one contraction instead of the fused plane's
    sequential chain, so allclose, at the tolerance the JAX package
    holds its own pair to (tests/test_federation_scale.py)."""
    train, test, part, _ = world
    runs = []
    for mode in ("off", "force"):
        ts = TSim(tbuild(TARCHS["paper-cnn"]),
                  TFL(**_fl_kw(algo, md, client_reduce=mode)),
                  tbuild_clients(train, part), test, device="cpu")
        ts.run(rounds=3, eval_every=3)
        runs.append(ts)
    tol = FEDOPT_RUN_TOL if algo == "fedopt" else dict(rtol=5e-4, atol=1e-5)
    for (k, x), (_, y) in zip(flatten({"p": runs[0].params,
                                       "a": runs[0].aux}),
                              flatten({"p": runs[1].params,
                                       "a": runs[1].aux}), strict=True):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   err_msg=k, **tol)


def test_enqueue_pop_and_mixing_weights_match_jax():
    fl_j, fl_t = JFL(max_delay=4), TFL(max_delay=4)
    rng = np.random.RandomState(3)
    prev, cp, sched = _server_world(rng, 5, 4)
    jq = jasync.init_queue(fl_j, prev)
    tq = tasync.init_queue(fl_t, params_from_numpy(prev))
    for t in range(7):
        _, cp, sched = _server_world(rng, 5, 4)
        jq = jasync.enqueue(fl_j, jq, t, cp, jnp.asarray(sched["delayed"]),
                            jnp.asarray(sched["delays"]))
        tq = tasync.enqueue(fl_t, tq, torch.tensor(t, dtype=torch.int32),
                            params_from_numpy(cp),
                            torch.from_numpy(sched["delayed"]),
                            torch.from_numpy(sched["delays"]))
        js, jg, jq = jasync.pop_slot(jq, t)
        ts_, tg, tq = tasync.pop_slot(tq, torch.tensor(t, dtype=torch.int32))
        _assert_trees_close(ts_, js, STEP_TOL)
        _assert_trees_close(tq, jq, STEP_TOL)
        np.testing.assert_allclose(float(tg), float(jg), rtol=2e-6)
    for t, stale in ((3, [1, 2]), (40, [5, 1, 1]), (2, [])):
        got = tasync.mixing_weights(fl_t, t, stale)
        want = jasync.mixing_weights(fl_j, t, stale)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        assert got[1] == pytest.approx(want[1], rel=1e-12)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


# ---------------------------------------------------------- telemetry --

@pytest.mark.parametrize("algo,md,comm", [("ama_fes", 0, None),
                                          ("fedavg", 0, None),
                                          ("fedopt", 0, None),
                                          ("async_ama", 4, None),
                                          ("async_ama", 4, 13_000)])
def test_round_metrics_match_jax(algo, md, comm):
    """Every key of ROUND_METRIC_KEYS from the same round's tensors."""
    assert tmetrics.ROUND_METRIC_KEYS == jmetrics.ROUND_METRIC_KEYS
    js, ts = _strategies(algo, md)
    rng = np.random.RandomState(9)
    prev, cp, sched = _server_world(rng, 5, md)
    _, new, _ = _server_world(rng, 5, md)
    jaux = js.init_state(prev)
    taux = ts.init_state(params_from_numpy(prev))
    if md:      # a ring holding earlier delayed updates
        jaux["queue"]["gamma"] = jnp.asarray(rng.rand(md + 1), jnp.float32)
        taux["queue"]["gamma"] = torch.from_numpy(
            np.array(jaux["queue"]["gamma"]))
    payload = jmetrics.payload_bytes(prev)
    assert tmetrics.payload_bytes(params_from_numpy(prev)) == payload
    want = jmetrics.round_metrics(
        JFL(algorithm=algo, max_delay=md), js, jnp.int32(6), prev, cp, new,
        {k: jnp.asarray(v) for k, v in sched.items()}, jaux,
        payload=payload, payload_compressed=comm)
    got = tmetrics.round_metrics(
        TFL(algorithm=algo, max_delay=md), ts,
        torch.tensor(6, dtype=torch.int32), params_from_numpy(prev),
        params_from_numpy(cp), params_from_numpy(new),
        as_scan_scheds(sched, "cpu"), taux, payload=payload,
        payload_compressed=comm)
    assert set(got) == set(want) == set(jmetrics.ROUND_METRIC_KEYS)
    for k in jmetrics.ROUND_METRIC_KEYS:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("server_plane", ["fused", "legacy"])
def test_metrics_on_leave_the_params_stream_bitwise(world, server_plane):
    """extended_metrics on or off: the same params and aux, bit for bit,
    and the on-run's rounds carry every telemetry key."""
    train, _, part, _ = world
    tmodel = tbuild(TARCHS["paper-cnn"])
    staged = tstage_chunk(train, tbuild_clients(train, part),
                          np.array([[0, 3, 5, 6]] * 3), 0, 0, 2, 10)
    rng = np.random.RandomState(1)
    scheds = [{"limited": rng.rand(4) < 0.5, "delayed": rng.rand(4) < 0.4,
               "delays": rng.randint(1, 4, 4).astype(np.int32),
               "data_sizes": (rng.rand(4) + 0.5).astype(np.float32)}
              for _ in range(3)]
    outs = []
    for ext in (False, True):
        fl = TFL(**_fl_kw("async_ama", 3, server_plane=server_plane,
                          use_kernel=True, extended_metrics=ext))
        step = make_round_step(tmodel, fl)
        state = init_state(tmodel, fl, torch.Generator().manual_seed(0),
                           "cpu")
        for t in range(3):
            batch = {k: torch.from_numpy(v[t]) for k, v in staged.items()}
            state, m = step(state, batch, as_scan_scheds(scheds[t], "cpu"))
        want = {"loss", "n_on_time"} | (set(tmetrics.ROUND_METRIC_KEYS)
                                        if ext else set())
        assert set(m) == want
        outs.append(state)
    _assert_trees_equal(outs[0], outs[1])
