"""The port's fedprox and fedopt strategies and the round under a comm
plane, against the JAX package's; and the port's own chunked ==
per-round contract for them.

Params start in JAX and cross through numpy, so both packages train the
same model on the same schedules and staged batches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.core.round as jround
import repro_torch.core.round as tround
from repro.configs.base import FLConfig as JFL
from repro.configs.registry import ARCHS as JARCHS
from repro.core import strategies as jstrategies
from repro.core.client import make_local_train as jmake_local_train
from repro.core.simulation import FederatedSimulation as JSim
from repro.data.partition import shard_partition
from repro.data.pipeline import build_clients, stage_chunk
from repro.data.synth import make_image_classification
from repro.models.api import build_model as jbuild
from repro_torch.comm import plane as tplane
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import strategies as tstrategies
from repro_torch.core.client import make_local_train as tmake_local_train
from repro_torch.core.round import as_scan_scheds
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.pipeline import build_clients as tbuild_clients
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten, params_from_numpy, params_to_numpy

# one round: a few local SGD steps of f32 conv/matmul whose sums XLA and
# PyTorch order differently, then the server update (as
# tests/test_torch_round.py)
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
# ten rounds of fedprox: the per-op differences compounded over ~40 SGD
# steps and 10 server mixes (as tests/test_torch_round.py)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
# ten rounds of fedopt: server Adam divides the pseudo-gradient by
# sqrt(v) + tau (tau = 1e-3), which scales a difference in a small delta
# by up to lr / tau = 100, and its near-sign steps of lr = 0.1 a round
# feed that back through the clients. Measured port vs JAX: 3.0e-6 after
# one round, 1.7e-4 after five, 1.31e-2 after ten; the JAX package's own
# two implementations (server_plane "fused" against "legacy") differ by
# the same 1.31e-2 after the same ten rounds. The round losses then
# differ by up to 3.7e-4 relative (measured).
ADAM_RUN_TOL = dict(rtol=0, atol=2e-2)
SALT = 0x00C0FFEE


def _fl_kw(algo, **kw):
    md = kw.pop("max_delay", 0)
    return dict(num_clients=8, clients_per_round=4, local_epochs=1,
                local_batch_size=10, lr=0.1, p_limited=0.5, algorithm=algo,
                max_delay=md, p_delay=0.4 if md else 0.0, seed=0, **kw)


@pytest.fixture(scope="module")
def world():
    train, test = make_image_classification(n_train=240, n_test=60, seed=0)
    part = shard_partition(train["label"], 8, seed=0)
    jp = jbuild(JARCHS["paper-cnn"]).init(jax.random.PRNGKey(0))
    return train, test, part, jax.tree.map(np.asarray, jp)


def _assert_trees_close(t_tree, j_tree, tol):
    jflat = dict(flatten(jax.tree.map(np.asarray, j_tree)))
    tflat = dict(flatten(params_to_numpy(t_tree)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **tol)


SCHED = {"limited": np.array([True, False, True, False]),
         "delayed": np.array([False, True, False, False]),
         "delays": np.array([1, 2, 1, 1], np.int32),
         "data_sizes": np.array([30.0, 25.0, 40.0, 35.0], np.float32)}


@pytest.mark.parametrize("algo", ["fedprox", "fedopt"])
def test_one_round_matches_jax(world, algo):
    """Stacked client params (the prox pull, partial work on limited
    clients), losses, the new global and fedopt's m, v, step after one
    round at t = 3 from step 2's moments."""
    train, _, part, p0 = world
    kw = _fl_kw(algo)
    jfl, tfl = JFL(**kw), TFL(**kw)
    staged = stage_chunk(train, build_clients(train, part),
                         np.array([[0, 3, 5, 6]]), 0, 3, 3, 10)
    batch = {k: v[0] for k, v in staged.items()}            # (C, steps, b)

    jmodel = jbuild(JARCHS["paper-cnn"])
    jstrat = jstrategies.resolve(jfl)
    jcp, jloss = jax.jit(jmake_local_train(jmodel, jfl, jstrat))(
        p0, batch, jnp.asarray(SCHED["limited"]))
    rng = np.random.RandomState(1)
    aux0 = jax.tree.map(np.asarray, jstrat.init_state(p0))
    if algo == "fedopt":
        aux0 = {"m": jax.tree.map(lambda x: 1e-3 * rng.randn(*x.shape)
                                  .astype(np.float32), aux0["m"]),
                "v": jax.tree.map(lambda x: 1e-6 * rng.rand(*x.shape)
                                  .astype(np.float32), aux0["v"]),
                "step": np.int32(2)}
    jsched = {k: jnp.asarray(v) for k, v in SCHED.items()}
    jnew, jaux = jstrat.fused_server_update(
        jnp.int32(3), p0, jcp, jsched, jax.tree.map(jnp.asarray, aux0))

    tmodel = tbuild(TARCHS["paper-cnn"])
    tstrat = tstrategies.resolve(tfl)
    tp0 = params_from_numpy(p0)
    tsched = as_scan_scheds(SCHED, "cpu")
    tcp, tloss = tmake_local_train(tmodel, tfl, tstrat)(
        tp0, {k: torch.from_numpy(v) for k, v in batch.items()},
        tsched["limited"])
    _assert_trees_close(tcp, jcp, ROUND_TOL)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **ROUND_TOL)
    if algo == "fedprox":   # partial work: limited clients take 1 of 3
        assert torch.equal(tstrat.local_steps(3, tsched["limited"]),
                           torch.tensor([1, 3, 1, 3], dtype=torch.int32))
    taux0 = params_from_numpy(aux0)
    tnew, taux = tstrat.fused_server_update(
        torch.tensor(3, dtype=torch.int32), tp0, tcp, tsched, taux0)
    _assert_trees_close(tnew, jnew, ROUND_TOL)
    if algo == "fedopt":
        _assert_trees_close(taux["m"], jaux["m"], ROUND_TOL)
        _assert_trees_close(taux["v"], jaux["v"], ROUND_TOL)
        assert taux["step"].dtype == torch.int32 and int(taux["step"]) == 3


@pytest.mark.parametrize("algo,tol,loss_rtol", [
    ("fedprox", RUN_TOL, 1e-4), ("fedopt", ADAM_RUN_TOL, 1e-3)])
def test_ten_rounds_match_jax(world, algo, tol, loss_rtol):
    train, test, part, p0 = world
    kw = _fl_kw(algo)
    js = JSim(jbuild(JARCHS["paper-cnn"]), JFL(**kw),
              build_clients(train, part), test, donate=False, prefetch=False)
    jh = js.run(rounds=10, eval_every=5)
    ts = TSim(tbuild(TARCHS["paper-cnn"]), TFL(**kw),
              tbuild_clients(train, part), test, device="cpu")
    ts.state["params"] = params_from_numpy(p0)
    th = ts.run(rounds=10, eval_every=5)
    assert ts.t == 10 and th.eval_rounds == jh.eval_rounds == [5, 10]
    _assert_trees_close(ts.params, js.params, tol)
    if algo == "fedopt":
        _assert_trees_close(ts.aux["m"], js.aux["m"], tol)
        assert int(ts.aux["step"]) == int(js.aux["step"]) == 10
    one_example = 1.0 / 60
    assert abs(th.final_accuracy() - jh.final_accuracy()) <= one_example
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=loss_rtol)


COMM_CASES = [("ama", "q8", 0), ("fedavg", "bf16", 0), ("ama", "topk", 0),
              ("fedopt", "q8", 0), ("async_ama", "q8", 2)]


@pytest.mark.parametrize("algo,plane,md", COMM_CASES)
def test_one_compressed_round_matches_jax(world, monkeypatch, algo, plane,
                                          md):
    """One whole round step of each package under a comm plane, from the
    same client params and a nonzero carried residual: compress, then
    the in-kernel compressed mix (ama, fedavg) or the densified fused
    update (fedopt, async_ama). q8 is handed JAX's uniforms."""
    _, _, _, p0 = world
    rng = np.random.RandomState(7)
    kw = _fl_kw(algo, max_delay=md, comm_plane=plane, comm_topk_frac=0.01)
    jfl, tfl = JFL(**kw), TFL(**kw)
    cp = jax.tree.map(lambda x: (x[None] + 0.01 * rng.randn(4, *x.shape))
                      .astype(np.float32), p0)
    loss = np.arange(4, dtype=np.float32)
    jstate = jround.init_state(jbuild(JARCHS["paper-cnn"]), jfl,
                               jax.random.PRNGKey(0))
    aux = jax.tree.map(np.asarray, jstate["aux"])
    aux["comm"] = {k: (1e-3 * rng.randn(*v.shape)).astype(np.float32)
                   for k, v in aux["comm"].items()}
    t = 5

    monkeypatch.setattr(jround, "make_local_train",
                        lambda *a: lambda g, b, lim: (
                            jax.tree.map(jnp.asarray, cp), jnp.asarray(loss)))
    jstep = jround.make_round_step(jbuild(JARCHS["paper-cnn"]), jfl)
    jout, _ = jstep({"params": jax.tree.map(jnp.asarray, p0),
                     "t": jnp.int32(t),
                     "aux": jax.tree.map(jnp.asarray, aux)}, {},
                    {k: jnp.asarray(v) for k, v in SCHED.items()})

    def jax_uniforms(seed, tt, group, shape, row0=0):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed ^ SALT), jnp.uint32(int(tt))), group)
        return torch.from_numpy(np.array(jax.random.uniform(
            key, shape, jnp.float32)))
    monkeypatch.setattr(tplane, "q8_uniforms", jax_uniforms)
    monkeypatch.setattr(tround, "make_local_train",
                        lambda *a: lambda g, b, lim: (
                            params_from_numpy(cp), torch.from_numpy(loss)))
    tstep = tround.make_round_step(tbuild(TARCHS["paper-cnn"]), tfl)
    tout, _ = tstep({"params": params_from_numpy(p0),
                     "t": torch.tensor(t, dtype=torch.int32),
                     "aux": params_from_numpy(aux)}, {},
                    as_scan_scheds(SCHED, "cpu"))
    _assert_trees_close(tout["params"], jout["params"], ROUND_TOL)
    _assert_trees_close(tout["aux"], jout["aux"], ROUND_TOL)
    assert set(tout["aux"]) == set(jout["aux"]) and "comm" in tout["aux"]


@pytest.mark.parametrize("algo,plane,md", [
    ("fedopt", "none", 0), ("fedprox", "none", 0), ("ama_fes", "q8", 0),
    ("ama_fes", "topk", 0), ("async_ama", "q8", 3)])
def test_chunked_equals_per_round_bitwise(world, algo, plane, md):
    """The port's contract: params, every aux (moments and step, the
    residual, the ring buffer) and the histories, bit for bit."""
    train, test, part, _ = world
    fl = TFL(**_fl_kw(algo, max_delay=md, comm_plane=plane))
    sims = {s: TSim(tbuild(TARCHS["paper-cnn"]), fl,
                    tbuild_clients(train, part), test, use_scan=s,
                    device="cpu") for s in (True, False)}
    hists = {s: sim.run(rounds=5, eval_every=2) for s, sim in sims.items()}
    a, b = (flatten({"p": sims[s].params, "a": sims[s].aux})
            for s in (True, False))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), k
    assert hists[True].train_loss == hists[False].train_loss
    assert hists[True].test_acc == hists[False].test_acc
    if plane != "none":
        assert float(sims[True].aux["comm"]["g0"].abs().sum()) > 0
