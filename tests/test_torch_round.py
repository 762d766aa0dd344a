"""The port's round and engine (repro_torch.core / repro_torch.exec)
against the JAX package's, and the port's own chunked == per-round
contract.

Params start in JAX and cross through numpy, so both packages train the
same model on the same schedules and staged batches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FLConfig as JFL
from repro.configs.registry import ARCHS as JARCHS
from repro.core import strategies as jstrategies
from repro.core.client import make_local_train as jmake_local_train
from repro.core.simulation import FederatedSimulation as JSim
from repro.data.partition import shard_partition
from repro.data.pipeline import build_clients, stage_chunk
from repro.data.synth import make_image_classification
from repro.models.api import build_model as jbuild
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import strategies as tstrategies
from repro_torch.core.client import make_local_train as tmake_local_train
from repro_torch.core.round import as_scan_scheds, make_round_step
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.pipeline import build_clients as tbuild_clients
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten, params_from_numpy, params_to_numpy

# one round: a few local SGD steps of f32 conv/matmul whose sums XLA and
# PyTorch order differently, then the server mix
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
# ten rounds: the same per-op differences compounded over ~40 SGD steps
# and 10 server mixes (measured: < 2e-7 absolute)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [("ama_fes", 0), ("fedavg", 0), ("async_ama", 2)]


def _fl_kw(algo, md):
    return dict(num_clients=8, clients_per_round=4, local_epochs=1,
                local_batch_size=10, lr=0.1, p_limited=0.5, algorithm=algo,
                max_delay=md, p_delay=0.4 if md else 0.0, seed=0)


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


@pytest.mark.parametrize("algo,md", CASES)
def test_one_round_matches_jax(world, algo, md):
    """Stacked client params (limited cohorts FES-masked), losses and the
    new global (and ring buffer) after one round at t = 3."""
    train, _, part, p0 = world
    kw = _fl_kw(algo, md)
    jfl, tfl = JFL(**kw), TFL(**kw)
    sched = {"limited": np.array([True, False, True, False]),
             "delayed": np.array([False, True, False, False]) if md
             else np.zeros(4, bool),
             "delays": np.array([1, 2, 1, 1], np.int32),
             "data_sizes": np.array([30.0, 25.0, 40.0, 35.0], np.float32)}
    staged = stage_chunk(train, build_clients(train, part),
                         np.array([[0, 3, 5, 6]]), 0, 3, 3, 10)
    batch = {k: v[0] for k, v in staged.items()}            # (C, steps, b)

    jmodel = jbuild(JARCHS["paper-cnn"])
    jstrat = jstrategies.resolve(jfl)
    jcp, jloss = jax.jit(jmake_local_train(jmodel, jfl, jstrat))(
        p0, batch, jnp.asarray(sched["limited"]))
    jaux = jstrat.init_state(p0)
    jsched = {k: jnp.asarray(v) for k, v in sched.items()}
    jnew, jaux = jstrat.fused_server_update(jnp.int32(3), p0, jcp, jsched,
                                            jaux)

    tmodel = tbuild(TARCHS["paper-cnn"])
    tstrat = tstrategies.resolve(tfl)
    tp0 = params_from_numpy(p0)
    tsched = as_scan_scheds(sched, "cpu")
    tcp, tloss = tmake_local_train(tmodel, tfl, tstrat)(
        tp0, {k: torch.from_numpy(v) for k, v in batch.items()},
        tsched["limited"])
    _assert_trees_close(tcp, jcp, ROUND_TOL)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **ROUND_TOL)
    if algo != "fedavg":     # FES: limited cohorts keep the global body
        for c in (0, 2):
            assert torch.equal(tcp["body"]["conv1"]["w"][c],
                               tp0["body"]["conv1"]["w"])
        assert not torch.equal(tcp["body"]["conv1"]["w"][1],
                               tp0["body"]["conv1"]["w"])
    tnew, taux = tstrat.fused_server_update(
        torch.tensor(3, dtype=torch.int32), tp0, tcp, tsched,
        tstrat.init_state(tp0))
    _assert_trees_close(tnew, jnew, ROUND_TOL)
    if md:
        _assert_trees_close(taux["queue"]["sum"], jaux["queue"]["sum"],
                            ROUND_TOL)
        np.testing.assert_allclose(taux["queue"]["gamma"].numpy(),
                                   np.asarray(jaux["queue"]["gamma"]),
                                   **ROUND_TOL)
        assert float(taux["queue"]["gamma"].sum()) > 0


@pytest.mark.parametrize("algo,md", CASES)
def test_ten_rounds_match_jax(world, algo, md):
    """The engine end to end: 10 rounds in chunks of 5 give the JAX
    params within RUN_TOL and the same accuracy within one test example."""
    train, test, part, p0 = world
    kw = _fl_kw(algo, md)
    js = JSim(jbuild(JARCHS["paper-cnn"]), JFL(**kw),
              build_clients(train, part), test, donate=False, prefetch=False)
    jh = js.run(rounds=10, eval_every=5)
    ts = TSim(tbuild(TARCHS["paper-cnn"]), TFL(**kw),
              tbuild_clients(train, part), test, device="cpu")
    ts.state["params"] = params_from_numpy(p0)
    th = ts.run(rounds=10, eval_every=5)
    assert ts.t == 10 and th.eval_rounds == jh.eval_rounds == [5, 10]
    _assert_trees_close(ts.params, js.params, RUN_TOL)
    if md:
        _assert_trees_close(ts.aux["queue"]["sum"],
                            js.aux["queue"]["sum"], RUN_TOL)
    one_example = 1.0 / 60
    assert abs(th.final_accuracy() - jh.final_accuracy()) <= one_example
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-4)


@pytest.mark.parametrize("algo,md", [("ama_fes", 0), ("async_ama", 3)])
def test_chunked_equals_per_round_bitwise(world, algo, md):
    train, test, part, _ = world
    fl = TFL(**_fl_kw(algo, md))
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
    assert sims[True].t == 5 and len(hists[True].test_acc) == 2


def test_unported_options_are_refused():
    """The partitioned and fes_static client planes build a round step
    (tests/test_torch_client_plane.py holds what they compute); an
    unknown client plane raises ValueError, as in the JAX package. The
    refusals that remain still raise: an unknown client_reduce, the
    JAX-only Pallas interpreter plane, an unknown algorithm and a model
    family the port does not know (every family of the JAX package is
    ported; client_reduce="force", use_kernel and extended_metrics are
    ported: tests/test_torch_legacy.py)."""
    model = tbuild(TARCHS["paper-cnn"])
    assert callable(make_round_step(model, TFL(client_plane="partitioned")))
    assert callable(make_round_step(model, TFL(fes_static=True)))
    with pytest.raises(ValueError, match="client_plane"):
        make_round_step(model, TFL(client_plane="bogus"))
    with pytest.raises(ValueError, match="client_reduce"):
        make_round_step(model, TFL(client_reduce="bogus"))
    with pytest.raises(ValueError, match="interpret"):
        tstrategies.resolve(TFL(server_plane="interpret"))
    with pytest.raises(KeyError):
        tstrategies.resolve(TFL(algorithm="scaffold"))
    with pytest.raises(NotImplementedError, match="bogus"):
        tbuild(TARCHS["minitron-8b"].with_(family="bogus"))
