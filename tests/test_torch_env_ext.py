"""The rest of the port's host plane against the JAX package's: the
Gilbert–Elliott channel, trace replay, the scenario registry, the device
profile's tier and step budget, the default virtual channel draw, and
async_ama under the bursty and mobility scenarios through both engines.

Every schedule must equal the JAX package's BITWISE, dense and virtual,
so both packages train on the same rounds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import env as jenv
from repro.configs.base import FLConfig as JFL
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import environment_names as jenv_names
from repro.configs.registry import scenario_names as jscenario_names
from repro.core.simulation import FederatedSimulation as JSim
from repro.data.partition import shard_partition
from repro.data.pipeline import build_clients
from repro.data.synth import make_image_classification
from repro.models.api import build_model as jbuild
from repro_torch import env as tenv
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import environment_names as tenv_names
from repro_torch.configs.registry import get_scenario
from repro_torch.configs.registry import scenario_names as tscenario_names
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.pipeline import build_clients as tbuild_clients
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten, params_from_numpy, params_to_numpy

# the engine tolerances of tests/test_torch_round.py: one round, and ten
# rounds of compounded per-op differences between XLA and PyTorch
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)

SCENARIOS = jenv.scenarios.names()
#: (population, K): the dense path at paper scale, the hashed virtual
#: one beyond it (trace replay stays dense there)
POPULATIONS = [("auto", 20), ("virtual", 100_000)]


def _assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _kw(K, population, **extra):
    return dict(num_clients=K, clients_per_round=5, p_limited=0.5, seed=3,
                population=population, rounds=12, **extra)


def test_registries_match():
    assert tenv.names() == jenv.names() == tenv_names() == jenv_names()
    assert tscenario_names() == jscenario_names() == SCENARIOS
    assert len(SCENARIOS) == 7
    for name in SCENARIOS:
        j, t = jenv.scenarios.get(name), get_scenario(name)
        assert (t.name, t.env, t.overrides, t.description) == (
            j.name, j.env, j.overrides, j.description)
        assert tenv.get(t.env).name == jenv.get(j.env).name
    assert tenv.scenarios.get("bursty-severe").overrides["max_delay"] == 15
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("bogus")
    with pytest.raises(KeyError, match="unknown environment"):
        tenv.get("bogus")


@pytest.mark.parametrize("population,K", POPULATIONS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_schedule_bitwise(scenario, population, K):
    jfl = jenv.scenarios.apply(JFL(**_kw(K, population)), scenario)
    tfl = tenv.scenarios.apply(TFL(**_kw(K, population)), scenario)
    assert dataclasses.asdict(jfl) == dataclasses.asdict(tfl)
    je, te = jenv.resolve(jfl), tenv.resolve(tfl)
    assert te.virtual == je.virtual == (population == "virtual"
                                        and scenario != "mobility-trace")
    a, b = je.batch(3, 9), te.batch(3, 9)
    _assert_dicts_equal(a, b)
    assert b["delays"].max() <= max(tfl.max_delay, 1)
    assert (b["delays"][~b["delayed"]] == 1).all()
    r = te.round(7)                        # batch row i == round(t0 + i)
    for k in a:
        np.testing.assert_array_equal(getattr(r, k), b[k][4], err_msg=k)


@pytest.mark.parametrize("population,K", POPULATIONS)
@pytest.mark.parametrize("knobs", [
    dict(max_delay=6), dict(max_delay=0),
    dict(max_delay=15, ge_p_gb=0.35, ge_p_bg=0.25, ge_p_delay_good=0.2)])
def test_gilbert_elliott_bitwise_and_pure_in_t(knobs, population, K):
    """Both forms (the (K,) trajectory and the per-client hashed chains)
    bitwise JAX's, with data sizes; a fresh environment's chunks, rounds
    queried backwards and the whole block agree (the memo is pure in t)."""
    kw = _kw(K, population, env="gilbert_elliott", **knobs)
    sizes = (np.arange(K, dtype=np.float32) + 1.0 if population == "auto"
             else (lambda sel: np.asarray(sel, np.float32) % 7 + 1))
    je = jenv.resolve(JFL(**kw), data_sizes=sizes)
    te = tenv.resolve(TFL(**kw), data_sizes=sizes)
    whole = te.batch(0, 10)
    _assert_dicts_equal(je.batch(0, 10), whole)
    fresh = tenv.resolve(TFL(**kw), data_sizes=sizes)
    parts = [fresh.batch(6, 4), fresh.batch(0, 6)]  # later chunk first
    for k in whole:
        np.testing.assert_array_equal(
            np.concatenate([parts[1][k], parts[0][k]]), whole[k])
    back = tenv.resolve(TFL(**kw), data_sizes=sizes)
    for t in reversed(range(10)):
        r = back.round(t)
        np.testing.assert_array_equal(r.delays, whole["delays"][t])
        np.testing.assert_array_equal(r.selected, whole["selected"][t])
    if knobs["max_delay"]:
        assert whole["delayed"].any()
        # a Bad link draws from the upper half of 1..max_delay
        assert whole["delays"].max() > knobs["max_delay"] // 2
    else:
        assert not whole["delayed"].any()


def test_gilbert_elliott_virtual_keeps_no_population_state():
    kw = _kw(1_000_000, "auto", env="gilbert_elliott", max_delay=10)
    te = tenv.resolve(TFL(**kw))
    assert te.virtual
    _assert_dicts_equal(jenv.resolve(JFL(**kw)).batch(0, 20),
                        te.batch(0, 20))
    assert te.channel._bad == []                    # no (K,) trajectory
    assert len(te.channel._vmemo) <= 20 * 5         # one entry a client


@pytest.mark.parametrize("population,K", POPULATIONS)
def test_synthesised_trace_bitwise(population, K):
    kw = _kw(K, population, env="trace", max_delay=10)
    jt = jenv.synth_mobility_trace(JFL(**kw), rounds=16)
    tt = tenv.synth_mobility_trace(TFL(**kw), rounds=16)
    _assert_dicts_equal(jt, tt)
    te = tenv.resolve(TFL(**kw))
    assert not te.virtual and not type(te).supports_virtual
    assert len(te._trace["selected"]) == 64           # max(rounds, 64)
    # the trace loops modulo its length
    _assert_dicts_equal(jenv.resolve(JFL(**kw)).batch(60, 8),
                        te.batch(60, 8))
    np.testing.assert_array_equal(te.round(64 + 5).selected,
                                  te.round(5).selected)


def test_jax_written_trace_replays_unchanged(tmp_path):
    """A recording of the JAX package's bursty schedule, written by its
    save_trace (with and without data sizes), replays in the port as in
    the JAX package; the launcher's data sizes win over the trace's."""
    rec = jenv.resolve(JFL(**_kw(20, "auto", env="gilbert_elliott",
                                 max_delay=10))).batch(0, 12)
    kw = _kw(20, "auto", env="trace", max_delay=10)
    for with_sizes in (True, False):
        path = str(tmp_path / f"rec{with_sizes}.npz")
        trace = dict(rec) if with_sizes else {
            k: rec[k] for k in ("selected", "limited", "delayed", "delays")}
        jenv.save_trace(path, trace)
        jfl, tfl = JFL(trace_path=path, **kw), TFL(trace_path=path, **kw)
        b = tenv.resolve(tfl).batch(0, 12)
        _assert_dicts_equal(jenv.resolve(jfl).batch(0, 12), b)
        for k in ("selected", "limited", "delayed", "delays"):
            np.testing.assert_array_equal(b[k], rec[k])
        np.testing.assert_array_equal(
            b["data_sizes"], rec["data_sizes"] if with_sizes
            else np.ones((12, 5), np.float32))
        sizes = np.arange(20, dtype=np.float32) + 2
        _assert_dicts_equal(jenv.resolve(jfl, sizes).batch(5, 14),
                            tenv.resolve(tfl, sizes).batch(5, 14))
    # and the port's own save_trace writes what the JAX package replays
    path = str(tmp_path / "port.npz")
    tenv.save_trace(path, tenv.resolve(TFL(**_kw(
        20, "auto", env="bandwidth", max_delay=10))).batch(0, 6))
    _assert_dicts_equal(
        jenv.resolve(JFL(trace_path=path, **kw)).batch(0, 6),
        tenv.resolve(TFL(trace_path=path, **kw)).batch(0, 6))


def _bad_trace(case):
    T, m = 6, 5
    rng = np.random.RandomState(0)
    tr = {"selected": np.stack([rng.choice(20, m, replace=False)
                                for _ in range(T)]).astype(np.int32),
          "limited": np.zeros((T, m), bool),
          "delayed": np.zeros((T, m), bool),
          "delays": np.ones((T, m), np.int32)}
    if case == "width":
        tr = {k: v[:, :4] for k, v in tr.items()}
    elif case == "client":
        tr["selected"][2, 1] = 20
    elif case == "shape":
        tr["limited"] = tr["limited"][:, :3]
    elif case == "too_late":
        tr["delayed"][1, 0], tr["delays"][1, 0] = True, 11
    elif case == "on_time_delay":
        tr["delays"][3, 2] = 2
    return tr


@pytest.mark.parametrize("case", ["width", "client", "shape", "too_late",
                                  "on_time_delay"])
def test_trace_refusals(tmp_path, case):
    path = str(tmp_path / "t.npz")
    np.savez(path, **_bad_trace(case))
    kw = _kw(20, "auto", env="trace", max_delay=10, trace_path=path)
    with pytest.raises(AssertionError):
        jenv.resolve(JFL(**kw))
    with pytest.raises(AssertionError):
        tenv.resolve(TFL(**kw))


def test_save_trace_refuses_missing_arrays(tmp_path):
    with pytest.raises(AssertionError, match="missing"):
        tenv.save_trace(str(tmp_path / "x.npz"),
                        {"selected": np.zeros((2, 5), np.int32)})


@pytest.mark.parametrize("population,K", POPULATIONS)
def test_tier_step_budget_and_sizes(population, K):
    kw = dict(num_clients=K, clients_per_round=5, p_limited=0.4, seed=1,
              population=population, fedprox_partial=0.3)
    jfl, tfl = JFL(**kw), TFL(**kw)
    sel = np.array([0, 3, 7, 11, 19, 4, 8], np.int32)
    jd, td = jenv.resolve(jfl).devices, tenv.resolve(tfl).devices
    assert type(td).__name__ == ("VirtualTierProfile" if population ==
                                 "virtual" else "FixedTierProfile")
    for fn in ("limited", "tier"):
        np.testing.assert_array_equal(getattr(jd, fn)(sel),
                                      getattr(td, fn)(sel))
    for n_steps in (1, 4, 10):
        a, b = jd.step_budget(n_steps, sel), td.step_budget(n_steps, sel)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert set(b.tolist()) <= {n_steps, max(1, int(n_steps * 0.3))}
    np.testing.assert_array_equal(td.tier(sel), np.where(td.limited(sel),
                                                         0, 1))
    assert not td.has_sizes
    block = np.array([[1, 2, 3], [4, 5, 6]])
    if population == "virtual":               # shape-generic on a block
        np.testing.assert_array_equal(jd.step_budget(6, block),
                                      td.step_budget(6, block))
    pop_j = jenv.VirtualPopulation(jfl, sizes_fn=lambda s: s * 0.5 + 1)
    pop_t = tenv.VirtualPopulation(tfl, sizes_fn=lambda s: s * 0.5 + 1)
    for fn in ("limited", "tier", "sizes"):
        np.testing.assert_array_equal(getattr(pop_j, fn)(block),
                                      getattr(pop_t, fn)(block))
    np.testing.assert_array_equal(pop_j.select_batch(4, 3),
                                  pop_t.select_batch(4, 3))
    np.testing.assert_array_equal(
        tenv.VirtualPopulation(tfl).sizes(block), np.ones((2, 3)))
    # a callable data_sizes never becomes a (K,) array
    te = tenv.resolve(tfl, data_sizes=lambda s: np.full(np.shape(s), 9.0))
    assert te.devices.has_sizes and te.devices._sizes is None
    np.testing.assert_array_equal(te.batch(0, 2)["data_sizes"],
                                  np.full((2, 5), 9.0, np.float32))


def test_side_rng_and_default_virtual_draw_batch():
    """``side_rng`` is JAX's stream; a channel that only defines ``draw``
    gets the default virtual block draw: one draw per row on a fresh
    round stream, bitwise the JAX package's."""
    fl_kw = dict(num_clients=100_000, clients_per_round=5, seed=4,
                 max_delay=5, population="virtual")
    for t in (-7, 0, 9):
        np.testing.assert_array_equal(
            jenv.side_rng(JFL(**fl_kw), t).rand(4),
            tenv.side_rng(TFL(**fl_kw), t).rand(4))

    def channel(base):
        class Coin(base):
            def draw(self, t, selected, rng):
                delayed = rng.rand(len(selected)) < 0.5
                delays = np.where(delayed, rng.randint(
                    1, self.fl.max_delay + 1, len(selected)), 1)
                return delayed, delays.astype(np.int32)
        return Coin

    sel = np.arange(15, dtype=np.int32).reshape(3, 5) * 7
    a = channel(jenv.ChannelModel)(JFL(**fl_kw)).draw_batch(6, sel)
    b = channel(tenv.ChannelModel)(TFL(**fl_kw)).draw_batch(6, sel)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert b[0].shape == (3, 5)
    # row i is round t0 + i on its own stream
    one = channel(tenv.ChannelModel)(TFL(**fl_kw)).draw_batch(7, sel[1:2])
    np.testing.assert_array_equal(one[1][0], b[1][1])


# ------------------------------- async_ama under the scenarios, both engines

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


@pytest.mark.parametrize("scenario", ["bursty-severe", "mobility-trace"])
def test_async_ama_under_scenario_matches_jax(world, scenario):
    """One round (run_round) at ROUND_TOL, then nine more in chunks of 5
    at RUN_TOL: params, the async ring buffer (Q = max_delay + 1 slots,
    16 under bursty-severe) and the losses, against JAX's engine."""
    train, test, part, p0 = world
    kw = dict(num_clients=8, clients_per_round=4, local_epochs=1,
              local_batch_size=10, lr=0.1, p_limited=0.5,
              algorithm="async_ama", seed=0)
    jfl = jenv.scenarios.apply(JFL(**kw), scenario)
    tfl = get_scenario(scenario).apply(TFL(**kw))
    js = JSim(jbuild(JARCHS["paper-cnn"]), jfl, build_clients(train, part),
              test, donate=False, prefetch=False)
    ts = TSim(tbuild(TARCHS["paper-cnn"]), tfl, tbuild_clients(train, part),
              test, device="cpu")
    ts.state["params"] = params_from_numpy(p0)
    _assert_dicts_equal(js.env.batch(0, 10), ts.env.batch(0, 10))
    if scenario == "bursty-severe":
        assert tfl.max_delay == 15 and ts.aux["queue"]["gamma"].shape[0] == 16
        assert ts.env.batch(0, 10)["delayed"].any()
    jl, tl = js.run_round(), ts.run_round()
    assert ts.t == js.t == 1
    _assert_trees_close(ts.params, js.params, ROUND_TOL)
    _assert_trees_close(ts.aux["queue"]["sum"], js.aux["queue"]["sum"],
                        ROUND_TOL)
    np.testing.assert_allclose(tl, jl, **ROUND_TOL)
    jh, th = js.run(rounds=9, eval_every=5), ts.run(rounds=9, eval_every=5)
    assert ts.t == 10 and th.eval_rounds == jh.eval_rounds == [5, 10]
    _assert_trees_close(ts.params, js.params, RUN_TOL)
    _assert_trees_close(ts.aux["queue"]["sum"], js.aux["queue"]["sum"],
                        RUN_TOL)
    np.testing.assert_allclose(ts.aux["queue"]["gamma"].numpy(),
                               np.asarray(js.aux["queue"]["gamma"]),
                               **RUN_TOL)
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-4)
