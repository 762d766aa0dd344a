"""Round-state checkpoints and the chunk prefetcher of the port.

A checkpoint crosses between the packages in both directions (the same
flat-key npz layout), save -> restore -> continue is bitwise equal to an
uninterrupted run, and the prefetch depth changes nothing in the
results. Params start in JAX or from the port's seed and cross through
``params_from_numpy``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.checkpoint import io as jio
from repro.configs.base import FLConfig as JFL
from repro.configs.registry import ARCHS as JARCHS
from repro.core.round import init_state as jinit_state
from repro.core.simulation import FederatedSimulation as JSim
from repro.data.partition import shard_partition
from repro.data.pipeline import build_clients
from repro.data.synth import make_image_classification
from repro.models.api import build_model as jbuild
from repro_torch.checkpoint import io as tio
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.pipeline import ChunkPrefetcher
from repro_torch.data.pipeline import build_clients as tbuild_clients
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten, params_from_numpy, params_to_numpy

# the port continuing a JAX checkpoint against JAX continuing it: five
# rounds of per-op differences (XLA and PyTorch order conv and matmul
# sums differently), as tests/test_torch_round.py holds ten rounds
RUN_TOL = dict(rtol=1e-4, atol=1e-5)
# fedopt's server Adam amplifies a difference in a small pseudo-gradient
# by up to lr / tau = 100 (tests/test_torch_strategies_ext.py)
FEDOPT_RUN_TOL = dict(rtol=2e-2, atol=2e-2)
CASES = [("ama_fes", 0, "none"), ("async_ama", 3, "none"),
         ("fedopt", 0, "none")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on one machine; at these tiny
    shapes torch's intra-op thread pool in each worker would only
    oversubscribe the cores. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    train, test = make_image_classification(n_train=240, n_test=60, seed=0)
    part = shard_partition(train["label"], 8, seed=0)
    jp = jbuild(JARCHS["paper-cnn"]).init(jax.random.PRNGKey(0))
    return train, test, part, jax.tree.map(np.asarray, jp)


def _kw(algo, md, comm="none", **extra):
    return dict(num_clients=8, clients_per_round=4, local_epochs=1,
                local_batch_size=10, lr=0.1, p_limited=0.5, algorithm=algo,
                max_delay=md, p_delay=0.4 if md else 0.0, seed=0,
                comm_plane=comm, **extra)


def _tsim(world, fl):
    train, test, part, _ = world
    return TSim(tbuild(TARCHS["paper-cnn"]), fl, tbuild_clients(train, part),
                test, device="cpu")


def _state_leaves(sim):
    return flatten({"params": sim.params, "t": sim.state["t"],
                    "aux": sim.aux})


def _assert_states_equal(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("algo,md,comm", CASES)
def test_jax_checkpoint_resumes_in_the_port(world, tmp_path, algo, md, comm):
    """JAX runs 3 rounds and saves; JAX and the port each restore that
    file and run 3 more: params and aux within the run tolerance."""
    train, test, part, p0 = world
    kw = _kw(algo, md, comm)
    path = str(tmp_path / "jax_ck.npz")
    js = JSim(jbuild(JARCHS["paper-cnn"]), JFL(**kw),
              build_clients(train, part), test, donate=False, prefetch=False)
    js.run(rounds=3, eval_every=3)
    js.save(path)
    js.run(rounds=3, eval_every=3)
    ts = _tsim(world, TFL(**kw))
    ts.resume(path)
    assert ts.t == 3
    th = ts.run(rounds=3, eval_every=3)
    assert ts.t == 6 and th.eval_rounds == [6]
    tol = FEDOPT_RUN_TOL if algo == "fedopt" else RUN_TOL
    jflat = dict(flatten(jax.tree.map(np.asarray, {"params": js.params,
                                                   "aux": js.aux})))
    tflat = dict(flatten(params_to_numpy({"params": ts.params,
                                          "aux": ts.aux})))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **tol)
    if algo == "fedopt":
        assert int(ts.aux["step"]) == int(js.aux["step"]) == 6


@pytest.mark.parametrize("algo,md,comm", CASES + [("ama_fes", 0, "q8")])
def test_port_checkpoint_restores_in_jax(world, tmp_path, algo, md, comm):
    """A port-written npz restores through the JAX package's
    ``restore_state`` into its own template, value for value."""
    _, _, _, p0 = world
    kw = _kw(algo, md, comm)
    ts = _tsim(world, TFL(**kw))
    ts.state["params"] = params_from_numpy(p0)
    ts.run(rounds=3, eval_every=3)
    path = str(tmp_path / "port_ck.npz")
    ts.save(path)
    like = jinit_state(jbuild(JARCHS["paper-cnn"]), JFL(**kw),
                       jax.random.PRNGKey(1))
    got = jio.restore_state(path, like)
    assert int(got["t"]) == 3
    jflat = dict(flatten(jax.tree.map(np.asarray, got)))
    tflat = dict(flatten(params_to_numpy(ts.state)))
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert jflat[k].dtype == tflat[k].dtype, k
        np.testing.assert_array_equal(jflat[k], tflat[k], err_msg=k)


@pytest.mark.parametrize("algo,md,comm", CASES + [("ama_fes", 0, "q8")])
def test_save_restore_continue_is_bitwise(world, tmp_path, algo, md, comm):
    """6 rounds in one run == 3 rounds, save, restore into a fresh
    engine, 3 more: params, t and every aux leaf bit for bit, and the
    resumed run evaluates at the same absolute rounds."""
    fl = TFL(**_kw(algo, md, comm))
    whole = _tsim(world, fl)
    wh = whole.run(rounds=6, eval_every=3)
    first = _tsim(world, fl)
    first.run(rounds=3, eval_every=3)
    path = str(tmp_path / "ck")
    first.save(path)
    assert os.path.exists(path + ".npz")
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    second = _tsim(world, fl)
    second.resume(path)
    sh = second.run(rounds=3, eval_every=3)
    _assert_states_equal(whole, second)
    assert sh.eval_rounds == [6] and sh.test_acc == wh.test_acc[-1:]
    assert sh.train_loss == wh.train_loss[3:]


def test_resume_off_cadence_evaluates_at_absolute_rounds(world, tmp_path):
    """A run stopped at round 2 (eval_every 3) resumes into a partial
    chunk and still evaluates at rounds 3 and 6, bitwise as the
    uninterrupted run."""
    fl = TFL(**_kw("async_ama", 3))
    whole = _tsim(world, fl)
    wh = whole.run(rounds=6, eval_every=3)
    first = _tsim(world, fl)
    first.run(rounds=2, eval_every=3)
    first.save(str(tmp_path / "ck.npz"))
    second = _tsim(world, fl)
    second.resume(str(tmp_path / "ck.npz"))
    sh = second.run(rounds=4, eval_every=3)
    assert sh.eval_rounds == [3, 6] and sh.test_acc == wh.test_acc
    _assert_states_equal(whole, second)


def test_run_round_is_a_round_of_the_engine(world):
    fl = TFL(**_kw("fedopt", 0))
    a, b = _tsim(world, fl), _tsim(world, fl)
    losses = [a.run_round() for _ in range(3)]
    hist = b.run(rounds=3, eval_every=3)
    assert a.t == 3 and losses == hist.train_loss
    _assert_states_equal(a, b)


@pytest.mark.parametrize("algo,md", [("ama_fes", 0), ("async_ama", 3)])
def test_prefetch_depths_give_bitwise_equal_runs(world, algo, md):
    sims = []
    for depth in (0, 1, 2):
        sim = _tsim(world, TFL(**_kw(algo, md, prefetch_depth=depth)))
        sims.append((sim, sim.run(rounds=4, eval_every=2)))
    for sim, hist in sims[1:]:
        _assert_states_equal(sims[0][0], sim)
        assert hist.train_loss == sims[0][1].train_loss
        assert hist.test_acc == sims[0][1].test_acc


def test_prefetcher_holds_at_most_depth_chunks_and_keeps_order():
    import threading
    staged, gate = [], threading.Event()

    def fn(i):
        staged.append(i)
        return i * 10

    pf = ChunkPrefetcher(fn, list(range(8)), depth=2)
    # the worker stages ahead until the queue holds `depth` chunks and
    # it blocks on the next one: at most depth + 1 staged
    for _ in range(50):
        if len(staged) >= 3:
            break
        gate.wait(0.02)
    gate.wait(0.1)
    assert len(staged) <= 3
    assert list(pf) == [i * 10 for i in range(8)]
    assert staged == list(range(8))


def test_prefetcher_raises_a_staging_error_on_the_consumer_side():
    def fn(i):
        if i == 2:
            raise RuntimeError("staging failed at chunk 2")
        return i

    got = []
    with pytest.raises(RuntimeError, match="chunk 2"):
        for x in ChunkPrefetcher(fn, [0, 1, 2, 3], depth=1):
            got.append(x)
    assert got == [0, 1]


def test_engine_surfaces_a_staging_error(world):
    sim = _tsim(world, TFL(**_kw("ama_fes", 0, prefetch_depth=2)))
    real = sim.env.batch

    def batch(t0, n):
        if t0 >= 4:
            raise ValueError(f"no schedule for round {t0}")
        return real(t0, n)

    sim.env.batch = batch
    with pytest.raises(ValueError, match="round 4"):
        sim.run(rounds=6, eval_every=2)
    assert sim.t == 4           # the chunks staged before it ran


def test_checkpoint_layout_and_refusals(tmp_path):
    """The JAX package's layout: '/'-joined keys, t as a 0-dim int32,
    bf16 stored as f32 (and restored as bf16 by either package)."""
    state = {"params": {"w": torch.randn(3, 2).bfloat16(),
                        "b": {"c": torch.randn(4)}},
             "t": torch.tensor(7, dtype=torch.int32),
             "aux": {"queue": {"gamma": torch.rand(3)}}}
    path = str(tmp_path / "s.npz")
    tio.save_state(path, state)
    with np.load(path) as z:
        assert sorted(z.files) == ["aux/queue/gamma", "params/b/c",
                                   "params/w", "t"]
        assert z["params/w"].dtype == np.float32
        assert z["t"].dtype == np.int32 and z["t"].shape == ()
    back = tio.restore_state(path, state)
    for (k, x), (_, y) in zip(flatten(back), flatten(state)):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    jlike = {"params": {"w": jax.numpy.zeros((3, 2), jax.numpy.bfloat16),
                        "b": {"c": np.zeros(4, np.float32)}},
             "t": np.int32(0),
             "aux": {"queue": {"gamma": np.zeros(3, np.float32)}}}
    jback = jio.restore_state(path, jlike)
    assert jback["params"]["w"].dtype == jax.numpy.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jback["params"]["w"], np.float32),
        state["params"]["w"].float().numpy())
    with pytest.raises(ValueError, match="'/'"):
        tio.save(str(tmp_path / "bad"), {"a/b": torch.zeros(1)})
    tio.save(str(tmp_path / "p.npz"), {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="round-state"):
        tio.restore_state(str(tmp_path / "p.npz"), state)
    with pytest.raises(ValueError, match="missing"):
        tio.save_state(str(tmp_path / "q"), {"params": {}})
