"""The port's million-client data plane against the JAX package's: the
dirichlet and iid partitioners, ``batch_iterator``, the streamed
``VirtualClientShards`` staging, the engine over streamed shards
(bitwise the same engine over a dense client list built from the same
shard views), and the launcher's ``--scenario`` / ``--trace-path`` /
``--population`` flags, with the regression of a dense data plane
built under a virtual schedule above 65,536 clients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import env as jenv
from repro.configs.base import FLConfig as JFL
from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.data.synth import make_image_classification
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data import partition as tpart
from repro_torch.data import pipeline as tpipe
from repro_torch.env.base import FixedTierProfile, VirtualTierProfile
from repro_torch.launch import train
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten


@pytest.fixture(scope="module")
def small_world():
    train_data, test = make_image_classification(n_train=240, n_test=60,
                                                 seed=0)
    return tbuild(TARCHS["paper-cnn"]), train_data, test


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small CNN rounds: one intra-op thread keeps them quick in a busy
    # multi-worker test run and the results independent of the host
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,alpha", [(10, 0.5), (7, 0.1), (50, 5.0)])
def test_dirichlet_and_iid_partitions_bitwise(K, alpha):
    labels = np.random.RandomState(2).randint(0, 10, 600)
    for j, t in zip(jpart.dirichlet_partition(labels, K, alpha, seed=3),
                    tpart.dirichlet_partition(labels, K, alpha, seed=3),
                    strict=True):
        assert j.dtype == t.dtype == np.int64
        np.testing.assert_array_equal(j, t)
    got = tpart.iid_partition(600, K, seed=5)
    for j, t in zip(jpart.iid_partition(600, K, seed=5), got, strict=True):
        np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                  np.arange(600))


def test_batch_iterator_and_sample_steps_bitwise(small_world):
    _, data, _ = small_world
    ji, ti = jpipe.batch_iterator(data, 32, seed=4), tpipe.batch_iterator(
        data, 32, seed=4)
    for _ in range(9):                       # past the first epoch's end
        a, b = next(ji), next(ti)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    idx = np.arange(3, 40, 2)
    a = jpipe.ClientDataset(data, idx).sample_steps(
        np.random.RandomState(1), 3, 8)
    b = tpipe.ClientDataset(data, idx).sample_steps(
        np.random.RandomState(1), 3, 8)
    assert b["image"].shape == (3, 8, 28, 28, 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("K,shard", [(20, 24), (1_000, 32),
                                     (1_000_000, 32), (7, None)])
def test_virtual_shards_and_staging_bitwise(small_world, K, shard):
    _, data, _ = small_world
    js = jpipe.VirtualClientShards(data, K, shard_size=shard, seed=2)
    ts = tpipe.VirtualClientShards(data, K, shard_size=shard, seed=2)
    assert len(ts) == K and ts.min_size == js.min_size > 0
    np.testing.assert_array_equal(js.order, ts.order)
    ids = np.array([0, 5, K - 1, K // 2])
    for i in ids:
        np.testing.assert_array_equal(js.shard_indices(i),
                                      ts.shard_indices(i))
    np.testing.assert_array_equal(js.client_sizes(ids.reshape(2, 2)),
                                  ts.client_sizes(ids.reshape(2, 2)))
    sel = np.stack([ids, ids[::-1]]).astype(np.int32)
    a = jpipe.stage_chunk(data, js, sel, 2, 6, 2, 16)
    b = tpipe.stage_chunk(data, ts, sel, 2, 6, 2, 16)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    # a dense list over the same shard views stages the same batches
    dense = {int(i): tpipe.ClientDataset(data, ts.shard_indices(i))
             for i in ids}
    for t in (6, 7):
        np.testing.assert_array_equal(
            tpipe.stage_round_indices(ts, sel[t - 6], 2, t, 2, 16),
            tpipe.stage_round_indices(dense, sel[t - 6], 2, t, 2, 16))


def _fl(**kw):
    base = dict(num_clients=20, clients_per_round=5, local_epochs=1,
                local_batch_size=10, lr=0.1, p_limited=0.25, seed=0)
    base.update(kw)
    return TFL(**base)


def _states(sim):
    return flatten({"p": sim.params, "a": sim.aux})


@pytest.mark.parametrize("use_scan", [True, False])
@pytest.mark.parametrize("algo,env,md", [("ama_fes", "bernoulli", 0),
                                         ("async_ama", "gilbert_elliott", 4),
                                         ("fedopt", "bernoulli", 0)])
def test_streamed_engine_bitwise_dense_list(small_world, algo, env, md,
                                            use_scan):
    """The whole engine over VirtualClientShards == over a dense
    ClientDataset list built from its shard views: params, aux, losses
    and accuracies, chunked and per round."""
    model, data, test = small_world
    fl = _fl(algorithm=algo, env=env, max_delay=md,
             p_delay=0.4 if md else 0.0, population="virtual")
    shards = tpipe.VirtualClientShards(data, 20, shard_size=24, seed=0)
    dense = [tpipe.ClientDataset(data, shards.shard_indices(i))
             for i in range(20)]
    sims = {k: TSim(model, fl, c, test, use_scan=use_scan, device="cpu")
            for k, c in (("streamed", shards), ("dense", dense))}
    assert sims["streamed"].env.virtual
    hists = {k: s.run(rounds=4, eval_every=2) for k, s in sims.items()}
    a, b = _states(sims["streamed"]), _states(sims["dense"])
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), k
    assert hists["streamed"].train_loss == hists["dense"].train_loss
    assert hists["streamed"].test_acc == hists["dense"].test_acc


def _k_long(obj, K, seen=None, path="sim"):
    """Paths of containers at least K long reachable through the
    attributes of ``obj`` (numpy arrays, tensors, lists, sets, dicts)."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float)):
        return []
    seen.add(id(obj))
    hits = []
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return [path] if obj.ndim and max(obj.shape) >= K else []
    if isinstance(obj, (list, tuple, set, dict)):
        if len(obj) >= K:
            return [path]
        items = obj.items() if isinstance(obj, dict) else enumerate(obj)
        for k, v in items:
            hits += _k_long(v, K, seen, f"{path}[{k!r}]")
        return hits
    if hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "repro_torch"):
        for k, v in vars(obj).items():
            hits += _k_long(v, K, seen, f"{path}.{k}")
    return hits


def test_virtual_engine_at_a_million_clients_holds_nothing_k_long(
        small_world):
    model, data, test = small_world
    K = 1_000_000
    kw = dict(num_clients=K, clients_per_round=8, local_epochs=1,
              local_batch_size=10, lr=0.1, p_limited=0.25, seed=0,
              env="gilbert_elliott", max_delay=6, algorithm="async_ama")
    fl = TFL(**kw)
    shards = tpipe.VirtualClientShards(data, K, shard_size=32, seed=0)
    sim = TSim(model, fl, shards, test, device="cpu")
    assert sim.env.virtual and isinstance(sim.env.devices,
                                          VirtualTierProfile)
    sim.run(rounds=3, eval_every=3)
    assert sim.t == 3
    sb = sim.env.batch(0, 3)
    jb = jenv.resolve(JFL(**kw), data_sizes=jpipe.VirtualClientShards(
        data, K, shard_size=32, seed=0).client_sizes).batch(0, 3)
    for k in jb:
        np.testing.assert_array_equal(jb[k], sb[k])
    assert _k_long(sim, K) == []


def _run(argv):
    return train.main(["--device", "cpu", "--n-train", "400",
                       "--eval-every", "1", *argv])


def test_scenario_and_population_flags_set_the_config(tmp_path):
    ap = train.parser()
    fl = train.fl_config(ap.parse_args(
        ["--scenario", "bursty-severe", "--max-delay", "3",
         "--env", "bandwidth", "--population", "dense"]))
    # the scenario applies after the other flags
    assert (fl.env, fl.max_delay, fl.ge_p_gb, fl.ge_p_bg) == (
        "gilbert_elliott", 15, 0.35, 0.25)
    assert fl.population == "dense"
    fl = train.fl_config(ap.parse_args(["--scenario", "mobility-trace"]))
    assert (fl.env, fl.trace_path, fl.max_delay) == ("trace", "", 10)
    fl = train.fl_config(ap.parse_args(
        ["--scenario", "mobility-trace", "--trace-path", "rec.npz"]))
    assert fl.trace_path == "rec.npz"        # an explicit path wins
    fl = train.fl_config(ap.parse_args(["--env", "trace", "--trace-path",
                                        "x.npz", "--max-delay", "4"]))
    assert (fl.env, fl.trace_path, fl.population) == ("trace", "x.npz",
                                                      "auto")
    with pytest.raises(SystemExit):
        ap.parse_args(["--scenario", "bogus"])
    with pytest.raises(SystemExit):
        ap.parse_args(["--population", "sparse"])


def test_launcher_replays_a_jax_trace_under_a_scenario(tmp_path, capsys):
    """--scenario mobility-trace --trace-path: the recorded rounds (a JAX
    save_trace of its bursty schedule) drive the run, on both scales."""
    jfl = jenv.scenarios.apply(JFL(num_clients=20, clients_per_round=5,
                                   seed=0, p_limited=0.25), "bursty")
    rec = jenv.resolve(jfl).batch(0, 8)
    path = str(tmp_path / "rec.npz")
    jenv.save_trace(path, rec)
    sim, hist = _run(["--scenario", "mobility-trace", "--trace-path", path,
                      "--algorithm", "async_ama", "--rounds", "3"])
    assert sim.fl.env == "trace" and sim.fl.trace_path == path
    np.testing.assert_array_equal(sim.env.batch(0, 8)["delays"],
                                  rec["delays"])
    assert sim.t == 3 and len(hist.test_acc) == 3
    assert "env trace, population dense of 20" in capsys.readouterr().out
    state, metrics, _ = _run(["--pod", "--arch", "minitron-8b", "--reduced",
                              "--rounds", "2", "--seq", "16",
                              "--scenario", "bursty-severe"])
    assert int(state["t"]) == 2 and metrics["loss"].shape == (2,)
    assert np.isfinite(metrics["loss"]).all()


@pytest.mark.parametrize("K,C", [(70_000, 5), (1_000_000, 32)])
def test_launcher_above_the_virtual_threshold_streams_its_shards(K, C,
                                                                 capsys):
    """Regression: above 65,536 clients the schedule turns virtual, and
    the data plane must too. The launcher once built K ClientDatasets
    from the 400-sample store there (the smallest shard empty) and the
    engine looped over all K twice; now every client is a non-empty
    arithmetic shard view and nothing reachable from the run is K long."""
    sim, hist = _run(["--clients", str(K), "--clients-per-round", str(C),
                      "--population", "auto", "--algorithm", "ama_fes",
                      "--rounds", "2"])
    assert isinstance(sim.clients, tpipe.VirtualClientShards)
    assert sim.env.virtual and sim.clients.min_size == 25
    assert isinstance(sim.env.devices, VirtualTierProfile)
    sel = sim.env.batch(0, 2)["selected"]
    assert sel.shape == (2, C) and sel.max() < K
    staged = tpipe.stage_round_indices(sim.clients, sel[0], 0, 0, 2, 25)
    assert staged.shape == (C, 2, 25)
    assert all(len(sim.clients.shard_indices(i)) == 25 for i in sel[0])
    assert _k_long(sim, K) == []
    assert sim.t == 2 and np.isfinite(hist.train_loss).all()
    assert f"population virtual of {K}" in capsys.readouterr().out


def test_population_dense_keeps_the_dense_data_plane():
    sim, _ = _run(["--clients", "20", "--population", "dense",
                   "--rounds", "1"])
    assert isinstance(sim.clients, list) and not sim.env.virtual
    assert isinstance(sim.env.devices, FixedTierProfile)
    sim, _ = _run(["--clients", "20", "--clients-per-round", "5",
                   "--population", "virtual", "--rounds", "1"])
    assert isinstance(sim.clients, tpipe.VirtualClientShards)
    assert sim.env.virtual and sim.clients.min_size == 25
