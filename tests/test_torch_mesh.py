"""The sharded client axis (``launch/mesh.py: engine_mesh``,
``sharding/ctx.py``) on the CPU: W gloo ranks over a ``file://`` store,
one spawn per world size running all of its cases.

  * the client-width rule equals the JAX package's ``engine_mesh`` at
    every (W, C) of W in {1, 2, 3, 4, 8}, C in 1..8;
  * ``client_reduce="off"`` at W = 2 is bitwise the one-process run: the
    paper CNN under ama, ama_fes, async_ama, fedavg, fedprox, fedopt and
    ama on the legacy server plane, and the reduced minitron-8b pod path
    chunked and per round;
  * ``"auto"`` at W = 2 (the pre-reduced axis, a rank-ordered sum) is
    within the port's tolerance for the pre-reduced axis of the JAX
    package's own sharded run (``FederatedSimulation(..., mesh=
    engine_mesh(4))`` on 2 forced host devices, its psum path), with the
    paper's accuracy within one test example, and bitwise run to run;
  * every rank holds the same state; W = 3 at C = 4 (client 1, dsub 3:
    replicas) is bitwise W = 1; a checkpoint written at W = 2 resumes at
    W = 1 and at W = 2 and continues bitwise;
  * the options without a sharded form are refused at client width > 1.

JAX runs only in a subprocess (its device count is fixed when it first
starts); the ranks and the one-process references run on one intra-op
thread each (the CNN's grouped convolution splits its sums by the
thread count).
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint.io import restore_state, save
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.partition import shard_partition
from repro_torch.data.pipeline import (VirtualClientShards, build_clients,
                                      stage_chunk)
from repro_torch.data.synth import make_image_classification
from repro_torch.exec.engine import ChunkRunner
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import FLMesh, client_width, engine_mesh
from repro_torch.models.api import build_model as tbuild
from repro_torch.obs.log import MetricsLogger
from repro_torch.sharding import ctx
from repro_torch.utils.tree import flatten, params_from_numpy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the port's tolerance for the pre-reduced axis against the fused plane
# (tests/test_torch_legacy.py::test_client_reduce_force_runs_close_to_
# fused); fedopt's server Adam amplifies a last-bit difference in a small
# pseudo-gradient by up to lr / tau = 100
AUTO_TOL = dict(rtol=5e-4, atol=1e-5)
FEDOPT_RUN_TOL = dict(rtol=2e-2, atol=2e-2)
ROUNDS = 3
#: name: (algorithm, max_delay, extra FLConfig fields)
CNN = {"ama": ("ama", 0, {}), "ama_fes": ("ama_fes", 0, {}),
       "async_ama": ("async_ama", 2, {}), "fedavg": ("fedavg", 0, {}),
       "fedprox": ("fedprox", 0, {}), "fedopt": ("fedopt", 0, {}),
       "legacy": ("ama", 0, {"server_plane": "legacy"})}
AUTO = [k for k in CNN if k != "legacy"]
#: the reduced minitron-8b pod path: C 4 gives each of 2 ranks 2 cohorts;
#: C 2 (one cohort a rank) is held at bf16 rounding, not bitwise (see
#: test_one_cohort_a_rank_pod_path_agrees_within_bf16_rounding)
POD = {"pod_scan": ["--cohorts", "4"],
       "pod_no_scan": ["--cohorts", "4", "--no-scan"],
       "pod_c2": ["--cohorts", "2"]}
POD_BITWISE = ["pod_scan", "pod_no_scan"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world():
    train, test = make_image_classification(n_train=240, n_test=60, seed=0)
    return train, test, shard_partition(train["label"], 8, seed=0)


def _fl(name, mode, **kw):
    algo, md, extra = CNN[name]
    return TFL(num_clients=8, clients_per_round=4, local_epochs=1,
               local_batch_size=10, lr=0.1, p_limited=0.5, algorithm=algo,
               max_delay=md, p_delay=0.4 if md else 0.0, seed=0,
               client_reduce=mode, **extra, **kw)


def _cnn_sim(name, mode, p0, mesh=None, logger=None, **kw):
    train, test, part = _world()
    sim = TSim(tbuild(TARCHS["paper-cnn"]), _fl(name, mode, **kw),
               build_clients(train, part), test, device="cpu", mesh=mesh,
               logger=logger)
    sim.state["params"] = params_from_numpy(p0)
    return sim


def _pod_argv(name, mode):
    return ["--arch", "minitron-8b", "--pod", "--reduced", "--rounds", "2",
            "--device", "cpu", "--client-reduce", mode, *POD[name]]


def _pod(argv):
    args = tlaunch.parser().parse_args(argv)
    return tlaunch.pod_scale(args, tlaunch.fl_config(args),
                             torch.device("cpu"))


def _dump(path, state, extra):
    save(path, state)
    with open(path + ".json", "w") as f:
        json.dump(extra, f)


def _rank_cases(rank, out, p0, cases):
    """Run ``cases`` on this rank; each writes its final state and
    losses to ``{out}/{case}_r{rank}.npz`` (+ ``.json``)."""
    for case in cases:
        kind, name, label = case
        mode = label.rstrip("2")         # "auto2": the run-to-run repeat
        tag = f"{out}/{kind}-{name}-{label}_r{rank}"
        if kind == "cnn":
            mesh = engine_mesh(4, "cpu")
            logger = MetricsLogger(None)
            sim = _cnn_sim(name, mode, p0, mesh, logger)
            hist = sim.run(rounds=ROUNDS, eval_every=ROUNDS)
            _dump(tag + ".npz", sim.state,
                  {"loss": hist.train_loss, "acc": hist.test_acc,
                   "mesh": [mesh.client, mesh.dsub, mesh.backend],
                   "header": logger.rows[0] if logger.rows else None,
                   "collective": sim.timer.summary().get("collective")})
        elif kind == "metrics":
            logger = MetricsLogger(None)
            sim = _cnn_sim(name, mode, p0, engine_mesh(4, "cpu"), logger,
                           extended_metrics=True)
            sim.run(rounds=ROUNDS, eval_every=ROUNDS)
            with open(tag + ".json", "w") as f:
                json.dump([r for r in logger.rows if r["kind"] == "round"],
                          f)
        elif kind == "pod":
            state, metrics, _ = _pod(_pod_argv(name, mode))
            _dump(tag + ".npz", state, {"loss": metrics["loss"].tolist()})
        elif kind == "ckpt":
            mesh = engine_mesh(4, "cpu")
            sim = _cnn_sim(name, mode, p0, mesh)
            sim.run(rounds=2, eval_every=2)
            sim.save(f"{out}/ck.npz")
            sim = _cnn_sim(name, mode, p0, mesh)
            sim.resume(f"{out}/ck.npz")
            hist = sim.run(rounds=2, eval_every=2)
            _dump(tag + ".npz", sim.state, {"loss": hist.train_loss})
        elif kind == "shard_sum":
            mesh = engine_mesh(4, "cpu")
            g = torch.Generator().manual_seed(mesh.shard)   # replicas
            x = torch.randn((3, 1001), generator=g)
            with ctx.use(mesh):
                got = ctx.sum_shards(x)
                parts = ctx.gather_leading(x[None])     # (client, ...)
            want = parts[0].clone()
            for s in range(1, mesh.client):
                want += parts[s]
            with open(tag + ".json", "w") as f:
                json.dump({"equal": bool(torch.equal(got, want))}, f)


def _rank_main(rank, world, store, out, p0_path, cases):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with np.load(p0_path) as z:
            p0 = _unflat({k: z[k] for k in z.files})
        _rank_cases(rank, out, p0, cases)
    finally:
        dist.destroy_process_group()


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _spawn(world, tmp, p0_path, cases, timeout=600):
    out = os.path.join(tmp, f"w{world}")
    os.makedirs(out, exist_ok=True)
    pc = mp.start_processes(_rank_main,
                            args=(world, os.path.join(out, "store"), out,
                                  p0_path, cases),
                            nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not pc.join(timeout=5):
        if time.monotonic() > deadline:
            for p in pc.processes:
                p.kill()
            raise TimeoutError(f"W = {world} ranks still running")
    return out


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs.base import FLConfig
    from repro.configs.registry import ARCHS
    from repro.core.simulation import FederatedSimulation
    from repro.data.partition import shard_partition
    from repro.data.pipeline import build_clients
    from repro.data.synth import make_image_classification
    from repro.launch import mesh as jm
    from repro.models.api import build_model
    out, cases = sys.argv[1], json.loads(sys.argv[2])
    devs = jax.devices()
    rule = {}
    for W in (1, 2, 3, 4, 8):
        jm.jax.devices = lambda W=W: devs[:W]
        for C in range(1, 9):
            m = jm.engine_mesh(C)
            rule[f"{W},{C}"] = [m.shape["client"], m.shape["dsub"]]
    jm.jax.devices = lambda: devs[:2]
    train, test = make_image_classification(n_train=240, n_test=60, seed=0)
    part = shard_partition(train["label"], 8, seed=0)
    res = {"rule": rule, "acc": {}, "mesh": {}}
    for name, (algo, md, extra) in cases.items():
        fl = FLConfig(num_clients=8, clients_per_round=4, local_epochs=1,
                      local_batch_size=10, lr=0.1, p_limited=0.5,
                      algorithm=algo, max_delay=md,
                      p_delay=0.4 if md else 0.0, seed=0, **extra)
        mesh = jm.engine_mesh(4)
        sim = FederatedSimulation(build_model(ARCHS["paper-cnn"]), fl,
                                  build_clients(train, part), test,
                                  donate=False, prefetch=False, mesh=mesh)
        hist = sim.run(rounds=%d, eval_every=%d)
        sim.save(os.path.join(out, f"jax-{name}.npz"))
        res["acc"][name] = hist.test_acc
        res["mesh"][name] = dict(mesh.shape)
    with open(os.path.join(out, "jax.json"), "w") as f:
        json.dump(res, f)
""" % (ROUNDS, ROUNDS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: the JAX subprocess (started first, read
    last), the W = 2 and W = 3 spawns, and the one-process references."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    jax_cases = {k: CNN[k] for k in AUTO}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, tmp, json.dumps(jax_cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        import jax

        from repro.configs.registry import ARCHS as JARCHS
        from repro.models.api import build_model as jbuild
        p0 = jax.tree.map(np.asarray,
                          jbuild(JARCHS["paper-cnn"]).init(
                              jax.random.PRNGKey(0)))
        p0_path = os.path.join(tmp, "p0.npz")
        np.savez(p0_path, **dict(flatten(p0)))
        cases = ([("cnn", k, "off") for k in CNN]
                 + [("cnn", k, "auto") for k in AUTO]
                 + [("cnn", "ama_fes", "auto2")]
                 + [("pod", k, "off") for k in POD]
                 + [("ckpt", "async_ama", "off"), ("shard_sum", "x", "x"),
                    ("metrics", "async_ama", "off"),
                    ("metrics", "async_ama", "auto")])
        w2 = _spawn(2, tmp, p0_path, cases)
        w3 = _spawn(3, tmp, p0_path, [("cnn", "ama_fes", "off"),
                                      ("cnn", "ama_fes", "auto"),
                                      ("shard_sum", "x", "x")])
        ones = {}
        for name in CNN:
            sim = _cnn_sim(name, "off", p0)
            hist = sim.run(rounds=ROUNDS, eval_every=ROUNDS)
            ones[name] = (sim.state, hist)
        for name in POD:
            state, metrics, _ = _pod(_pod_argv(name, "off"))
            ones[name] = (state, metrics["loss"].tolist())
        logger = MetricsLogger(None)
        _cnn_sim("async_ama", "off", p0, logger=logger,
                 extended_metrics=True).run(rounds=ROUNDS, eval_every=ROUNDS)
        ones["metrics"] = [r for r in logger.rows if r["kind"] == "round"]
        # the checkpoint case: uninterrupted at W = 1, and W = 2's file
        # resumed at W = 1
        sim = _cnn_sim("async_ama", "off", p0)
        sim.run(rounds=2, eval_every=2)
        hist = sim.run(rounds=2, eval_every=2)
        ones["uninterrupted"] = (sim.state, hist)
        sim = _cnn_sim("async_ama", "off", p0)
        sim.resume(os.path.join(w2, "ck.npz"))
        hist = sim.run(rounds=2, eval_every=2)
        ones["resumed_w1"] = (sim.state, hist)
        stdout, stderr = jproc.communicate(timeout=600)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, stderr[-3000:]
    with open(os.path.join(tmp, "jax.json")) as f:
        jres = json.load(f)
    return dict(tmp=tmp, w2=w2, w3=w3, ones=ones, jax=jres)


def _rank(out, kind, name, mode, rank, like):
    tag = os.path.join(out, f"{kind}-{name}-{mode}_r{rank}")
    with open(tag + ".npz.json") as f:
        extra = json.load(f)
    return restore_state(tag + ".npz", like), extra


def _assert_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), k


def _assert_close(a, b, tol):
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_client_width_rule_matches_jax(runs, world):
    for C in range(1, 9):
        c = client_width(world, C)
        assert [c, world // c] == runs["jax"]["rule"][f"{world},{C}"], C


@pytest.mark.parametrize("name", list(CNN) + POD_BITWISE)
def test_off_at_two_ranks_is_bitwise_one_process(runs, name):
    """Both ranks train their own half of the cohorts; the gathered rows
    feed the same server kernel as one process, so the state and every
    round's loss are bitwise the one-process run's."""
    state1, ref = runs["ones"][name]
    kind = "pod" if name in POD else "cnn"
    for rank in (0, 1):
        got, extra = _rank(runs["w2"], kind, name, "off", rank, state1)
        _assert_equal(got, state1)
        want = ref if kind == "pod" else ref.train_loss
        assert extra["loss"] == want
        if kind == "cnn":
            assert extra["mesh"] == [2, 1, "gloo"]
            # rank 0 evaluates (the same params: the same accuracy)
            assert extra["acc"] == (ref.test_acc if rank == 0 else [])


@pytest.mark.parametrize("name", AUTO)
def test_auto_at_two_ranks_matches_jax_sharded_run(runs, name):
    """The pre-reduced axis ("auto", on because the client width is 2)
    against the JAX package's own sharded run on a 2-device mesh."""
    assert runs["jax"]["mesh"][name] == {"client": 2, "dsub": 1, "model": 1}
    like = runs["ones"][name][0]
    jstate = restore_state(os.path.join(runs["tmp"], f"jax-{name}.npz"),
                           like)
    tol = FEDOPT_RUN_TOL if name == "fedopt" else AUTO_TOL
    for rank in (1, 0):
        got, extra = _rank(runs["w2"], "cnn", name, "auto", rank, like)
        _assert_close(got, jstate, tol)
    assert abs(extra["acc"][-1] - runs["jax"]["acc"][name][-1]) <= 1 / 60


def test_one_cohort_a_rank_pod_path_agrees_within_bf16_rounding(runs):
    """C 2 over 2 ranks: each rank's masked plane runs ONE cohort. On the
    CPU a bf16 cohort's rows then differ in the last bits from the same
    cohort's rows in a 2-cohort call (some attention weights' gradients
    from the second local step on), so the run is held within a bf16 ulp
    of one process; the ranks still hold bitwise the same state."""
    state1, ref = runs["ones"]["pod_c2"]
    s0, e0 = _rank(runs["w2"], "pod", "pod_c2", "off", 0, state1)
    s1, e1 = _rank(runs["w2"], "pod", "pod_c2", "off", 1, state1)
    _assert_equal(s0, s1)
    assert e0["loss"] == e1["loss"]
    _assert_close(s0, state1, dict(rtol=2 ** -7, atol=2 ** -7))
    np.testing.assert_allclose(e0["loss"], ref, rtol=1e-3)


def test_auto_is_bitwise_run_to_run_and_names_its_route(runs):
    like = runs["ones"]["ama_fes"][0]
    a, ea = _rank(runs["w2"], "cnn", "ama_fes", "auto", 0, like)
    b, eb = _rank(runs["w2"], "cnn", "ama_fes", "auto2", 0, like)
    _assert_equal(a, b)
    assert ea["loss"] == eb["loss"]
    # one shard_sum a round and one loss gather: 2 collectives a round
    assert ea["collective"]["calls"] == 2 * ROUNDS
    prov = ea["header"]["provenance"]
    assert (prov["world_size"], prov["client_width"],
            prov["dist_backend"]) == (2, 2, "gloo")


def test_extended_metrics_under_both_routes(runs):
    """The telemetry rows at W = 2 (rank 0 logs): "off" bitwise one
    process's; "auto" sums delta_norm's squares across the ranks."""
    want = runs["ones"]["metrics"]
    for mode in ("off", "auto"):
        with open(os.path.join(runs["w2"],
                               f"metrics-async_ama-{mode}_r0.json")) as f:
            got = json.load(f)
        assert [r["t"] for r in got] == [r["t"] for r in want]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if mode == "off" or isinstance(w[k], str):
                    assert g[k] == w[k], k
                else:
                    np.testing.assert_allclose(g[k], w[k], err_msg=k,
                                               **AUTO_TOL)


def test_every_rank_holds_the_same_state(runs):
    for name in AUTO:
        like = runs["ones"][name][0]
        s0, _ = _rank(runs["w2"], "cnn", name, "auto", 0, like)
        s1, _ = _rank(runs["w2"], "cnn", name, "auto", 1, like)
        _assert_equal(s0, s1)


@pytest.mark.parametrize("world", [2, 3])
def test_shard_sum_is_the_gathered_partials_added_in_rank_order(runs,
                                                                world):
    out = runs[f"w{world}"]
    for rank in range(world):
        with open(os.path.join(out, f"shard_sum-x-x_r{rank}.json")) as f:
            assert json.load(f)["equal"]


def test_three_ranks_at_four_cohorts_are_replicas_bitwise_one_process(runs):
    """W = 3 at C = 4: client width 1, dsub 3; every rank trains all four
    cohorts and "auto" stays off."""
    state1, ref = runs["ones"]["ama_fes"]
    for mode in ("off", "auto"):
        for rank in range(3):
            got, extra = _rank(runs["w3"], "cnn", "ama_fes", mode, rank,
                               state1)
            assert extra["mesh"] == [1, 3, "gloo"]
            _assert_equal(got, state1)
            assert extra["loss"] == ref.train_loss


def test_checkpoint_at_two_ranks_resumes_at_one_and_two(runs):
    want, ref = runs["ones"]["uninterrupted"]
    got1, hist1 = runs["ones"]["resumed_w1"]
    _assert_equal(got1, want)
    assert hist1.train_loss == ref.train_loss
    for rank in (0, 1):
        got2, extra = _rank(runs["w2"], "ckpt", "async_ama", "off", rank,
                            want)
        _assert_equal(got2, want)
        assert extra["loss"] == ref.train_loss


@pytest.mark.parametrize("option", ["comm_plane", "partitioned",
                                    "fes_static", "virtual"])
def test_options_without_a_sharded_form_are_refused(option):
    split, whole = FLMesh(client=2), FLMesh(client=1, dsub=2)
    model = tbuild(TARCHS["paper-cnn"])
    if option == "virtual":
        train, test, _ = _world()
        clients = VirtualClientShards(train, 8, shard_size=30, seed=0)
        fl = _fl("ama_fes", "off")
        TSim(model, fl, clients, test, device="cpu", mesh=whole)
        with pytest.raises(ValueError, match="virtual population"):
            TSim(model, fl, clients, test, device="cpu", mesh=split)
        return
    kw, words = {"comm_plane": ({"comm_plane": "q8"}, "comm plane"),
                 "partitioned": ({"client_plane": "partitioned"},
                                 "partitioned client plane"),
                 "fes_static": ({"fes_static": True}, "fes_static")}[option]
    fl = _fl("ama_fes", "off", **kw)
    ChunkRunner(model, fl, device="cpu", mesh=whole)
    with pytest.raises(ValueError, match=words):
        ChunkRunner(model, fl, device="cpu", mesh=split)


def test_rank_staging_is_the_rows_of_the_full_staging():
    train, _, part = _world()
    clients = build_clients(train, part)
    sel = np.array([[3, 1, 7, 0], [2, 5, 6, 4]])
    full = stage_chunk(train, clients, sel, 0, 5, 3, 10)
    for s in range(2):
        block = FLMesh(client=2, rank=s).cohorts(4)
        got = stage_chunk(train, clients, sel, 0, 5, 3, 10, cohorts=block)
        for k in full:
            np.testing.assert_array_equal(got[k], full[k][:, block])


def test_without_world_size_the_mesh_is_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = engine_mesh(4, "cpu")
    assert (mesh.client, mesh.dsub, mesh.group, mesh.world) == (1, 1, None,
                                                                1)
    x = {"a": torch.ones(4, 3)}
    with ctx.use(mesh):
        assert ctx.gather_leading(x) is x
        assert ctx.constrain_leading(x, 4) is x
        assert ctx.axis_size("client") == 1
    assert not ctx.pre_reduced(_fl("ama", "auto"), mesh)
    assert ctx.pre_reduced(_fl("ama", "force"), mesh)


def test_round_bytes_follow_the_route():
    mesh = FLMesh(client=2, dsub=1, group=object())
    N, s, C = 54_784, 4, 10
    assert ctx.round_bytes(mesh, C, N * s, N, 1, False) == 5 * N * s
    assert ctx.round_bytes(mesh, C, N * s, N, 1, True) == 2 * 4 * N // 2
    assert ctx.round_bytes(FLMesh(), C, N * s, N, 1, False) == 0
    replicas = FLMesh(client=1, dsub=2, group=object())
    assert ctx.round_bytes(replicas, C, N * s, N, 1, True) == 0
