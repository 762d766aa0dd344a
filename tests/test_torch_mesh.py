"""The sharded client axis (``launch/mesh.py: engine_mesh``,
``sharding/ctx.py``) on the CPU: W gloo ranks over a ``file://`` store,
one spawn per world size running all of its cases.

  * the client-width rule equals the JAX package's ``engine_mesh`` at
    every (W, C) of W in {1, 2, 3, 4, 8}, C in 1..8;
  * ``client_reduce="off"`` at W = 2 is bitwise the one-process run: the
    paper CNN under ama, ama_fes, async_ama, fedavg, fedprox, fedopt and
    ama on the legacy server plane, ama_fes under the q8, bf16 and topk
    comm planes (each rank compresses its rows, the payload is gathered
    compressed; the bytes counted are the launcher's reckoning),
    async_ama under bf16, the ``fes_static`` client plane and a virtual
    population of 10^6 clients through the launcher (nothing K long on
    a rank's host), and the reduced minitron-8b pod path chunked, per
    round and under q8;
  * the partitioned client plane at W = 2 (each rank plans its own
    block) is bitwise the one-process run planned and trained block by
    block (``chip_smoke.BlockedPlane``) and within the partitioned
    plane's tolerance of the plain one, for the CNN and the pod path;
  * ``"auto"`` at W = 2 (the pre-reduced axis, a rank-ordered sum) is
    within the port's tolerance for the pre-reduced axis of the JAX
    package's own sharded run (``FederatedSimulation(..., mesh=
    engine_mesh(4))`` on 2 forced host devices, its psum path), with the
    paper's accuracy within one test example, and bitwise run to run;
    so are the bf16 and topk comm planes, the partitioned plane and
    ``fes_static``;
  * every rank holds the same state (the comm residual once gathered);
    W = 3 at C = 4 (client 1, dsub 3: replicas) is bitwise W = 1; a
    checkpoint written at W = 2 resumes at W = 1 and at W = 2 and
    continues bitwise, a q8 one with its error-feedback residual too.

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

from repro_torch import comm as tcomm
from repro_torch.checkpoint.io import restore_state, save
from repro_torch.comm.plane import q8_uniforms
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core.simulation import FederatedSimulation as TSim
from repro_torch.data.partition import shard_partition
from repro_torch.data.pipeline import (build_clients, partition_plan,
                                      stage_chunk)
from repro_torch.data.synth import make_image_classification
from repro_torch.exec.engine import ChunkRunner
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import FLMesh, client_width, engine_mesh
from repro_torch.models.api import build_model as tbuild
from repro_torch.obs.log import MetricsLogger
from repro_torch.sharding import ctx
from repro_torch.utils.tree import flatten, params_from_numpy

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
# the port's tolerance for the pre-reduced axis against the fused plane
# (tests/test_torch_legacy.py::test_client_reduce_force_runs_close_to_
# fused); fedopt's server Adam amplifies a last-bit difference in a small
# pseudo-gradient by up to lr / tau = 100
AUTO_TOL = dict(rtol=5e-4, atol=1e-5)
FEDOPT_RUN_TOL = dict(rtol=2e-2, atol=2e-2)
# the partitioned plane against the masked one over engine rounds
# (tests/test_torch_client_plane.py, ROADMAP C 3): a rank's limited width
# is its own block's least limited count, so a cohort may change program
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
# a bf16 model's rows within a bf16 ulp (the pod path)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
ROUNDS = 3
#: name: (algorithm, max_delay, extra FLConfig fields)
CNN = {"ama": ("ama", 0, {}), "ama_fes": ("ama_fes", 0, {}),
       "async_ama": ("async_ama", 2, {}), "fedavg": ("fedavg", 0, {}),
       "fedprox": ("fedprox", 0, {}), "fedopt": ("fedopt", 0, {}),
       "legacy": ("ama", 0, {"server_plane": "legacy"}),
       "q8": ("ama_fes", 0, {"comm_plane": "q8"}),
       "bf16": ("ama_fes", 0, {"comm_plane": "bf16"}),
       "topk": ("ama_fes", 0, {"comm_plane": "topk",
                               "comm_topk_frac": 0.05}),
       "async_bf16": ("async_ama", 2, {"comm_plane": "bf16"}),
       "fes_static": ("ama_fes", 0, {"fes_static": True}),
       "partitioned": ("ama_fes", 0, {"client_plane": "partitioned"})}
COMM = ["q8", "bf16", "topk", "async_bf16"]
#: "off" bitwise one process (the partitioned plane plans per block)
OFF = [k for k in CNN if k != "partitioned"]
#: "auto" against JAX's sharded run (q8's stream is the port's own, C 1)
AUTO = ["ama", "ama_fes", "async_ama", "fedavg", "fedprox", "fedopt",
        "bf16", "topk", "partitioned", "fes_static"]
#: the reduced minitron-8b pod path: C 4 gives each of 2 ranks 2 cohorts;
#: C 2 (one cohort a rank) is held at bf16 rounding, not bitwise (see
#: test_one_cohort_a_rank_pod_path_agrees_within_bf16_rounding)
POD = {"pod_scan": ["--cohorts", "4"],
       "pod_no_scan": ["--cohorts", "4", "--no-scan"],
       "pod_c2": ["--cohorts", "2"],
       "pod_q8": ["--cohorts", "4", "--comm-plane", "q8"],
       "pod_part": ["--cohorts", "4", "--client-plane", "partitioned",
                    "--p-limited", "0.5"]}
POD_BITWISE = ["pod_scan", "pod_no_scan", "pod_q8"]
#: a virtual population through the launcher: K 10^6, each rank staging
#: its block of the hashed schedule
K_VIRTUAL = 1_000_000
VIRTUAL_ARGV = ["--clients", str(K_VIRTUAL), "--clients-per-round", "4",
                "--population", "virtual", "--n-train", "200", "--rounds",
                str(ROUNDS), "--eval-every", str(ROUNDS), "--device", "cpu",
                "--client-reduce", "off"]


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


def _virtual():
    args = tlaunch.parser().parse_args(VIRTUAL_ARGV)
    return tlaunch.paper_scale(args, tlaunch.fl_config(args),
                               torch.device("cpu"))


def _blocked(fn, *a, **kw):
    """``fn`` run in one process as the ranks of a client width of 2 run
    it: each cohort block planned and trained in calls of its own."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    with chip_smoke.BlockedPlane(torch, 2):
        return fn(*a, **kw)


def _k_long(obj, K, seen=None, path="sim"):
    """Paths of containers at least K long reachable through the
    attributes of ``obj`` (numpy arrays, tensors, lists, sets, dicts);
    tests/test_torch_federation_scale.py's check, for a rank."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float)):
        return []
    seen.add(id(obj))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return [path] if obj.ndim and max(obj.shape) >= K else []
    if isinstance(obj, (list, tuple, set, dict)):
        if len(obj) >= K:
            return [path]
        items = obj.items() if isinstance(obj, dict) else enumerate(obj)
        return [h for k, v in items
                for h in _k_long(v, K, seen, f"{path}[{k!r}]")]
    if hasattr(obj, "__dict__") and type(obj).__module__.startswith(
            "repro_torch"):
        return [h for k, v in vars(obj).items()
                for h in _k_long(v, K, seen, f"{path}.{k}")]
    return []


def _whole(state, mesh):
    """``state`` with its comm residual gathered from every rank's block
    (a collective: every rank calls it), as a one-process run holds it."""
    res = state["aux"].get("comm")
    if not res:
        return state
    with ctx.use(mesh):
        res = ctx.gather_leading(res)
    return {**state, "aux": {**state["aux"], "comm": res}}


def _dump(path, state, extra, mesh=None):
    save(path, _whole(state, mesh) if mesh is not None else state)
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
            line = tlaunch._mesh_line(sim.fl, mesh, sim.params, sim.strategy,
                                      4)
            residual = [list(v.shape) for v in
                        sim.state["aux"].get("comm", {}).values()]
            hist = sim.run(rounds=ROUNDS, eval_every=ROUNDS)
            _dump(tag + ".npz", sim.state,
                  {"loss": hist.train_loss, "acc": hist.test_acc,
                   "mesh": [mesh.client, mesh.dsub, mesh.backend],
                   "header": logger.rows[0] if logger.rows else None,
                   "collective": sim.timer.summary().get("collective"),
                   "bytes": sim.runner.collective.bytes_in, "line": line,
                   "residual": residual,
                   "split": sim.runner.limited_split}, mesh)
        elif kind == "virtual":
            sim, hist = _virtual()
            _dump(tag + ".npz", sim.state,
                  {"loss": hist.train_loss, "acc": hist.test_acc,
                   "virtual": bool(sim.env.virtual),
                   "k_long": _k_long(sim, K_VIRTUAL)})
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
            _dump(tag + ".npz", state, {"loss": metrics["loss"].tolist()},
                  engine_mesh(4, "cpu"))
        elif kind == "ckpt":
            mesh = engine_mesh(4, "cpu")
            sim = _cnn_sim(name, mode, p0, mesh)
            sim.run(rounds=2, eval_every=2)
            sim.save(f"{out}/ck-{name}.npz")
            sim = _cnn_sim(name, mode, p0, mesh)
            sim.resume(f"{out}/ck-{name}.npz")
            residual = [list(v.shape) for v in
                        sim.state["aux"].get("comm", {}).values()]
            hist = sim.run(rounds=2, eval_every=2)
            _dump(tag + ".npz", sim.state, {"loss": hist.train_loss,
                                            "residual": residual}, mesh)
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
                 + [("cnn", "q8", "auto"), ("cnn", "ama_fes", "auto2"),
                    ("virtual", "k6", "off")]
                 + [("pod", k, "off") for k in POD]
                 + [("ckpt", "async_ama", "off"), ("ckpt", "q8", "off"),
                    ("shard_sum", "x", "x"),
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
        # the partitioned plane planned and trained block by block
        def part():
            sim = _cnn_sim("partitioned", "off", p0)
            hist = sim.run(rounds=ROUNDS, eval_every=ROUNDS)
            return sim.state, hist, sim.runner.limited_split
        ones["partitioned_blocked"] = _blocked(part)
        state, metrics, _ = _blocked(_pod, _pod_argv("pod_part", "off"))
        ones["pod_part_blocked"] = (state, metrics["loss"].tolist())
        sim, hist = _virtual()
        ones["virtual"] = (sim.state, hist)
        logger = MetricsLogger(None)
        _cnn_sim("async_ama", "off", p0, logger=logger,
                 extended_metrics=True).run(rounds=ROUNDS, eval_every=ROUNDS)
        ones["metrics"] = [r for r in logger.rows if r["kind"] == "round"]
        # the checkpoint cases: uninterrupted at W = 1, and W = 2's file
        # resumed at W = 1
        for name in ("async_ama", "q8"):
            sim = _cnn_sim(name, "off", p0)
            sim.run(rounds=2, eval_every=2)
            hist = sim.run(rounds=2, eval_every=2)
            ones[f"uninterrupted-{name}"] = (sim.state, hist)
            sim = _cnn_sim(name, "off", p0)
            sim.resume(os.path.join(w2, f"ck-{name}.npz"))
            hist = sim.run(rounds=2, eval_every=2)
            ones[f"resumed_w1-{name}"] = (sim.state, hist)
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


@pytest.mark.parametrize("name", OFF + POD_BITWISE + ["virtual"])
def test_off_at_two_ranks_is_bitwise_one_process(runs, name):
    """Both ranks train their own half of the cohorts; the gathered rows
    (or, under a comm plane, the payloads each rank compressed from its
    own rows and block of the residual) feed the same server kernel as
    one process, so the state and every round's loss are bitwise the
    one-process run's. A virtual population of 10^6 runs through the
    launcher, each rank staging its own block and holding nothing K
    long."""
    state1, ref = runs["ones"][name]
    kind = {"virtual": "virtual"}.get(name, "pod" if name in POD else "cnn")
    for rank in (0, 1):
        got, extra = _rank(runs["w2"], kind, "k6" if kind == "virtual"
                           else name, "off", rank, state1)
        _assert_equal(got, state1)
        want = ref if kind == "pod" else ref.train_loss
        assert extra["loss"] == want
        if kind != "pod":
            # rank 0 evaluates (the same params: the same accuracy)
            assert extra["acc"] == (ref.test_acc if rank == 0 else [])
        if kind == "cnn":
            assert extra["mesh"] == [2, 1, "gloo"]
        if kind == "virtual":
            assert extra["virtual"] and extra["k_long"] == []


@pytest.mark.parametrize("name", COMM)
def test_comm_plane_gathers_the_compressed_payload(runs, name):
    """Under "off" a rank receives the other rank's compressed payloads,
    (W - 1) x C / client x ``payload_bytes`` a round, as the launcher's
    mesh line reckons, plus the per-cohort losses: never dense rows. Its
    residual is its (C / client, N) block."""
    like = runs["ones"][name][0]
    _, extra = _rank(runs["w2"], "cnn", name, "off", 0, like)
    params = like["params"]
    n = sum(x.numel() for _, x in flatten(params))
    pb = tcomm.resolve(_fl(name, "off")).payload_bytes(params)
    assert pb < n * 4 / 1.9
    want = ctx.round_bytes(FLMesh(client=2, group=object()), 4, pb, n, 1,
                           False)
    assert want == 2 * pb
    assert f"{want:,} bytes a round received per rank" in extra["line"]
    assert extra["bytes"] == ROUNDS * (want + 2 * 4)
    # the payload's gather and the losses' a round
    assert extra["collective"]["calls"] == 2 * ROUNDS
    assert extra["residual"] == [[2, n]]


@pytest.mark.parametrize("name", ["partitioned", "pod_part"])
def test_partitioned_at_two_ranks_is_bitwise_the_per_block_plan_run(
        runs, name):
    """Each rank plans its own block (its limited width is its block's
    least limited count): the state and losses are bitwise the one
    process run planned and trained block by block, the limited
    cohort-rounds counted over both shards; against the plain run (one
    plan over all C) within the partitioned plane's tolerance."""
    pod = name in POD
    plain = runs["ones"][name][0]
    blocked = runs["ones"][f"{name}_blocked"]
    for rank in (0, 1):
        got, extra = _rank(runs["w2"], "pod" if pod else "cnn", name, "off",
                           rank, plain)
        _assert_equal(got, blocked[0])
        _assert_close(got, plain, BF16_TOL if pod else ROUND_TOL)
        if pod:
            assert extra["loss"] == blocked[1]
        else:
            assert extra["loss"] == blocked[1].train_loss
            assert extra["split"] == blocked[2]
            assert extra["split"]["limited_program"] > 0


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
        res = got["aux"].pop("comm", None)
        jres = jstate["aux"].pop("comm", None)
        _assert_close(got, jstate, tol)
        if res is not None:
            _assert_residual_close(res, jres, tol)
        jstate["aux"]["comm"] = jres
    assert abs(extra["acc"][-1] - runs["jax"]["acc"][name][-1]) <= 1 / 60


def test_q8_auto_at_two_ranks_matches_the_one_process_run(runs):
    """q8's stochastic rounding draws from the port's own stream (ROADMAP
    C 1), so its pre-reduced run is held against the port's one-process
    run, not JAX's."""
    like, ref = runs["ones"]["q8"]
    for rank in (1, 0):
        got, extra = _rank(runs["w2"], "cnn", "q8", "auto", rank, like)
        res = got["aux"].pop("comm")
        _assert_close(got, {**like, "aux": {}}, AUTO_TOL)
        _assert_residual_close(res, like["aux"]["comm"], AUTO_TOL)
    assert abs(extra["acc"][-1] - ref.test_acc[-1]) <= 1 / 60


def _assert_residual_close(a, b, tol):
    """An error-feedback residual e - Q(e) of two packages whose e agree
    within ``tol``: where e lies on a rounding boundary of the quantizer
    Q, an f32 last-bit difference in e moves Q(e) by one quantum and the
    residual with it (one element of 219,136 under bf16 in 3 rounds).
    Held within ``tol`` but for at most one element in 10^4, each of
    those within one quantum (twice the largest |residual|)."""
    for (k, x), (_, y) in zip(flatten(a), flatten(b), strict=True):
        x, y = x.float().numpy(), y.float().numpy()
        off = ~np.isclose(x, y, **tol)
        assert off.sum() <= max(1, x.size // 10_000), k
        np.testing.assert_array_less(np.abs(x - y)[off],
                                     2 * np.abs(y).max() * (1 + 2 ** -20))


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
    """Under a comm plane once each rank's residual block is gathered."""
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
    want, ref = runs["ones"]["uninterrupted-async_ama"]
    got1, hist1 = runs["ones"]["resumed_w1-async_ama"]
    _assert_equal(got1, want)
    assert hist1.train_loss == ref.train_loss
    for rank in (0, 1):
        got2, extra = _rank(runs["w2"], "ckpt", "async_ama", "off", rank,
                            want)
        _assert_equal(got2, want)
        assert extra["loss"] == ref.train_loss


def test_q8_checkpoint_at_two_ranks_resumes_at_one_and_two(runs):
    """q8 with error feedback: the file holds the whole (C, N) residual,
    gathered from both ranks' blocks, as one process writes it; resumed
    at W = 1 and at W = 2 (each rank taking its block) the run continues
    bitwise the uninterrupted one."""
    want, ref = runs["ones"]["uninterrupted-q8"]
    n = want["aux"]["comm"]["g0"].shape[1]
    with np.load(os.path.join(runs["w2"], "ck-q8.npz")) as z:
        assert z["aux/comm/g0"].shape == (4, n)
    got1, hist1 = runs["ones"]["resumed_w1-q8"]
    _assert_equal(got1, want)
    assert hist1.train_loss == ref.train_loss
    for rank in (0, 1):
        got2, extra = _rank(runs["w2"], "ckpt", "q8", "off", rank, want)
        _assert_equal(got2, want)
        assert extra["loss"] == ref.train_loss
        assert extra["residual"] == [[2, n]]


def test_block_q8_uniforms_and_payload_are_rows_of_the_whole():
    """A rank's q8 uniforms are the rows of the whole stack's draw, and
    its compressed payload and residual the rows of the whole's."""
    t = torch.tensor(3, dtype=torch.int32)
    whole = q8_uniforms(7, t, 1, (6, 37))
    for r0, n in ((0, 2), (2, 2), (4, 2), (1, 3)):
        assert torch.equal(q8_uniforms(7, t, 1, (n, 37), r0),
                           whole[r0:r0 + n])
    plane = tcomm.resolve(_fl("q8", "off"))
    g = torch.Generator().manual_seed(0)
    prev = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(
        3, generator=g)}
    rows = {k: v[None] + 0.1 * torch.randn((6,) + tuple(v.shape),
                                           generator=g)
            for k, v in prev.items()}
    res = plane.init_residual(prev, 6)
    res["g0"] += 0.01 * torch.randn(res["g0"].shape, generator=g)
    groups, new = plane.compress(t, prev, rows, res)
    for r0 in (0, 3):
        part, pnew = plane.compress(
            t, prev, {k: v[r0:r0 + 3] for k, v in rows.items()},
            {"g0": res["g0"][r0:r0 + 3]}, row0=r0)
        for k in ("d", "scale"):
            assert torch.equal(part[0][1][k], groups[0][1][k][r0:r0 + 3])
        assert torch.equal(pnew["g0"], new["g0"][r0:r0 + 3])


def test_rank_plan_is_the_partition_plan_of_its_block(monkeypatch):
    """Under a split client axis the runner stages ``partition_plan`` of
    the rank's block of ``limited`` (indices of its own slots) and counts
    every shard's limited cohort-rounds once."""
    limited = np.array([[1, 0, 1, 1], [0, 0, 1, 1], [1, 1, 1, 0]], bool)
    zeros = np.zeros((3, 4))
    sb = {"limited": limited, "delayed": zeros.astype(bool),
          "delays": zeros.astype(np.int32),
          "data_sizes": np.ones((3, 4), np.float32),
          "selected": zeros.astype(np.int32)}
    seen = []

    def dispatch(self, state, batch, scheds, n):
        seen.append(scheds)
        return state, {"loss": torch.zeros(n)}

    monkeypatch.setattr(ChunkRunner, "_dispatch", dispatch)
    model = tbuild(TARCHS["paper-cnn"])
    fl = _fl("partitioned", "off")
    for s in range(2):
        mesh = FLMesh(client=2, rank=s)
        runner = ChunkRunner(model, fl, device="cpu", mesh=mesh)
        runner.run_chunk({}, {"x": np.zeros((3, 4, 1), np.float32)}, sb)
        for k, v in partition_plan(limited[:, mesh.cohorts(4)]).items():
            np.testing.assert_array_equal(seen[-1][k].numpy(), v)
        # block 0 least limited count 0, block 1 1: 3 rounds x 1 on the
        # limited program, 5 of the 8 limited cohort-rounds overflow
        assert runner.limited_split == {"limited_program": 3, "overflow": 5}


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


@pytest.mark.parametrize("plane,per_client", [
    ("q8", 54_784 + 4), ("bf16", 2 * 54_784), ("topk", 8 * 2_739)])
def test_round_bytes_of_the_compressed_gather(plane, per_client):
    """The compressed "off" route: (W - 1) x C / client x the payload one
    client uploads (q8: a byte an element and an f32 scale; bf16: two
    bytes, its unit scale not sent; topk: an f32 value and an int32
    position for 5% of the elements)."""
    params = tbuild(TARCHS["paper-cnn"]).init(
        torch.Generator().manual_seed(0), "cpu")
    pb = tcomm.resolve(_fl("ama_fes", "off", comm_plane=plane,
                           comm_topk_frac=0.05)).payload_bytes(params)
    assert pb == per_client
    mesh = FLMesh(client=2, dsub=1, group=object())
    assert ctx.round_bytes(mesh, 10, pb, 54_784, 1, False) == 5 * pb
