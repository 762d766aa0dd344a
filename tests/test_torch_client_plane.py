"""The port's partitioned and ``fes_static`` client planes
(repro_torch.core.client, paper Eq. 3) against the port's masked plane
and against the JAX package's planes, on the CPU.

Params start in JAX and cross through numpy, so both packages train the
same model on the same batches. The gates are the JAX package's own
(tests/test_client.py): the partitioned plane's limited cohorts within
rtol 1e-6, atol 1e-7 of the masked plane, engine rounds within rtol
1e-5, atol 1e-6 of the masked reference, and the port's chunked ==
per-round bitwise. The unlimited cohorts run the masked program over a
gathered batch, which JAX holds exactly equal to the masked plane; in
the port they are held at the limited cohorts' tolerance: ``vmap`` runs
the CNN's convolutions as one grouped convolution over the cohort axis,
and PyTorch's CPU weight gradient of a grouped convolution splits its
sums across threads by the group count (at 8 threads U = 3 of C = 5
cohorts differ from the same cohorts among 5 in the last bits; at 3 to
5 threads they agree), so gathering U of C cohorts changes their
rounding. When every cohort runs one program (L == 0) the widths match
and the equality is exact.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import FLConfig as JFL
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.core.client import (
    make_partitioned_local_train as jmake_partitioned)
from repro.core.round import init_state as jinit_state
from repro.core.round import make_round_step as jmake_round_step
from repro.data.pipeline import partition_plan as jpartition_plan
from repro.models.api import build_model as jbuild
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import fes as tfes
from repro_torch.core.client import (make_fes_local_train,
                                     make_limited_local_train,
                                     make_local_train,
                                     make_partitioned_local_train)
from repro_torch.core.round import (PARTITION_KEYS, as_scan_scheds,
                                    init_state, make_round_step)
from repro_torch.data.pipeline import partition_plan
from repro_torch.exec.engine import ChunkRunner
from repro_torch.kernels import ref as tref
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import (flatten, leaves, params_from_numpy,
                                    params_to_numpy, tree_map)

REPO = Path(__file__).resolve().parents[1]
# one round of a few f32 SGD steps whose sums XLA and PyTorch order
# differently (tests/test_torch_round.py)
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
# the limited cohorts of the partitioned plane against the masked plane
LIMITED_TOL = dict(rtol=1e-6, atol=1e-7)
# the JAX package's limited-program share of the full program's flops
# (BENCH_client_plane.json, XLA's cost analysis on a CPU)
JAX_FLOP_RATIO = {"paper-cnn": 0.3812, "minitron-8b": 0.6516}

LIMITED = np.array([True, False, True, False, False])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's ops on one intra-op thread: the reduced LLMs'
    many small ops (the rwkv6 recurrence's plain version above all) slow
    down by orders of magnitude when several test workers' thread pools
    spin on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ALGOS = [("ama_fes", {}),
         ("fedprox", dict(fedprox_partial=0.5, fedprox_rho=0.01)),
         ("fedavg", {}),
         ("fedopt", {}),
         ("async_ama", dict(max_delay=2, p_delay=0.3))]


@pytest.fixture(scope="module")
def cnn():
    """(JAX model, port model, JAX params as numpy, the CNN batch (5
    cohorts x 3 steps x 8 images), made from a numpy seed)."""
    jm, tm = jbuild(JARCHS["paper-cnn"]), tbuild(TARCHS["paper-cnn"])
    p0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(5, 3, 8, 28, 28, 1).astype(np.float32),
             "label": rng.randint(0, 10, (5, 3, 8)).astype(np.int32)}
    return jm, tm, p0, batch


def _tsched(limited):
    """A one-round port schedule with the partition plan merged in."""
    plan = partition_plan(np.asarray(limited)[None])
    sb = {"limited": np.asarray(limited)[None],
          "delayed": np.zeros((1, len(limited)), bool),
          "delays": np.ones((1, len(limited)), np.int32),
          "data_sizes": np.ones((1, len(limited)), np.float32), **plan}
    return {k: v[0] for k, v in as_scan_scheds(sb, "cpu").items()}


def _jsched(limited):
    plan = jpartition_plan(np.asarray(limited)[None])
    return {"limited": jnp.asarray(limited),
            **{k: jnp.asarray(v[0]) for k, v in plan.items()}}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cohort(tree, c):
    return [np.asarray(x[c].float() if x.dtype == torch.bfloat16 else x[c])
            for x in leaves(tree)]


# ------------------------------------------------------------ the plan ---

def _limited_cases():
    rng = np.random.RandomState(11)
    return {"random": rng.rand(6, 5) < 0.4,
            "all_limited": np.ones((3, 4), bool),
            "none_limited": np.zeros((3, 4), bool),
            "varying_counts": np.array([[1, 0, 1, 0], [0, 0, 0, 1],
                                        [1, 1, 0, 1]], bool),
            "one_round": np.array([[0, 1, 1, 0, 1, 0, 1, 1]], bool),
            "one_cohort": np.array([[1], [0], [1]], bool),
            "wide": rng.rand(4, 64) < 0.7}


@pytest.mark.parametrize("case", sorted(_limited_cases()))
def test_partition_plan_bitwise_equal_to_jax(case):
    limited = _limited_cases()[case]
    got, want = partition_plan(limited), jpartition_plan(limited)
    assert sorted(got) == sorted(want) == sorted(PARTITION_KEYS)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n, C = limited.shape
    L = int(limited.sum(axis=1).min())
    assert got["part_lim_idx"].shape == (n, L)
    assert got["part_full_idx"].shape == (n, C - L)


def test_partition_plan_refuses_a_flat_vector():
    with pytest.raises(ValueError, match="n_rounds, C"):
        partition_plan(np.zeros(4, bool))


# ------------------------------------------- partitioned against masked ---

@pytest.mark.parametrize("algorithm,kw", ALGOS,
                         ids=[a for a, _ in ALGOS])
def test_partitioned_matches_masked_per_cohort(cnn, algorithm, kw):
    """The port's partitioned plane against the port's masked plane, per
    cohort, within LIMITED_TOL (limited cohorts: the classifier-only or
    shorter program computes the same classifier update without the body
    backward; unlimited ones: the module docstring says why not bitwise),
    losses within rtol 1e-6."""
    _, tm, p0, batch = cnn
    fl = TFL(algorithm=algorithm, lr=0.05, **kw)
    tp0, tb = params_from_numpy(p0), _tbatch(batch)
    m_params, m_loss = make_local_train(tm, fl)(tp0, tb,
                                                torch.from_numpy(LIMITED))
    p_params, p_loss = make_partitioned_local_train(tm, fl)(
        tp0, tb, _tsched(LIMITED))
    for c in range(len(LIMITED)):
        for a, b in zip(_cohort(m_params, c), _cohort(p_params, c),
                        strict=True):
            np.testing.assert_allclose(a, b, **LIMITED_TOL)
    np.testing.assert_allclose(p_loss.numpy(), m_loss.numpy(), rtol=1e-6)


@pytest.mark.parametrize("algorithm,kw", ALGOS,
                         ids=[a for a, _ in ALGOS])
def test_partitioned_matches_jax_partitioned(cnn, algorithm, kw):
    """The port's partitioned plane against the JAX package's on the same
    params and batch: every cohort within ROUND_TOL."""
    jm, tm, p0, batch = cnn
    jp, jl = jax.jit(jmake_partitioned(jm, JFL(algorithm=algorithm, lr=0.05,
                                                **kw)))(
        p0, {k: jnp.asarray(v) for k, v in batch.items()}, _jsched(LIMITED))
    tp, tl = make_partitioned_local_train(
        tm, TFL(algorithm=algorithm, lr=0.05, **kw))(
        params_from_numpy(p0), _tbatch(batch), _tsched(LIMITED))
    jflat = dict(flatten(jax.tree.map(np.asarray, jp)))
    tflat = dict(flatten(params_to_numpy(tp)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k,
                                   **ROUND_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ROUND_TOL)


@pytest.mark.parametrize("limited", [[True] * 5, [False] * 5],
                         ids=["all_limited", "none_limited"])
def test_one_sided_rounds_match_masked(cnn, limited):
    """The U == 0 and L == 0 branches: all cohorts on one program,
    scattered back in slot order, against the masked plane."""
    _, tm, p0, batch = cnn
    fl = TFL(algorithm="ama_fes", lr=0.05)
    tp0, tb = params_from_numpy(p0), _tbatch(batch)
    lim = np.asarray(limited)
    m_params, m_loss = make_local_train(tm, fl)(tp0, tb, torch.from_numpy(lim))
    p_params, p_loss = make_partitioned_local_train(tm, fl)(tp0, tb,
                                                            _tsched(lim))
    for a, b in zip(leaves(m_params), leaves(p_params), strict=True):
        if lim[0]:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **LIMITED_TOL)
        else:
            assert torch.equal(a, b)
    np.testing.assert_allclose(p_loss.numpy(), m_loss.numpy(), rtol=1e-6)


def test_partitioned_scatter_is_permutation_invariant(cnn):
    """Permuting the cohort slots (batch rows and limited flags) permutes
    the partitioned plane's outputs the same way."""
    _, tm, p0, batch = cnn
    lt = make_partitioned_local_train(tm, TFL(algorithm="ama_fes", lr=0.05))
    tp0 = params_from_numpy(p0)
    base_params, base_loss = lt(tp0, _tbatch(batch), _tsched(LIMITED))
    rng = np.random.RandomState(7)
    for _ in range(3):
        perm = rng.permutation(len(LIMITED))
        pb = {k: v[perm] for k, v in batch.items()}
        perm_params, perm_loss = lt(tp0, _tbatch(pb), _tsched(LIMITED[perm]))
        for a, b in zip(leaves(base_params), leaves(perm_params),
                        strict=True):
            np.testing.assert_allclose(a[perm].numpy(), b.numpy(),
                                       **LIMITED_TOL)
        np.testing.assert_allclose(base_loss.numpy()[perm],
                                   perm_loss.numpy(), rtol=1e-6)


def test_limited_program_keeps_the_body_as_a_stride0_view(cnn):
    """The classifier program makes no per-cohort body copy: each body
    leaf comes back as a stride-0 view of the global leaf's memory, and
    so does the partitioned plane's output when every cohort is
    limited."""
    _, tm, p0, batch = cnn
    fl = TFL(algorithm="ama_fes", lr=0.05)
    tp0 = params_from_numpy(p0)
    out, _ = make_limited_local_train(tm, fl)(tp0, _tbatch(batch))
    allp, _ = make_partitioned_local_train(tm, fl)(
        tp0, _tbatch(batch), _tsched(np.ones(5, bool)))
    for tree in (out, allp):
        for x, g in zip(leaves(tree["body"]), leaves(tp0["body"]),
                        strict=True):
            assert x.shape == (5,) + g.shape and x.stride(0) == 0
            assert x.data_ptr() == g.data_ptr()
        for k in ("fc1", "fc2", "fc3"):
            assert not torch.equal(tree[k]["w"][0], tp0[k]["w"])


# ------------------------------------------------------------- engine ----

@pytest.mark.parametrize("algorithm", ["fedprox", "ama_fes", "async_ama"])
def test_partitioned_engine_matches_masked_chunked_and_per_round(cnn,
                                                                 algorithm):
    """Rounds with varying limited counts through ``ChunkRunner``: the
    partitioned plane chunked and per round against the masked chunked
    reference (the chunk-static overflow path: a chunk's extra limited
    cohorts run the masked program), and chunked == per round bit for
    bit, params, aux and losses."""
    _, tm, p0, _ = cnn
    rng = np.random.RandomState(3)
    n, C, steps, b = 3, 4, 2, 4
    batch = {"image": rng.randn(n, C, steps, b, 28, 28, 1).astype(
                 np.float32),
             "label": rng.randint(0, 10, (n, C, steps, b)).astype(np.int32)}
    limited = np.array([[1, 0, 1, 0], [0, 0, 0, 1], [1, 1, 0, 1]], bool)
    sb = {"limited": limited, "delayed": rng.rand(n, C) < 0.3,
          "delays": rng.randint(1, 3, (n, C)).astype(np.int32),
          "data_sizes": rng.rand(n, C).astype(np.float32) + 0.5,
          "selected": np.zeros((n, C), np.int32)}
    extra = dict(max_delay=2) if algorithm == "async_ama" else {}

    def run(plane, use_scan):
        fl = TFL(algorithm=algorithm, lr=0.05, fedprox_partial=0.5,
                 clients_per_round=C, client_plane=plane, **extra)
        runner = ChunkRunner(tm, fl, per_round_batch=True, use_scan=use_scan,
                             device="cpu")
        state = init_state(tm, fl, torch.Generator().manual_seed(0), "cpu")
        state["params"] = params_from_numpy(p0)
        st, m = runner.run_chunk(state, batch, dict(sb))
        return st, m, runner.limited_split

    ref_state, ref_m, none = run("masked", True)
    assert none is None
    got = {s: run("partitioned", s) for s in (True, False)}
    for st, m, split in got.values():
        # limited counts 2, 1, 3: the chunk's L = 1, so 3 of the 6
        # limited cohort-rounds run the limited program, 3 overflow
        assert split == {"limited_program": 3, "overflow": 3}
        for (k, a), (_, b2) in zip(flatten(ref_state["params"]),
                                   flatten(st["params"]), strict=True):
            np.testing.assert_allclose(b2.numpy(), a.numpy(), err_msg=k,
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m["loss"], ref_m["loss"], rtol=1e-5)
    (a, ma, _), (b2, mb, _) = got[True], got[False]
    for (k, x), (_, y) in zip(flatten({"p": a["params"], "a": a["aux"]}),
                              flatten({"p": b2["params"], "a": b2["aux"]}),
                              strict=True):
        assert torch.equal(x, y), k
    np.testing.assert_array_equal(ma["loss"], mb["loss"])


@pytest.mark.parametrize("arch", ["minitron-8b", "rwkv6-3b"])
def test_partitioned_pod_chunk_equals_per_round_bitwise(arch):
    """The LLM pod path (reduced, f32, remat on) under the partitioned
    plane: 3 rounds with 3 cohorts and varying limited counts in one
    chunk == the same chunk round by round (the runner's fallback, which
    replays the chunk's plan), bit for bit; and within rtol 1e-5, atol
    1e-6 of the masked plane."""
    cfg = treduced(TARCHS[arch], dtype="float32")
    model = tbuild(cfg)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (3, 2, 1, 32)).astype(np.int32)
    sb = {"limited": np.array([[1, 0, 1], [1, 1, 1], [0, 1, 1]], bool),
          "delayed": np.zeros((3, 3), bool),
          "delays": np.ones((3, 3), np.int32),
          "data_sizes": rng.rand(3, 3).astype(np.float32) + 0.5}

    def run(plane, use_scan):
        fl = TFL(algorithm="ama_fes", lr=0.05, clients_per_round=3,
                 cohorts=3, client_plane=plane)
        state = init_state(model, fl, torch.Generator().manual_seed(0),
                           "cpu")
        runner = ChunkRunner(model, fl, per_round_batch=False,
                             use_scan=use_scan, device="cpu")
        st, m = runner.run_chunk(state, {"tokens": toks}, dict(sb))
        return st, m, runner.limited_split

    (a, ma, split), (b, mb, _) = (run("partitioned", s) for s in (True,
                                                                   False))
    assert split == {"limited_program": 6, "overflow": 1}   # counts 2, 3, 2
    for (k, x), (_, y) in zip(flatten(a["params"]), flatten(b["params"]),
                              strict=True):
        assert torch.equal(x, y), k
    np.testing.assert_array_equal(ma["loss"], mb["loss"])
    ref, mref, _ = run("masked", True)
    for (k, x), (_, y) in zip(flatten(ref["params"]), flatten(a["params"]),
                              strict=True):
        np.testing.assert_allclose(y.numpy(), x.numpy(), err_msg=k,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ma["loss"], mref["loss"], rtol=1e-5)


def test_round_step_needs_the_plan_under_the_partitioned_plane(cnn):
    _, tm, p0, batch = cnn
    fl = TFL(algorithm="ama_fes", lr=0.05, client_plane="partitioned",
             clients_per_round=5)
    step = make_round_step(tm, fl)
    state = {"params": params_from_numpy(p0),
             "t": torch.zeros((), dtype=torch.int32), "aux": {}}
    sched = {k: v for k, v in _tsched(LIMITED).items()
             if k not in PARTITION_KEYS}
    with pytest.raises(KeyError, match="partition-plan"):
        step(state, {k: v[:, 0] for k, v in _tbatch(batch).items()}, sched)


# ---------------------------------------------------------- fes_static ---

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fes_static_reduced_minitron_freezes_body_and_matches_jax(dtype):
    """The fes_static round on reduced minitron-8b trains only the
    classifier: lm_head moves and every body leaf (the embedding among
    them) comes out of the AMA mix of identical bodies bitwise unchanged
    in the config's bf16, as in JAX's test, and within the mix's f32
    rounding in f32. In f32 the loss and the new global params match
    JAX's round within ROUND_TOL (in bf16 the two packages' roundings
    differ by far more: tests/test_torch_transformer.py holds a bf16
    loss at 2e-2)."""
    jcfg = jreduced(JARCHS["minitron-8b"], dtype=dtype)
    tcfg = treduced(TARCHS["minitron-8b"], dtype=dtype)
    kw = dict(algorithm="ama_fes", fes_static=True, lr=0.05)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jstate = jinit_state(jm, JFL(**kw), jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    toks = rng.randint(0, tcfg.vocab_size, (2, 1, 2, 16)).astype(np.int32)
    sched = {"limited": np.ones(2, bool), "delayed": np.zeros(2, bool),
             "delays": np.ones(2, np.int32),
             "data_sizes": np.ones(2, np.float32)}
    p0 = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    state = {"params": tree_map(torch.clone, p0),
             "t": torch.zeros((), dtype=torch.int32), "aux": {}}
    new, met = make_round_step(tm, TFL(**kw))(
        state, {"tokens": torch.from_numpy(toks)},
        {k: v[0] for k, v in as_scan_scheds(
            {k: v[None] for k, v in sched.items()}, "cpu").items()})
    assert torch.isfinite(met["loss"])
    body = [(new["params"]["embed"]["table"], p0["embed"]["table"]),
            *zip(leaves(new["params"]["body"]), leaves(p0["body"]),
                 strict=True)]
    assert not torch.equal(new["params"]["lm_head"]["w"], p0["lm_head"]["w"])
    if dtype != "float32":
        assert all(torch.equal(x, y) for x, y in body)
        return
    # f32 keeps the mix's own rounding of a_eff * p + sum_k c_k * p
    # (K = 2 products and adds, each rounded): within (K + 2) ulp of p
    for x, y in body:
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=4 * 2 ** -23,
                                   atol=0)
    jnew, jmet = jax.jit(jmake_round_step(jm, JFL(**kw)))(
        jstate, {"tokens": jnp.asarray(toks)},
        {k: jnp.asarray(v) for k, v in sched.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               **ROUND_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jnew["params"])))
    for k, v in flatten(params_to_numpy(new["params"])):
        np.testing.assert_allclose(v, jflat[k], err_msg=k, **ROUND_TOL)


def test_fes_static_plane_ignores_the_limited_flags(cnn):
    """Every cohort is limited under fes_static, whatever ``limited``
    says: the plane equals the classifier program of AMA-FES with no
    step cut, and no strategy hook runs."""
    _, tm, p0, batch = cnn
    fl = TFL(algorithm="fedprox", fedprox_partial=0.25, fes_static=True,
             lr=0.05)
    tp0, tb = params_from_numpy(p0), _tbatch(batch)
    a, la = make_fes_local_train(tm, fl)(tp0, tb, torch.zeros(5,
                                                              dtype=torch.bool))
    b, lb = make_limited_local_train(tm, TFL(algorithm="ama_fes",
                                             lr=0.05))(tp0, tb)
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(la, lb)


# ----------------------------------------------------- the body's work ---

def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _flop_world(arch):
    if arch == "paper-cnn":
        model = tbuild(TARCHS[arch])
        rng = np.random.RandomState(0)
        batch = {"image": torch.from_numpy(
                     rng.randn(1, 3, 8, 28, 28, 1).astype(np.float32)),
                 "label": torch.from_numpy(
                     rng.randint(0, 10, (1, 3, 8)).astype(np.int32))}
    else:
        cfg = treduced(TARCHS[arch], dtype="float32")
        model = tbuild(cfg)
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (1, 2, 2, 32)).astype(np.int32))}
    params = model.init(torch.Generator().manual_seed(0))
    return model, params, batch


@pytest.mark.parametrize("arch", ["paper-cnn", "minitron-8b", "rwkv6-3b"])
def test_limited_program_does_fewer_flops_than_the_full_program(arch):
    """torch's flop counter (matmuls, convolutions, attention) over one
    limited cohort's local training: the classifier-only program does
    strictly fewer flops than the full (masked) program on the same
    batch, because the body backward is gone, not masked."""
    model, params, batch = _flop_world(arch)
    fl = TFL(algorithm="ama_fes", lr=0.05)
    full = _flops(lambda: make_local_train(model, fl)(
        params, batch, torch.ones(1, dtype=torch.bool)))
    lim = _flops(lambda: make_limited_local_train(model, fl)(params, batch))
    ratio = lim / full
    print(f"{arch}: limited program {lim:,} of the full program's {full:,} "
          f"flops = {ratio:.4f} (the JAX package's XLA count: "
          f"{JAX_FLOP_RATIO.get(arch, 'not recorded')})")
    assert 0 < lim < full


KERNEL_PLAINS = {"minitron-8b": ("flash_attention_ref",
                                 ("flash_bwd_dq_ref", "flash_bwd_dkdv_ref")),
                 "rwkv6-3b": ("rwkv6_scan_ref", ("rwkv6_scan_bwd_ref",))}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", sorted(KERNEL_PLAINS))
def test_limited_program_runs_body_blocks_forward_only(arch, remat,
                                                       monkeypatch):
    """The classifier program over 2 cohorts and 2 steps of a 3-layer
    reduced LLM (2 body blocks, 1 tail block): the kernels' plain
    versions (what the wrappers take on the CPU) count one forward a body
    block a step and no backward; a tail block runs its forward twice
    under remat (the recompute) and once without, and its backward
    kernels once. The masked program runs every block as a tail
    block."""
    fwd, bwds = KERNEL_PLAINS[arch]
    calls = {}
    for name in (fwd, *bwds):
        orig = getattr(tref, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tref, name, counted)
    cfg = treduced(TARCHS[arch], dtype="float32").with_(
        num_layers=3, fes_tail_layers=1, remat=remat)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    batch = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (2, 2, 1, 24)).astype(np.int32))}
    fl = TFL(algorithm="ama_fes", lr=0.05)
    steps, body, tail = 2, 2, 1
    per_tail = 2 if remat else 1
    calls.clear()
    make_limited_local_train(model, fl)(params, batch)
    assert calls == {fwd: steps * (body + per_tail * tail),
                     **{b: steps * tail for b in bwds}}, calls
    calls.clear()
    make_local_train(model, fl)(params, batch, torch.ones(2, dtype=bool))
    assert calls == {fwd: steps * per_tail * (body + tail),
                     **{b: steps * (body + tail) for b in bwds}}, calls


def test_split_and_merge_params_round_trip():
    model = tbuild(TARCHS["paper-cnn"])
    params = model.init(torch.Generator().manual_seed(0))
    clf, body = tfes.split_params(params)
    assert sorted(clf) == ["fc1", "fc2", "fc3"] and sorted(body) == ["body"]
    merged = tfes.merge_params(clf, body)
    assert [k for k, _ in flatten(merged)] == [k for k, _ in flatten(params)]


# ------------------------------------------------------------ launcher ---

def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


@pytest.mark.parametrize("args", [
    ["--rounds", "2", "--clients-per-round", "5", "--p-limited", "0.5",
     "--n-train", "400"],
    ["--arch", "minitron-8b", "--pod", "--reduced", "--rounds", "2",
     "--no-scan", "--p-limited", "0.5"],
], ids=["paper", "pod"])
def test_launcher_takes_the_partitioned_client_plane_on_cpu(args):
    r = _run([*args, "--client-plane", "partitioned", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "client plane partitioned" in r.stdout
    assert "limited cohort-rounds on the limited program" in r.stdout
