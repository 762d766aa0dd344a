"""The port's dense LLM path (repro_torch.models.transformer, the pod
launcher) against the JAX package's, at reduced() size on the CPU.

Params start in JAX and cross through numpy (bf16 bits included), so
both packages run the same model on the same tokens; on the CPU the
port's attention runs the plain version of the flash kernels.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import env as jenv
from repro.configs.base import FLConfig as JFL
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.core import strategies as jstrategies
from repro.core.round import init_state as jinit_state
from repro.data.synth import make_lm_tokens as jtokens
from repro.exec import ChunkRunner as JRunner
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro_torch import env as tenv
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import client as tclient
from repro_torch.core import strategies as tstrategies
from repro_torch.data.synth import make_lm_tokens as ttokens
from repro_torch.exec.engine import ChunkRunner as TRunner
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import (flatten, leaves, params_from_numpy,
                                    params_to_numpy)

REPO = Path(__file__).resolve().parents[1]
# f32 model: the same ops summed in other orders (XLA vs PyTorch matmuls,
# chunked_attention's kv-chunked online softmax vs the plain softmax)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 64


def _cfgs(dtype):
    return (jreduced(JARCHS["minitron-8b"], dtype=dtype),
            treduced(TARCHS["minitron-8b"], dtype=dtype))


def _batch(cfg):
    toks = jtokens(B, S, cfg.vocab_size, n_topics=2, seed=3)["tokens"]
    return {"tokens": toks}


def _jparams(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(
        seed)))


def _assert_trees_close(t_tree, j_tree, tol):
    jflat = dict(flatten(jax.tree.map(np.asarray, j_tree)))
    tflat = dict(flatten(params_to_numpy(t_tree)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(np.asarray(tflat[k], np.float32),
                                   np.asarray(jflat[k], np.float32),
                                   err_msg=k, **tol)


def test_make_lm_tokens_bitwise_equal_to_jax():
    for args in ((6, 33, 512, 3, 0), (2, 65, 256000, 2, 7)):
        a, b = jtokens(*args), ttokens(*args)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("layers", [2, 1])
def test_reduced_config_and_tree_match_jax(layers):
    """The port's reduced() config and param tree equal JAX's, keys,
    shapes and dtypes; with one layer the body is an empty (None)
    subtree in both, and the loss still runs."""
    for dtype in ("bfloat16", "float32"):
        jcfg, tcfg = _cfgs(dtype)
        jcfg, tcfg = (c.with_(num_layers=layers) for c in (jcfg, tcfg))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = _jparams(jcfg)
    assert (tp["body"] is None) == (jp["body"] is None) == (layers == 1)
    tflat, jflat = dict(flatten(tp)), dict(flatten(jp))
    assert tflat.keys() == jflat.keys()
    for k, x in jflat.items():
        assert tuple(tflat[k].shape) == x.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == str(x.dtype), k
    loss = ttf.loss_fn(params_from_numpy(jp), tcfg,
                       {"tokens": torch.from_numpy(_batch(jcfg)["tokens"])})
    assert torch.isfinite(loss)


def test_params_from_numpy_carries_bf16_bits():
    jp = _jparams(_cfgs("bfloat16")[0])
    tp = params_from_numpy(jp)
    for (k, j), t in zip(flatten(jp), leaves(tp)):
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16), err_msg=k)
    back = params_to_numpy(tp)
    for (k, j), b in zip(flatten(jp), leaves(back)):
        assert b.dtype == j.dtype, k
        np.testing.assert_array_equal(b.view(np.int16), j.view(np.int16))


def test_f32_loss_and_every_gradient_match_jax():
    jcfg, tcfg = _cfgs("float32")
    jp, batch = _jparams(jcfg), _batch(jcfg)
    jloss, jgrad = jax.value_and_grad(jtf.loss_fn)(
        jax.tree.map(jnp.asarray, jp), jcfg,
        {"tokens": jnp.asarray(batch["tokens"])})
    tp = params_from_numpy(jp)
    for x in leaves(tp):
        x.requires_grad_(True)
    tloss = ttf.loss_fn(tp, tcfg,
                        {"tokens": torch.from_numpy(batch["tokens"])})
    tgrad = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **F32_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jgrad)))
    for (k, _), g in zip(flatten(tp), tgrad):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)


def test_bf16_loss_matches_jax():
    """bf16 weights and activations: the packages round at the same
    sites (q * scale in bf16, f32 RMSNorm/RoPE/CE) but accumulate their
    bf16 matmuls differently, so the loss agrees within 2e-2 relative."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, batch = _jparams(jcfg, seed=1), _batch(jcfg)
    jloss = jtf.loss_fn(jax.tree.map(jnp.asarray, jp), jcfg,
                        {"tokens": jnp.asarray(batch["tokens"])})
    tloss = ttf.loss_fn(params_from_numpy(jp), tcfg,
                        {"tokens": torch.from_numpy(batch["tokens"])})
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def _pod_world(rounds_per_call):
    """JAX and port pod rounds of reduced minitron-8b in f32: ama_fes, 2
    cohorts, masked client plane, p_limited 0.5, one batch re-fed to
    every round, params from JAX. Returns [(jax state, jax metrics, port
    state, port metrics)] after each call of ``rounds_per_call`` rounds."""
    jcfg, tcfg = _cfgs("float32")
    kw = dict(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
              p_limited=0.5, lr=0.1, algorithm="ama_fes", seed=0)
    jfl, tfl = JFL(**kw), TFL(**kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    toks = jtokens(2 * 2 * 2, S + 1, jcfg.vocab_size, n_topics=2,
                   seed=0)["tokens"][:, :S].reshape(2, 2, 2, S)
    jstate = jinit_state(jm, jfl, jax.random.PRNGKey(0),
                         jstrategies.resolve(jfl))
    tstate = {"params": params_from_numpy(jax.tree.map(np.asarray,
                                                       jstate["params"])),
              "t": torch.zeros((), dtype=torch.int32), "aux": {}}
    jr = JRunner(jm, jfl, jstrategies.resolve(jfl), per_round_batch=False,
                 donate=False)
    tr = TRunner(tm, tfl, tstrategies.resolve(tfl), per_round_batch=False,
                 device="cpu")
    je, te = jenv.resolve(jfl), tenv.resolve(tfl)
    out = []
    for t0 in range(0, 2, rounds_per_call):
        sj, st = je.batch(t0, rounds_per_call), te.batch(t0, rounds_per_call)
        for k in sj:
            np.testing.assert_array_equal(sj[k], st[k])
        jstate, jm_ = jr.run_chunk(jstate, {"tokens": jnp.asarray(toks)}, sj)
        tstate, tm_ = tr.run_chunk(tstate, {"tokens": toks}, st)
        out.append((jstate, jm_, tstate, tm_))
    return out


def test_one_and_two_pod_rounds_match_jax():
    for jstate, jm, tstate, tm in _pod_world(1):
        assert int(tstate["t"]) == int(jstate["t"])
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                                   **F32_TOL)
        np.testing.assert_array_equal(tm["n_on_time"],
                                      np.asarray(jm["n_on_time"]))
        _assert_trees_close(tstate["params"], jstate["params"], F32_TOL)


def test_pod_chunk_equals_per_round_bitwise():
    """The port's contract on the LLM path: two rounds in one chunk ==
    the same rounds one at a time, bit for bit (CPU, plain versions)."""
    tcfg = _cfgs("float32")[1]
    fl = TFL(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
             p_limited=0.5, lr=0.1, seed=0)
    toks = ttokens(8, S + 1, tcfg.vocab_size, n_topics=2,
                   seed=0)["tokens"][:, :S].reshape(2, 2, 2, S)
    env = tenv.resolve(fl)
    states = []
    for use_scan in (True, False):
        state = {"params": ttf.init_params(
            tcfg, torch.Generator().manual_seed(0)),
            "t": torch.zeros((), dtype=torch.int32), "aux": {}}
        runner = TRunner(tbuild(tcfg), fl, per_round_batch=False,
                         use_scan=use_scan, device="cpu")
        state, m = runner.run_chunk(state, {"tokens": toks}, env.batch(0, 2))
        states.append((state, m))
    (a, ma), (b, mb) = states
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    np.testing.assert_array_equal(ma["loss"], mb["loss"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_sgd_update_equals_the_one_shot_update(monkeypatch, dtype):
    """core/client.py's memory-sliced update against the one-shot f32
    formula, bitwise; the broadcast input params stay untouched."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(3, 7, 5, generator=g).to(dtype)
    p = base.expand(2, 3, 7, 5)
    grad = torch.randn(2, 3, 7, 5, generator=g).to(dtype)
    active = torch.tensor([True, False])
    want = torch.where(active.reshape(2, 1, 1, 1),
                       p.float() - 0.1 * grad.float(), p.float()).to(dtype)
    for slice_elems in (1 << 27, 8, 5):
        monkeypatch.setattr(tclient, "SGD_SLICE", slice_elems)
        before = base.clone()
        got = tclient.sgd_update(p, grad, active, 0.1)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(base, before)


def _run(args, env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **(env or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_pod_launcher_runs_on_cpu_and_refuses_without_a_gpu():
    argv = ["--arch", "minitron-8b", "--pod", "--reduced", "--rounds", "2"]
    p = _run([*argv, "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    assert "minitron-8b (2 layers, d_model 256) on cpu" in p.stdout
    assert "round 1: loss=" in p.stdout and "phases: compile=" in p.stdout
    if not torch.cuda.is_available():
        p = _run(argv)
        assert p.returncode != 0 and "no CUDA device" in p.stderr
