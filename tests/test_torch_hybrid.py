"""The hybrid family (zamba2-1.2b: Mamba-2 blocks and one shared
attention block) in the port against the JAX package, at reduced() size
on the CPU.

The reduced config has 2 layers, one body block and one tail block: the
body is shorter than ``attn_every`` (2), so the shared attention would
never run. These tests take it at 6 layers: a body of 5 blocks (2
shared-attention sites and a remainder block) and a tail of 1.
Parameters start in JAX and cross through numpy; on the CPU the port's
kernels (the mamba2 recurrence, flash attention, the serving kernels)
run their plain versions. Held here: the config's fields; the tree, its
``jax.tree`` order and its two dtype groups flattened as JAX's server
plane flattens them; f32 logits, loss and every gradient; the bf16 loss;
``decode_step`` with the shared attention's caches; pod rounds against
JAX's ``ChunkRunner`` on the masked and partitioned client planes;
chunked == per-round and remat on == off, bitwise; the launchers; the
engines' tokens against JAX's loop engine; paged serving refused.
"""
import dataclasses

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
from repro.kernels import server_plane as jsp
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro.serve import LoopEngine as JLoop
from repro.serve import Request as JRequest
from repro_torch import env as tenv
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import strategies as tstrategies
from repro_torch.core.round import init_state as tinit_state
from repro_torch.exec.engine import ChunkRunner as TRunner
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import LoopEngine, PagedEngine, Request
from repro_torch.utils.tree import (cat, dtype_groups, flatten, leaves,
                                    params_from_numpy, params_to_numpy)

ARCH = "zamba2-1.2b"
# f32: the same math summed in other orders (XLA's matmuls, einsums and
# chunked attention against the port's plain versions)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 64
LAYERS = 6


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    kw = {"num_layers": LAYERS, "dtype": dtype, **kw}
    return jreduced(JARCHS[ARCH], **kw), treduced(TARCHS[ARCH], **kw)


def _jparams(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(
        seed)))


def _batch(cfg):
    return jtokens(B, S, cfg.vocab_size, n_topics=2, seed=3)["tokens"]


def _assert_trees_close(t_tree, j_tree, tol):
    jflat = dict(flatten(jax.tree.map(np.asarray, j_tree)))
    tflat = dict(flatten(params_to_numpy(t_tree)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(np.asarray(tflat[k], np.float32),
                                   np.asarray(jflat[k], np.float32),
                                   err_msg=k, **tol)


# ------------------------------------------------------ config and tree ----

def test_config_fields_equal_jax():
    """Every field equal to the JAX file's (source, attn_every,
    shared_attn, ssm_state among them), at full width and reduced; the
    reduced config's sites: none at 2 layers, 2 in the body at 6."""
    j, t = JARCHS[ARCH], TARCHS[ARCH]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(treduced(t)) == dataclasses.asdict(jreduced(j))
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (t.family, t.attn_every, t.ssm_state) == ("hybrid", 6, 64)
    assert ttf._shared_groups(treduced(t), 1, {}) == 0
    assert ttf._shared_groups(tcfg, 5, {}) == 2
    assert ttf._shared_groups(tcfg, 1, {}) == 0          # the tail
    assert ttf._shared_groups(t, 36, {}) == 6


def test_tree_order_and_dtype_groups_match_jax():
    """The bf16 tree: JAX's keys, shapes and dtypes in ``jax.tree`` order
    (..., lm_head, shared_attn, tail), its two dtype groups (bf16 and the
    mamba blocks' f32 A_log, D, dt_bias) flattened as JAX's server plane
    does, element for element, and a finite loss on JAX's params."""
    jcfg, tcfg = _cfgs("bfloat16")
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = _jparams(jcfg)
    tflat, jflat = flatten(tp), flatten(jp)
    assert [k for k, _ in tflat] == [k for k, _ in jflat]
    assert [k for k, _ in jflat] == [
        "/".join(str(getattr(e, "key", e)) for e in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(dict.fromkeys(k.split("/")[0] for k, _ in jflat))[-3:] == [
        "lm_head", "shared_attn", "tail"]
    for (k, x), (_, y) in zip(jflat, tflat):
        assert tuple(y.shape) == x.shape, k
        assert str(y.dtype).split(".")[-1] == str(x.dtype), k
    jl = jax.tree.leaves(jp)
    tl = leaves(params_from_numpy(jp))
    jg, tg = jsp._dtype_groups(jl), dtype_groups(tl)
    assert [str(d) for d in jg] == ["bfloat16", "float32"]
    for (_, jidx), (_, tidx) in zip(jg.items(), tg.items(), strict=True):
        assert jidx == tidx
        jv = np.asarray(jsp._cat([jnp.ravel(jnp.asarray(jl[i]))
                                  for i in jidx]))
        tv = cat([tl[i].reshape(-1) for i in tidx])
        if tv.dtype == torch.bfloat16:
            np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                          jv.view(np.int16))
        else:
            np.testing.assert_array_equal(tv.numpy(), jv)
    loss = ttf.loss_fn(params_from_numpy(jp), tcfg,
                       {"tokens": torch.from_numpy(_batch(jcfg))})
    assert torch.isfinite(loss)


def test_shared_attention_lies_in_the_feature_extractor():
    """Under FES the shared attention is body (not classifier) in both
    packages: ``fes_mask`` leaf for leaf."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(jcfg)
    jmask = dict(flatten(jbuild(jcfg).fes_mask(jp)))
    tmask = dict(flatten(tbuild(tcfg).fes_mask(params_from_numpy(jp))))
    assert jmask == tmask
    assert not any(v for k, v in tmask.items() if k.startswith("shared"))
    assert all(v for k, v in tmask.items() if k.startswith("tail"))


# --------------------------------------------------------------- training --

def test_f32_logits_loss_and_every_gradient_match_jax():
    jcfg, tcfg = _cfgs()
    jp, toks = _jparams(jcfg), _batch(jcfg)
    jb = {"tokens": jnp.asarray(toks)}
    jlogits = jax.jit(jtf.forward, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, jb)[0]
    jloss, jgrad = jax.jit(jax.value_and_grad(jtf.loss_fn),
                           static_argnums=1)(jax.tree.map(jnp.asarray, jp),
                                             jcfg, jb)
    tp = params_from_numpy(jp)
    tb = {"tokens": torch.from_numpy(toks)}
    np.testing.assert_allclose(ttf.forward(tp, tcfg, tb)[0].numpy(),
                               np.asarray(jlogits), **F32_TOL)
    for x in leaves(tp):
        x.requires_grad_(True)
    tloss = ttf.loss_fn(tp, tcfg, tb)
    tgrad = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **F32_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jgrad)))
    for (k, _), g in zip(flatten(tp), tgrad, strict=True):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)


def test_bf16_loss_matches_jax():
    """bf16 weights and activations: the packages round at the same sites
    but accumulate their bf16 matmuls and the conv differently, so the
    loss agrees within 2e-2 relative (the dense family's bound)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, toks = _jparams(jcfg, seed=1), _batch(jcfg)
    jloss = jax.jit(jtf.loss_fn, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, {"tokens": jnp.asarray(toks)})
    tloss = ttf.loss_fn(params_from_numpy(jp), tcfg,
                        {"tokens": torch.from_numpy(toks)})
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def _pod_world(rounds_per_call, **fl_kw):
    """JAX and port pod rounds of the reduced zamba2 in f32: ama_fes, 2
    cohorts x 2 local steps, p_limited 0.5, one batch re-fed to every
    round, params from JAX. Returns [(jax state, jax metrics, port state,
    port metrics)] after each call of ``rounds_per_call`` rounds."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
              p_limited=0.5, lr=0.1, algorithm="ama_fes", seed=0, **fl_kw)
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
        jstate, jm_ = jr.run_chunk(jstate, {"tokens": jnp.asarray(toks)}, sj)
        tstate, tm_ = tr.run_chunk(tstate, {"tokens": toks}, st)
        out.append((jstate, jm_, tstate, tm_))
    return out


@pytest.mark.parametrize("plane,per_call", [("masked", 1),
                                            ("partitioned", 2)])
def test_pod_rounds_match_jax(plane, per_call):
    """One and two rounds (masked, one round a call) and two rounds in
    one chunk (partitioned: limited cohorts run the classifier program,
    the body with its shared attention forward only) against JAX's."""
    for jstate, jm, tstate, tm in _pod_world(per_call, client_plane=plane):
        assert int(tstate["t"]) == int(jstate["t"])
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                                   **F32_TOL)
        _assert_trees_close(tstate["params"], jstate["params"], F32_TOL)


def _pod_run(cfg, use_scan=True, rounds=3):
    fl = TFL(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
             p_limited=0.5, lr=0.1, algorithm="ama_fes", seed=0)
    model = tbuild(cfg)
    toks = jtokens(2 * 2 * 2, S, cfg.vocab_size, n_topics=2,
                   seed=0)["tokens"].reshape(2, 2, 2, S)
    state = tinit_state(model, fl, torch.Generator().manual_seed(0), "cpu",
                        tstrategies.resolve(fl))
    runner = TRunner(model, fl, tstrategies.resolve(fl),
                     per_round_batch=False, use_scan=use_scan, device="cpu")
    return runner.run_chunk(state, {"tokens": toks},
                            dict(tenv.resolve(fl).batch(0, rounds)))


def _bitwise(a, b):
    (sa, ma), (sb, mb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(
        leaves(sa["params"]), leaves(sb["params"]), strict=True))
    assert list(ma["loss"]) == list(mb["loss"])


def test_pod_chunk_equals_per_round_bitwise():
    """The port's contract on the hybrid path: three bf16 rounds in one
    chunk == the same rounds one at a time, bit for bit (two server-plane
    dtype groups)."""
    cfg = _cfgs("bfloat16")[1]
    _bitwise(_pod_run(cfg, True), _pod_run(cfg, False))


def test_remat_on_equals_off_bitwise():
    """Remat changes memory, not values: two f32 rounds with each mamba
    block under ``_BlockRemat`` and without give the same params and
    losses, bit for bit."""
    cfg = _cfgs()[1]
    assert cfg.remat
    _bitwise(_pod_run(cfg, rounds=2), _pod_run(cfg.with_(remat=False),
                                               rounds=2))


# ---------------------------------------------------------------- serving --

def _ids(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def test_decode_steps_match_jax():
    """f32 ``decode_step`` over 5 tokens from JAX's cache: logits and
    every cache leaf (the mamba blocks' ssm and conv states, the 2
    shared-attention sites' KV caches in ``shared``) after each step."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(jcfg, seed=2)
    tp = params_from_numpy(jp)
    jcache = jtf.init_decode_cache(jcfg, B, 16)
    tcache = ttf.init_decode_cache(tcfg, B, 16)
    assert list(tcache) == ["body", "tail", "shared"]
    assert tcache["shared"]["k"].shape == (2, B, 16, 2, 64)
    assert dict(flatten(jax.tree.map(lambda a: a.shape, jcache))) == {
        k: tuple(v.shape) for k, v in flatten(tcache)}
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (5, B))
    step = jax.jit(jtf.decode_step, static_argnums=1)
    for t in range(5):
        pos = np.full((B,), t, np.int32)
        jl, jcache = step(jax.tree.map(jnp.asarray, jp), jcfg,
                          jnp.asarray(toks[t]), jnp.asarray(pos), jcache)
        tl, tcache = ttf.decode_step(tp, tcfg, _ids(toks[t]), _ids(pos),
                                     tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        jflat = dict(flatten(jax.tree.map(np.asarray, jcache)))
        for k, v in flatten(tcache):
            np.testing.assert_allclose(v.float().numpy(),
                                       jflat[k].astype(np.float32),
                                       err_msg=f"{k} step {t}", **F32_TOL)


def _reqs(vocab, lens, max_new, cls):
    rng = np.random.RandomState(7)
    return [cls(rid=i, prompt=[int(x) for x in rng.randint(0, vocab, n)],
                max_new=max_new) for i, n in enumerate(lens)]


def test_loop_engine_serves_jax_engines_tokens():
    """The port's loop engine serves the JAX loop engine's tokens for the
    same f32 params; the paged engine refuses the family by name."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(jcfg, seed=4)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    lens, new = [5, 9, 7], 4
    want = [r["tokens"] for r in JLoop(jm, jax.tree.map(jnp.asarray, jp)).run(
        _reqs(jcfg.vocab_size, lens, new, JRequest))]
    got = [r["tokens"] for r in LoopEngine(tm, params_from_numpy(jp)).run(
        _reqs(tcfg.vocab_size, lens, new, Request))]
    assert got == want
    assert tm.prefill is None and tm.decode_step_paged is None
    with pytest.raises(ValueError, match="'hybrid' has no paged serving"):
        PagedEngine(tm, params_from_numpy(jp), max_slots=2, block_size=4)


def test_launchers_run_zamba2_on_the_cpu(capsys):
    """``launch.train --arch zamba2-1.2b --pod --reduced --device cpu``
    and ``launch.serve --arch zamba2-1.2b --reduced --device cpu`` (the
    loop engine); ``--engine paged`` refused by name."""
    state, metrics, _ = ttrain.main(["--arch", ARCH, "--pod", "--reduced",
                                     "--rounds", "1", "--device", "cpu"])
    assert int(state["t"]) == 1 and np.isfinite(metrics["loss"]).all()
    assert len(dtype_groups(leaves(state["params"]))) == 2
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--prompt-mix", "6x1,9x1", "--tokens", "3"])
    assert [r["new_tokens"] for r in res] == [3, 3]
    assert "engine=loop served 2 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="'hybrid' has no paged serving"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--engine", "paged"])


def test_chip_smoke_plans_zamba2s_launches():
    """chip_smoke.py's launch plan at zamba2's full depth (38 layers, 36
    body blocks, 6 shared-attention sites, tail 2): a masked round runs
    mamba2_fwd 38 x 2 steps x 2 (remat), mamba2_bwd 76 and each flash
    kernel 6 sites x 2 steps (outside remat); a round with a limited
    cohort on the partitioned plane adds the classifier program (the
    body's blocks and sites forward once, no backward)."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import mamba2_scan as tms
    cfg = cs.llm_full_width(cs.ZAMBA)
    assert (cfg.num_layers, cfg.fes_tail_layers, cfg.remat) == (38, 2, True)
    km = cs.KernelSet(tms, tfa)
    masked = cs.plan_launches(cs.ZAMBA, cfg, km, [np.zeros((3, 2), bool)],
                              False)
    assert masked == {"mamba2_fwd": 3 * 152, "mamba2_bwd": 3 * 76,
                      "flash_fwd": 36, "flash_bwd_dq": 36,
                      "flash_bwd_dkdv": 36}
    part = cs.plan_launches(cs.ZAMBA, cfg, km,
                            [np.array([[True, False]])], True)
    # a step: the masked program 38 x 2, the classifier program the tail
    # 2 x 2 and the body 36 once
    assert part == {"mamba2_fwd": 2 * (38 * 2 + 2 * 2 + 36),
                    "mamba2_bwd": 2 * (38 + 2), "flash_fwd": 2 * (6 + 6),
                    "flash_bwd_dq": 2 * 6, "flash_bwd_dkdv": 2 * 6}
