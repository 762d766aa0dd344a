"""The moe family (phi3.5-moe, mixtral-8x22b) and the large dense configs
(llama3-405b, mistral-large-123b, qwen1.5-110b) in the port against the
JAX package, at reduced() size on the CPU.

Parameters start in JAX and cross through numpy; on the CPU the port's
kernels run their plain versions. Held here: the configs' fields and
the reduced trees; f32 loss and every gradient; one and two pod rounds
against JAX's ``ChunkRunner``; the moe tree's two dtype groups (bf16 and
the f32 router) flattened as JAX's server plane flattens them; chunked
== per-round bitwise; the serving steps against JAX's ``decode_step`` /
``prefill`` / the paged pair; paged == dense and chunked == per token
bitwise; the served tokens equal JAX's engines'; a JAX round-state
checkpoint of a moe tree served through the port; both launchers for all
five configs; the vlm and audio configs accepted (their own tests:
tests/test_torch_vlm.py, tests/test_torch_encdec.py), and the hybrid
config accepted (its own tests: tests/test_torch_hybrid.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import env as jenv
from repro.checkpoint.io import save_state as jsave_state
from repro.configs.base import FLConfig as JFL
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import serving_config as jserving_config
from repro.core import strategies as jstrategies
from repro.core.round import init_state as jinit_state
from repro.data.synth import make_lm_tokens as jtokens
from repro.exec import ChunkRunner as JRunner
from repro.kernels import server_plane as jsp
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro.serve import LoopEngine as JLoop
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch import env as tenv
from repro_torch.checkpoint.io import restore_params
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import serving_config
from repro_torch.core import strategies as tstrategies
from repro_torch.exec.engine import ChunkRunner as TRunner
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import LoopEngine, PagedEngine, Request
from repro_torch.utils.tree import (cat, dtype_groups, flatten, leaves,
                                    params_from_numpy, params_to_numpy)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 64
MOE = ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b")
DENSE = ("llama3-405b", "mistral-large-123b", "qwen1.5-110b")
NEW = MOE + DENSE
#: the configs held in f32 against JAX: both moe configs, the biased qkv
#: and llama3's rope theta (mistral-large differs from minitron-8b only in
#: widths, which reduced() cuts alike)
AGAINST_JAX = ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b", "qwen1.5-110b",
               "llama3-405b")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    jcfg = jreduced(JARCHS[arch], dtype=dtype, **kw)
    tcfg = treduced(TARCHS[arch], dtype=dtype, **kw)
    return jcfg, tcfg


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


# ------------------------------------------------------------ configs ----

@pytest.mark.parametrize("arch", NEW)
def test_config_fields_equal_jax(arch):
    """Every field equal to the JAX file's (source, window, rope theta,
    qkv bias, experts, top_k, capacity factor and group size among
    them), at full width, reduced, and as served."""
    j, t = JARCHS[arch], TARCHS[arch]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(treduced(t)) == dataclasses.asdict(jreduced(j))
    assert dataclasses.asdict(serving_config(arch)) == dataclasses.asdict(
        jserving_config(arch))
    assert t.family == ("moe" if arch in MOE else "dense")


@pytest.mark.parametrize("arch", NEW)
def test_reduced_tree_matches_jax(arch):
    """The port's tree at reduced size: JAX's keys, shapes and dtypes (a
    moe block's ``moe`` in place of ``mlp``, its router f32), and a
    finite bf16 loss on JAX's params."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = _jparams(jcfg)
    tflat, jflat = dict(flatten(tp)), dict(flatten(jp))
    assert tflat.keys() == jflat.keys()
    for k, x in jflat.items():
        assert tuple(tflat[k].shape) == x.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == str(x.dtype), k
    assert ("tail/moe/router/w" in tflat) == (arch in MOE)
    loss = ttf.loss_fn(params_from_numpy(jp), tcfg,
                       {"tokens": torch.from_numpy(_batch(jcfg))})
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", AGAINST_JAX)
def test_f32_loss_and_every_gradient_match_jax(arch):
    """f32 loss (CE + 0.01 x the moe aux) and every gradient within
    F32_TOL. mixtral's reduced window (64) is cut to 16 here so that it
    bites at S = 64."""
    kw = {"sliding_window": 16} if arch == "mixtral-8x22b" else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, toks = _jparams(jcfg), _batch(jcfg)
    jloss, jgrad = jax.value_and_grad(jtf.loss_fn)(
        jax.tree.map(jnp.asarray, jp), jcfg, {"tokens": jnp.asarray(toks)})
    tp = params_from_numpy(jp)
    for x in leaves(tp):
        x.requires_grad_(True)
    tloss = ttf.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    tgrad = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **F32_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jgrad)))
    for (k, _), g in zip(flatten(tp), tgrad, strict=True):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)


def test_moe_dtype_groups_flatten_as_jax():
    """A bf16 moe tree has two dtype groups, bf16 and the f32 router; its
    JAX params cross over so that each group's flat vector (the server
    plane's operand) is JAX's, element for element."""
    jcfg, _ = _cfgs("phi3.5-moe-42b-a6.6b", "bfloat16")
    jp = _jparams(jcfg)
    jl = jax.tree.leaves(jp)
    tl = leaves(params_from_numpy(jp))
    jg, tg = jsp._dtype_groups(jl), dtype_groups(tl)
    assert [str(d) for d in jg] == ["bfloat16", "float32"]
    assert [str(d) for d in tg] == ["torch.bfloat16", "torch.float32"]
    for (ji, jidx), (ti, tidx) in zip(jg.items(), tg.items(), strict=True):
        assert jidx == tidx
        jflat = np.asarray(jsp._cat([jnp.ravel(jnp.asarray(jl[i]))
                                     for i in jidx]))
        tflat = cat([tl[i].reshape(-1) for i in tidx])
        if tflat.dtype == torch.bfloat16:
            np.testing.assert_array_equal(tflat.view(torch.int16).numpy(),
                                          jflat.view(np.int16))
        else:
            np.testing.assert_array_equal(tflat.numpy(), jflat)


# ----------------------------------------------------------- pod rounds ----

def _pod_world(arch, rounds_per_call, algorithm="ama_fes"):
    """JAX and port pod rounds of the reduced arch in f32: 2 cohorts x 2
    local steps, masked client plane, p_limited 0.5, one batch re-fed to
    every round, params from JAX. Returns [(jax state, jax metrics, port
    state, port metrics)] after each call of ``rounds_per_call`` rounds."""
    jcfg, tcfg = _cfgs(arch)
    kw = dict(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
              p_limited=0.5, lr=0.1, algorithm=algorithm, seed=0)
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


@pytest.mark.parametrize("arch", AGAINST_JAX)
def test_one_and_two_pod_rounds_match_jax(arch):
    for jstate, jm, tstate, tm in _pod_world(arch, 1):
        assert int(tstate["t"]) == int(jstate["t"])
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                                   **F32_TOL)
        _assert_trees_close(tstate["params"], jstate["params"], F32_TOL)


@pytest.mark.parametrize("group", [0, 32])
def test_moe_pod_chunk_equals_per_round_bitwise(group):
    """The port's contract on the moe path: three rounds in one chunk ==
    the same rounds one at a time, bit for bit (bf16, the f32 router a
    second server-plane group), through the global dispatch (T 128 per
    cohort) and the blocked one (groups of 32 tokens)."""
    from repro_torch.core.round import init_state
    tcfg = _cfgs("phi3.5-moe-42b-a6.6b", "bfloat16")[1].with_(
        moe_group_size=group)
    fl = TFL(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
             p_limited=0.5, lr=0.1, algorithm="ama_fes", seed=0)
    model = tbuild(tcfg)
    toks = jtokens(2 * 2 * 2, S, tcfg.vocab_size, n_topics=2,
                   seed=0)["tokens"].reshape(2, 2, 2, S)
    sb = tenv.resolve(fl).batch(0, 3)
    out = []
    for use_scan in (True, False):
        state = init_state(model, fl, torch.Generator().manual_seed(0),
                           "cpu", tstrategies.resolve(fl))
        runner = TRunner(model, fl, tstrategies.resolve(fl),
                         per_round_batch=False, use_scan=use_scan,
                         device="cpu")
        out.append(runner.run_chunk(state, {"tokens": toks}, dict(sb)))
    (a, ma), (b, mb) = out
    assert len(dtype_groups(leaves(a["params"]))) == 2
    assert all(torch.equal(x, y) for x, y in zip(
        leaves(a["params"]), leaves(b["params"]), strict=True))
    assert list(ma["loss"]) == list(mb["loss"])


# -------------------------------------------------------------- serving ----

def _ids(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _serve_cfgs(arch):
    """f32 serving configs; mixtral's window cut to 8 so the ring wraps
    within the prompts below."""
    jcfg, tcfg = _cfgs(arch)
    if arch == "mixtral-8x22b":
        jcfg, tcfg = (c.with_(sliding_window=8) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.mark.parametrize("arch", MOE)
def test_moe_serving_steps_match_jax(arch):
    """decode_step, prefill (c 5, a ragged last chunk), decode_step_paged
    and prefill_paged over 11 tokens against JAX's jitted steps: logits
    every step within F32_TOL, positions in the caches exact."""
    jcfg, tcfg = _serve_cfgs(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = _jparams(jcfg)
    tp = params_from_numpy(jp)
    P, max_len, bs, c = 11, 20, 4, 5
    prompts = np.random.RandomState(5).randint(1, jcfg.vocab_size, (B, P))
    L = min(max_len, jcfg.sliding_window or max_len)
    mb = -(-L // bs)
    table = np.arange(1, 1 + B * mb, dtype=np.int32).reshape(B, mb)
    ring = np.full((B,), L, np.int32)
    nb = 1 + B * mb
    close = lambda t, j, msg: np.testing.assert_allclose(  # noqa: E731
        t.numpy(), np.asarray(j), err_msg=msg, **F32_TOL)

    jc, tc = jm.init_decode_cache(jp, B, max_len), tm.init_decode_cache(
        tp, B, max_len)
    jpool, tpool = jm.init_paged_pool(nb, bs), tm.init_paged_pool(nb, bs)
    jstep, jpaged = jax.jit(jm.decode_step), jax.jit(jm.decode_step_paged)
    for t in range(P):
        tok, pos = prompts[:, t], np.full((B,), t)
        jl, jc = jstep(jp, jnp.asarray(tok, jnp.int32),
                       jnp.asarray(pos, jnp.int32), jc)
        tl, tc = tm.decode_step(tp, _ids(tok), _ids(pos), tc)
        close(tl, jl, f"decode logits t={t}")
        jl, jpool = jpaged(jp, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32), jpool,
                           jnp.asarray(table), jnp.asarray(ring))
        tl, tpool = tm.decode_step_paged(tp, _ids(tok), _ids(pos), tpool,
                                         _ids(table), _ids(ring))
        close(tl, jl, f"paged logits t={t}")
    for g in ("body", "tail"):
        if tc[g] is not None:
            np.testing.assert_array_equal(tc[g]["pos"].numpy(),
                                          np.asarray(jc[g]["pos"]))

    jc, tc = jm.init_decode_cache(jp, B, max_len), tm.init_decode_cache(
        tp, B, max_len)
    jpool, tpool = jm.init_paged_pool(nb, bs), tm.init_paged_pool(nb, bs)
    jpf, jppf = jax.jit(jm.prefill), jax.jit(jm.prefill_paged)
    for t0 in range(0, P, c):
        n = min(c, P - t0)
        toks = np.zeros((B, c), np.int32)
        poss = np.full((B, c), tref.PAD_POS, np.int32)
        toks[:, :n] = prompts[:, t0:t0 + n]
        poss[:, :n] = np.arange(t0, t0 + n)
        jl, jc = jpf(jp, jnp.asarray(toks), jnp.asarray(poss), jc)
        tl, tc = tm.prefill(tp, _ids(toks), _ids(poss), tc)
        close(tl[:, :n], np.asarray(jl)[:, :n], "prefill")
        jl, jpool = jppf(jp, jnp.asarray(toks), jnp.asarray(poss), jpool,
                         jnp.asarray(table), jnp.asarray(ring))
        tl, tpool = tm.prefill_paged(tp, _ids(toks), _ids(poss), tpool,
                                     _ids(table), _ids(ring))
        close(tl[:, :n], np.asarray(jl)[:, :n], "paged prefill")


def _per_token(model, params, prompts, max_len):
    Bn, P = prompts.shape
    cache = model.init_decode_cache(params, Bn, max_len)
    outs = []
    for t in range(P):
        lg, cache = model.decode_step(params, _ids(prompts[:, t]),
                                      _ids(np.full((Bn,), t)), cache)
        outs.append(lg)
    return torch.stack(outs, 1), cache


@pytest.mark.parametrize("arch", MOE)
def test_moe_chunked_and_paged_equal_per_token_bitwise(arch):
    """bf16: chunked prefill == the per-token loop (logits and cache) and
    the paged pair == the dense cache path, bit for bit (mixtral's ring
    of 8 wraps within the 12-token prompts)."""
    tcfg = _serve_cfgs(arch)[1].with_(dtype="bfloat16")
    model = tbuild(tcfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    Bn, P, max_len, bs, c = 2, 12, 24, 4, 5
    prompts = np.random.RandomState(0).randint(1, tcfg.vocab_size, (Bn, P))
    ref, ref_c = _per_token(model, params, prompts, max_len)

    cache = model.init_decode_cache(params, Bn, max_len)
    L = min(max_len, tcfg.sliding_window or max_len)
    mb = L // bs
    table = _ids(np.arange(1, 1 + Bn * mb).reshape(Bn, mb))
    lw = _ids(np.full((Bn,), L))
    pool = model.init_paged_pool(1 + Bn * mb, bs)
    lgs, plgs = [], []
    for t0 in range(0, P, c):
        n = min(c, P - t0)
        toks = np.zeros((Bn, c), np.int32)
        poss = np.full((Bn, c), tref.PAD_POS, np.int32)
        toks[:, :n] = prompts[:, t0:t0 + n]
        poss[:, :n] = np.arange(t0, t0 + n)
        lg, cache = model.prefill(params, _ids(toks), _ids(poss), cache)
        lgs.append(lg[:, :n])
        lg, pool = model.prefill_paged(params, _ids(toks), _ids(poss), pool,
                                       table, lw)
        plgs.append(lg[:, :n])
    assert torch.equal(ref, torch.cat(lgs, 1))
    assert all(torch.equal(x, y) for x, y in zip(leaves(ref_c), leaves(cache),
                                                 strict=True))
    assert torch.equal(ref, torch.cat(plgs, 1))


def _reqs(vocab, lens, max_new, cls):
    rng = np.random.RandomState(1)
    return [cls(rid=i, max_new=max_new,
                prompt=rng.randint(1, vocab, (ln,)).tolist())
            for i, ln in enumerate(lens)]


@pytest.fixture(scope="module")
def moe_pair():
    """Reduced phi3.5-moe in f32 with JAX's params in both packages."""
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    jp = _jparams(jcfg)
    return jbuild(jcfg), jp, tbuild(tcfg), params_from_numpy(jp)


def test_moe_served_tokens_match_jax_engines(moe_pair):
    """The port's three engines serve JAX's engines' tokens for the same
    moe params, with more requests than slots."""
    jm, jp, tm, tp = moe_pair
    vocab, lens, max_new = jm.cfg.vocab_size, [5, 11, 8, 14, 6], 5
    want = [r["tokens"] for r in JPaged(
        jm, jp, max_slots=2, block_size=4, prefill_chunk=4).run(
        _reqs(vocab, lens, max_new, JRequest))]
    assert want == [r["tokens"] for r in JLoop(jm, jp).run(
        _reqs(vocab, lens, max_new, JRequest))]
    for eng in (LoopEngine(tm, tp), LoopEngine(tm, tp, prefill_chunk=4),
                PagedEngine(tm, tp, max_slots=2, block_size=4,
                            prefill_chunk=4)):
        assert [r["tokens"] for r in eng.run(
            _reqs(vocab, lens, max_new, Request))] == want


def test_jax_moe_round_state_checkpoint_serves_through_port(moe_pair,
                                                            tmp_path):
    """A {params, t, aux} round-state file of a moe tree (bf16 and f32
    leaves) written by the JAX package restores through the port's
    restore_params and serves the tokens of the params themselves."""
    jm, jp, tm, tp = moe_pair
    path = str(tmp_path / "round.npz")
    jsave_state(path, {"params": jp, "t": np.int32(3), "aux": {}})
    zero = jax.tree.map(lambda a: np.zeros_like(a), jp)
    back = restore_params(path, params_from_numpy(zero))
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(tp)))
    reqs = lambda: _reqs(jm.cfg.vocab_size, [6, 13], 4, Request)  # noqa
    eng = lambda p: PagedEngine(tm, p, max_slots=2, block_size=4,  # noqa
                                prefill_chunk=4)
    assert [r["tokens"] for r in eng(back).run(reqs())] == \
        [r["tokens"] for r in eng(tp).run(reqs())]


# ------------------------------------------------------------ launchers ----

@pytest.mark.parametrize("arch", NEW)
def test_launchers_run_the_arch_on_the_cpu(arch, capsys):
    """``launch.train --pod --reduced --device cpu`` and ``launch.serve
    --reduced --device cpu --engine paged`` for each config; without
    --device, on a machine with no CUDA device, both refuse (exit 2)."""
    state, metrics, _ = ttrain.main(["--arch", arch, "--pod", "--reduced",
                                     "--rounds", "1", "--device", "cpu"])
    assert int(state["t"]) == 1 and np.isfinite(metrics["loss"]).all()
    groups = len(dtype_groups(leaves(state["params"])))
    assert groups == (2 if arch in MOE else 1)
    res = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--engine", "paged", "--prompt-mix", "6x1,9x1",
                       "--tokens", "3"])
    assert [r["new_tokens"] for r in res] == [3, 3]
    assert "engine=paged served 2 requests" in capsys.readouterr().out
    if torch.cuda.is_available():
        return
    for main, argv in ((ttrain.main, ["--pod"]), (tserve.main, [])):
        with pytest.raises(SystemExit) as e:
            main(["--arch", arch, "--reduced", *argv])
        assert e.value.code == 2


@pytest.mark.parametrize("arch,family", [("phi-3-vision-4.2b", "vlm"),
                                         ("whisper-medium", "audio")])
def test_later_families_are_still_refused(arch, family):
    """The JAX package's vlm and audio configs, copied field by field
    into the port's ModelConfig, equal the port's own and build a model
    (the last two families, ported with their slice): the vlm on the
    decoder stack, with chunked prefill and the paged path; the audio
    family on ``models/encdec.py``, which the decoder stack still refuses
    by name, with chunked prefill and no paged path (as in JAX). A
    family the port does not know is refused by name."""
    cfg = TModelConfig(**dataclasses.asdict(JARCHS[arch]))
    assert cfg.family == family and cfg == TARCHS[arch]
    model = tbuild(cfg)
    assert model.prefill is not None
    assert (model.init_paged_pool is not None) == (family == "vlm")
    if family == "audio":
        with pytest.raises(NotImplementedError, match="encdec"):
            ttf.check_family(cfg)
    else:
        ttf.check_family(cfg)
    for fn in (ttf.check_family, tbuild):
        with pytest.raises(NotImplementedError, match="'bogus'"):
            fn(cfg.with_(family="bogus"))


def test_hybrid_config_is_accepted_and_equals_jax():
    """The JAX package's zamba2-1.2b config, copied field by field into
    the port's ModelConfig, equals the port's own and builds a model (the
    hybrid family, ported with its slice)."""
    cfg = TModelConfig(**dataclasses.asdict(JARCHS["zamba2-1.2b"]))
    assert cfg == TARCHS["zamba2-1.2b"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JARCHS["zamba2-1.2b"])
    ttf.check_family(cfg)
    model = tbuild(cfg)
    assert cfg.family == "hybrid" and model.decode_step is not None
    assert model.prefill is None and model.init_paged_pool is None
