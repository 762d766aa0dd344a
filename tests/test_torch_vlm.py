"""The vlm family (phi-3-vision-4.2b: the dense stack behind a projection
of precomputed patch embeddings) in the port against the JAX package, at
reduced() size on the CPU.

The reduced config: 2 layers (body 1, tail 1), d_model 256, 4 query
heads of 64 over 4 kv heads (MHA, as the full config), 16 patches of
128. A batch carries non-zero ``patch_emb`` (numpy-seeded), so
``vision_proj`` and the patch rows take part in every comparison; 16
patches + 50 tokens give 66 rows, a ragged length for the flash
kernels' plain versions. Parameters start in JAX and cross through
numpy. Held here: the config's fields; the tree in ``jax.tree`` order
and ``vision_proj`` in the FES feature extractor; f32 logits, loss (on
the text segment only) and every gradient at rtol 1e-4, atol 1e-5 (the
same math summed in other orders); the bf16 loss within 2e-2; one pod
round of ama_fes on the masked and partitioned client planes against
JAX's ``ChunkRunner``; chunked == per round and remat on == off,
bitwise; ``decode_step`` and ``prefill`` (tokens only, as JAX serves the
family) against JAX's; chunked prefill == the per-token loop and paged
== loop, bitwise; the engines' tokens against JAX's loop engine; the
launchers.
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
from repro_torch.utils.tree import (flatten, leaves, params_from_numpy,
                                    params_to_numpy)

ARCH = "phi-3-vision-4.2b"
# f32: the same math summed in other orders (XLA's matmuls and chunked
# attention against the port's plain versions)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 50


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    kw = {"dtype": dtype, **kw}
    return jreduced(JARCHS[ARCH], **kw), treduced(TARCHS[ARCH], **kw)


def _jparams(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(
        seed)))


def _batch(cfg, lead=(B,), seed=3):
    """{"tokens": lead + (S,) int32, "patch_emb": lead + (P, vision_dim)
    f32, N(0, 1)}, numpy."""
    n = int(np.prod(lead))
    toks = jtokens(n, S, cfg.vocab_size, n_topics=2, seed=seed)["tokens"]
    pe = np.random.RandomState(seed).randn(
        n, cfg.num_patches, cfg.vision_dim).astype(np.float32)
    return {"tokens": toks.reshape(*lead, S),
            "patch_emb": pe.reshape(*lead, cfg.num_patches, cfg.vision_dim)}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


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
    """Every field equal to the JAX file's (num_patches 576, vision_dim
    1024, head_dim 96 among them), at full width and reduced."""
    j, t = JARCHS[ARCH], TARCHS[ARCH]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(treduced(t)) == dataclasses.asdict(jreduced(j))
    assert (t.family, t.num_patches, t.vision_dim, t.head_dim) == (
        "vlm", 576, 1024, 96)


def test_tree_order_and_fes_mask_match_jax():
    """JAX's keys, shapes and dtypes in ``jax.tree`` order (the port's
    own init too), ``vision_proj`` (vision_dim, d_model) among them and
    in the feature extractor under FES, as in JAX."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = _jparams(jcfg)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    jflat, tflat = flatten(jp), flatten(tp)
    assert [k for k, _ in tflat] == [k for k, _ in jflat]
    for (k, x), (_, y) in zip(jflat, tflat):
        assert tuple(y.shape) == x.shape, k
        assert str(y.dtype).split(".")[-1] == str(x.dtype), k
    assert tp["vision_proj"]["w"].shape == (jcfg.vision_dim, jcfg.d_model)
    jmask = dict(flatten(jbuild(jcfg).fes_mask(jp)))
    tmask = dict(flatten(tbuild(tcfg).fes_mask(params_from_numpy(jp))))
    assert jmask == tmask and not tmask["vision_proj/w"]


# --------------------------------------------------------------- training --

def test_f32_logits_loss_and_every_gradient_match_jax():
    """Logits over the patch rows and the tokens (66 rows), the loss on
    the text segment and every gradient, ``vision_proj``'s among them."""
    jcfg, tcfg = _cfgs()
    jp, batch = _jparams(jcfg), _batch(jcfg)
    jlogits = jax.jit(jtf.forward, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, _j(batch))[0]
    jloss, jgrad = jax.jit(jax.value_and_grad(jtf.loss_fn),
                           static_argnums=1)(jax.tree.map(jnp.asarray, jp),
                                             jcfg, _j(batch))
    tp = params_from_numpy(jp)
    tlogits = ttf.forward(tp, tcfg, _t(batch))[0]
    assert tlogits.shape == (B, jcfg.num_patches + S, jcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **F32_TOL)
    for x in leaves(tp):
        x.requires_grad_(True)
    tloss = ttf.loss_fn(tp, tcfg, _t(batch))
    tgrad = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **F32_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jgrad)))
    for (k, _), g in zip(flatten(tp), tgrad, strict=True):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)
    assert float(abs(jflat["vision_proj/w"]).max()) > 0


def test_bf16_loss_matches_jax():
    """bf16 weights and activations: the same rounding sites, other
    accumulation orders, so the loss agrees within 2e-2 relative (the
    dense family's bound)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, batch = _jparams(jcfg, seed=1), _batch(jcfg)
    jloss = jax.jit(jtf.loss_fn, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, _j(batch))
    tloss = ttf.loss_fn(params_from_numpy(jp), tcfg, _t(batch))
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


def _fl(**kw):
    return dict(num_clients=2, clients_per_round=2, cohorts=2,
                local_steps=2, p_limited=0.5, lr=0.1, algorithm="ama_fes",
                seed=0, **kw)


@pytest.mark.parametrize("plane", ["masked", "partitioned"])
def test_pod_round_matches_jax(plane):
    """One f32 round of ama_fes (2 cohorts x 2 local steps, p_limited
    0.5), params from JAX, the same tokens and patches: the loss and
    every parameter against JAX's ``ChunkRunner``."""
    jcfg, tcfg = _cfgs()
    jfl, tfl = JFL(**_fl(client_plane=plane)), TFL(**_fl(client_plane=plane))
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    batch = _batch(jcfg, lead=(2, 2, 2), seed=0)
    jstate = jinit_state(jm, jfl, jax.random.PRNGKey(0),
                         jstrategies.resolve(jfl))
    tstate = {"params": params_from_numpy(jax.tree.map(np.asarray,
                                                       jstate["params"])),
              "t": torch.zeros((), dtype=torch.int32), "aux": {}}
    jr = JRunner(jm, jfl, jstrategies.resolve(jfl), per_round_batch=False,
                 donate=False)
    tr = TRunner(tm, tfl, tstrategies.resolve(tfl), per_round_batch=False,
                 device="cpu")
    jstate, jmet = jr.run_chunk(jstate, _j(batch), jenv.resolve(jfl).batch(
        0, 1))
    tstate, tmet = tr.run_chunk(tstate, batch, tenv.resolve(tfl).batch(0, 1))
    assert int(tstate["t"]) == int(jstate["t"]) == 1
    np.testing.assert_allclose(tmet["loss"], np.asarray(jmet["loss"]),
                               **F32_TOL)
    _assert_trees_close(tstate["params"], jstate["params"], F32_TOL)


def _pod_run(cfg, use_scan=True, rounds=3):
    fl = TFL(**_fl())
    model = tbuild(cfg)
    batch = _batch(cfg, lead=(2, 2, 2), seed=0)
    batch["patch_emb"] = torch.from_numpy(batch["patch_emb"]).to(
        getattr(torch, cfg.dtype))
    state = tinit_state(model, fl, torch.Generator().manual_seed(0), "cpu",
                        tstrategies.resolve(fl))
    runner = TRunner(model, fl, tstrategies.resolve(fl),
                     per_round_batch=False, use_scan=use_scan, device="cpu")
    return runner.run_chunk(state, batch,
                            dict(tenv.resolve(fl).batch(0, rounds)))


def _bitwise(a, b):
    (sa, ma), (sb, mb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(
        leaves(sa["params"]), leaves(sb["params"]), strict=True))
    assert list(ma["loss"]) == list(mb["loss"])


def test_pod_chunk_equals_per_round_bitwise():
    """Three bf16 rounds in one chunk == the same rounds one at a time,
    bit for bit."""
    cfg = _cfgs("bfloat16")[1]
    _bitwise(_pod_run(cfg, True), _pod_run(cfg, False))


def test_remat_on_equals_off_bitwise():
    """Two f32 rounds with each block under ``_BlockRemat`` and without:
    the same params and losses, bit for bit."""
    cfg = _cfgs()[1]
    assert cfg.remat
    _bitwise(_pod_run(cfg, rounds=2), _pod_run(cfg.with_(remat=False),
                                               rounds=2))


# ---------------------------------------------------------------- serving --

def _ids(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def test_decode_steps_and_prefill_match_jax():
    """f32 ``decode_step`` over 4 tokens, then a ``prefill`` chunk of 6
    (two pad rows), from JAX's cache: logits and every cache leaf after
    each call (the vlm serves tokens only, as the dense family)."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(jcfg, seed=2)
    tp = params_from_numpy(jp)
    jcache = jtf.init_decode_cache(jcfg, B, 16)
    tcache = ttf.init_decode_cache(tcfg, B, 16)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (10, B))
    step = jax.jit(jtf.decode_step, static_argnums=1)
    jpf = jax.jit(jtf.prefill, static_argnums=1)

    def same(tl, jl, jcache, tcache, what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=what,
                                   **F32_TOL)
        jflat = dict(flatten(jax.tree.map(np.asarray, jcache)))
        for k, v in flatten(tcache):
            np.testing.assert_allclose(v.float().numpy(),
                                       jflat[k].astype(np.float32),
                                       err_msg=f"{k} {what}", **F32_TOL)

    for t in range(4):
        pos = np.full((B,), t, np.int32)
        jl, jcache = step(jax.tree.map(jnp.asarray, jp), jcfg,
                          jnp.asarray(toks[t]), jnp.asarray(pos), jcache)
        tl, tcache = ttf.decode_step(tp, tcfg, _ids(toks[t]), _ids(pos),
                                     tcache)
        same(tl, jl, jcache, tcache, f"step {t}")
    ctoks = toks[4:].T.copy()
    cpos = np.tile(np.arange(4, 10, dtype=np.int32), (B, 1))
    cpos[:, 4:] = 2 ** 30
    jl, jcache = jpf(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ctoks),
                     jnp.asarray(cpos), jcache)
    tl, tcache = ttf.prefill(tp, tcfg, _ids(ctoks), _ids(cpos), tcache)
    same(tl[:, :4], np.asarray(jl)[:, :4], jcache, tcache, "prefill")


def _reqs(vocab, lens, max_new, cls):
    rng = np.random.RandomState(7)
    return [cls(rid=i, prompt=[int(x) for x in rng.randint(0, vocab, n)],
                max_new=max_new) for i, n in enumerate(lens)]


def test_engines_serve_the_same_tokens_as_jax():
    """f32 params from JAX: the port's loop engine serves the JAX loop
    engine's tokens; chunked prefill (chunk 4) serves the per-token
    loop's tokens bit for bit, and so does the paged engine."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(jcfg, seed=4)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    tp = params_from_numpy(jp)
    lens, new = [9, 13, 11], 4
    want = [r["tokens"] for r in JLoop(jm, jax.tree.map(jnp.asarray, jp)).run(
        _reqs(jcfg.vocab_size, lens, new, JRequest))]

    def tokens(engine):
        return [r["tokens"] for r in engine.run(
            _reqs(tcfg.vocab_size, lens, new, Request))]

    loop = tokens(LoopEngine(tm, tp))
    assert loop == want
    assert tokens(LoopEngine(tm, tp, prefill_chunk=4)) == loop
    assert tokens(PagedEngine(tm, tp, max_slots=2, block_size=4,
                              prefill_chunk=4)) == loop


def test_launchers_run_the_vlm_on_the_cpu(capsys):
    """``launch.train --arch phi-3-vision-4.2b --pod --reduced --device
    cpu`` (patch embeddings N(0, 1) from the seed) and ``launch.serve``
    with the paged engine."""
    state, metrics, _ = ttrain.main(["--arch", ARCH, "--pod", "--reduced",
                                     "--rounds", "1", "--seq", "32",
                                     "--device", "cpu"])
    assert int(state["t"]) == 1 and np.isfinite(metrics["loss"]).all()
    assert "vision_proj" in state["params"]
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--engine", "paged", "--prompt-mix", "6x1,9x1",
                       "--tokens", "3"])
    assert [r["new_tokens"] for r in res] == [3, 3]
    assert "engine=paged served 2 requests" in capsys.readouterr().out


def test_pod_batch_patches_keep_a_deep_stack_finite():
    """The launcher's pod batch draws ``patch_emb`` N(0, 1) from the seed
    where JAX's has zeros: at 32 layers JAX's own gradient over zero
    patches is NaN (a zero row stays zero through every block, and
    RMSNorm's backward there scales by rsqrt(eps) a layer), while the
    port's batch gives a finite loss and finite gradients."""
    jcfg, tcfg = _cfgs(num_layers=32, fes_tail_layers=2)
    jp = _jparams(jcfg)
    toks = jtokens(1, 16, jcfg.vocab_size, n_topics=1, seed=0)["tokens"]
    zeros = np.zeros((1, jcfg.num_patches, jcfg.vision_dim), np.float32)
    jgrad = jax.jit(jax.grad(jtf.loss_fn), static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg,
        {"tokens": jnp.asarray(toks), "patch_emb": jnp.asarray(zeros)})
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrad))
    fl = TFL(cohorts=1, local_steps=1, seed=0)
    args = ttrain.parser().parse_args(["--batch", "1", "--seq", "16"])
    batch = ttrain._pod_batch(tcfg, fl, args)
    pe = batch["patch_emb"]
    assert pe.shape == (1, 1, 1, jcfg.num_patches, jcfg.vision_dim)
    assert pe.dtype == torch.float32 and bool(pe.abs().sum(-1).gt(0).all())
    tp = params_from_numpy(jp)
    for x in leaves(tp):
        x.requires_grad_(True)
    loss = ttf.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(
        batch["tokens"][0, 0]), "patch_emb": pe[0, 0]})
    grads = torch.autograd.grad(loss, leaves(tp))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
