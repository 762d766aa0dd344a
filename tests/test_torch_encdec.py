"""The encoder-decoder family (whisper-medium) in the port against the JAX
package, at reduced() size on the CPU.

The reduced config: a 2-block encoder over 64 frames and a 2-block
decoder (body 1, tail 1), d_model 256, 4 query heads of 64 over 2 kv
heads, a plain GELU MLP. Batches carry non-zero ``frame_emb``
(numpy-seeded), so the encoder and the cross-attention take part in
every comparison; 40 tokens against 64 frames (100 frames in the
encoder-only test) are ragged lengths for the flash kernels' plain
versions, and the cross-attention runs them at Sq != Skv. Parameters
start in JAX and cross through numpy. Held here: the config's fields;
the tree in ``jax.tree`` order and the encoder in the FES feature
extractor; f32 logits, loss and every gradient at rtol 1e-4, atol 1e-5
(the same math summed in other orders); the encoder alone; one pod round
of ama_fes on the masked and partitioned client planes against JAX's
``ChunkRunner``; chunked == per round and remat on == off, bitwise;
``init_decode_cache``, ``decode_step`` and ``prefill`` against JAX's;
chunked prefill == the per-token loop, bitwise; the loop engine's
tokens against JAX's; the paged engine refused; the padded ``lm_head``
of ``serve_params``; the launchers.
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
from repro.models import encdec as jed
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
from repro_torch.models import encdec as ted
from repro_torch.models.api import build_model as tbuild
from repro_torch.serve import LoopEngine, PagedEngine, Request
from repro_torch.utils.tree import (flatten, leaves, params_from_numpy,
                                    params_to_numpy)

ARCH = "whisper-medium"
# f32: the same math summed in other orders (XLA's matmuls, einsums and
# chunked attention against the port's plain versions)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 40


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
    return jax.tree.map(np.asarray, jed.init_params(cfg, jax.random.PRNGKey(
        seed)))


def _frames(cfg, n, seed):
    return np.random.RandomState(seed).randn(
        n, cfg.encoder_seq, cfg.d_model).astype(np.float32)


def _batch(cfg, lead=(B,), seed=3):
    """{"tokens": lead + (S,) int32, "frame_emb": lead + (encoder_seq,
    d_model) f32, N(0, 1)}, numpy."""
    n = int(np.prod(lead))
    toks = jtokens(n, S, cfg.vocab_size, n_topics=2, seed=seed)["tokens"]
    return {"tokens": toks.reshape(*lead, S),
            "frame_emb": _frames(cfg, n, seed).reshape(
                *lead, cfg.encoder_seq, cfg.d_model)}


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
    """Every field equal to the JAX file's (24 + 24 layers, 1,500 frames,
    vocab 51,865, a plain GELU MLP), at full width and reduced."""
    j, t = JARCHS[ARCH], TARCHS[ARCH]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(treduced(t)) == dataclasses.asdict(jreduced(j))
    assert (t.family, t.encoder_layers, t.encoder_seq, t.vocab_size,
            t.mlp_gated) == ("audio", 24, 1500, 51865, False)


def test_tree_order_and_fes_mask_match_jax():
    """JAX's keys, shapes and dtypes in ``jax.tree`` order (the port's
    own init too); under FES the encoder, ``enc_pos`` and the decoder's
    body are the feature extractor, the tail, final norm and head the
    classifier, as in JAX."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = _jparams(jcfg)
    tp = ted.init_params(tcfg, torch.Generator().manual_seed(0))
    jflat, tflat = flatten(jp), flatten(tp)
    assert [k for k, _ in tflat] == [k for k, _ in jflat]
    for (k, x), (_, y) in zip(jflat, tflat):
        assert tuple(y.shape) == x.shape, k
        assert str(y.dtype).split(".")[-1] == str(x.dtype), k
    jmask = dict(flatten(jbuild(jcfg).fes_mask(jp)))
    tmask = dict(flatten(tbuild(tcfg).fes_mask(params_from_numpy(jp))))
    assert jmask == tmask
    assert not any(v for k, v in tmask.items() if k.startswith("enc"))
    assert all(v for k, v in tmask.items() if k.startswith("tail"))


# --------------------------------------------------------------- training --

def test_f32_logits_loss_and_every_gradient_match_jax():
    """Logits, loss and every gradient (the encoder's and the
    cross-attention's among them) of 40 tokens against 64 frames."""
    jcfg, tcfg = _cfgs()
    jp, batch = _jparams(jcfg), _batch(jcfg)
    jlogits = jax.jit(jed.forward, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, _j(batch))[0]
    jloss, jgrad = jax.jit(jax.value_and_grad(jed.loss_fn),
                           static_argnums=1)(jax.tree.map(jnp.asarray, jp),
                                             jcfg, _j(batch))
    tp = params_from_numpy(jp)
    np.testing.assert_allclose(ted.forward(tp, tcfg, _t(batch))[0].numpy(),
                               np.asarray(jlogits), **F32_TOL)
    for x in leaves(tp):
        x.requires_grad_(True)
    tloss = ted.loss_fn(tp, tcfg, _t(batch))
    tgrad = torch.autograd.grad(tloss, leaves(tp))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               **F32_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jgrad)))
    for (k, _), g in zip(flatten(tp), tgrad, strict=True):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)
    assert float(abs(jflat["encoder/attn/wq/w"]).max()) > 0


def test_encoder_alone_at_a_ragged_length_matches_jax():
    """``encode`` over 100 frames (``reduced(cfg, encoder_seq=100)``: one
    full tile of 64 and a ragged one in the flash kernels) against
    JAX's."""
    jcfg, tcfg = _cfgs(encoder_seq=100)
    jp = _jparams(jcfg, seed=5)
    fe = _frames(jcfg, B, 5)
    want = jax.jit(jed.encode, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(fe))
    got = ted.encode(params_from_numpy(jp), tcfg, torch.from_numpy(fe))
    assert got.shape == (B, 100, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _fl(**kw):
    return dict(num_clients=2, clients_per_round=2, cohorts=2,
                local_steps=2, p_limited=0.5, lr=0.1, algorithm="ama_fes",
                seed=0, **kw)


@pytest.mark.parametrize("plane", ["masked", "partitioned"])
def test_pod_round_matches_jax(plane):
    """One f32 round of ama_fes (2 cohorts x 2 local steps, p_limited
    0.5), params from JAX, the same tokens and frames: the loss and
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
    batch["frame_emb"] = torch.from_numpy(batch["frame_emb"]).to(
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
    """Two f32 rounds with every encoder and decoder block under
    ``_Remat`` and without: the same params and losses, bit for bit."""
    cfg = _cfgs()[1]
    assert cfg.remat
    _bitwise(_pod_run(cfg, rounds=2), _pod_run(cfg.with_(remat=False),
                                               rounds=2))


# ---------------------------------------------------------------- serving --

def _ids(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _cache_close(tcache, jcache, what):
    for g in ("body", "tail"):
        jflat = dict(flatten(jax.tree.map(np.asarray, jcache[f"{g}_self"])))
        for k, v in flatten(tcache[f"{g}_self"]):
            np.testing.assert_allclose(v.float().numpy(),
                                       jflat[k].astype(np.float32),
                                       err_msg=f"{g}_self/{k} {what}",
                                       **F32_TOL)
        for t, j in zip(tcache[f"{g}_cross"], jcache[f"{g}_cross"],
                        strict=True):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       err_msg=f"{g}_cross {what}",
                                       **F32_TOL)


def test_decode_steps_and_prefill_match_jax():
    """f32: ``init_decode_cache`` (the frames encoded once, each layer's
    cross K/V), ``decode_step`` over 4 tokens, then a ``prefill`` chunk
    of 6 (two pad rows), against JAX's: logits and every cache leaf
    after each call."""
    jcfg, tcfg = _cfgs()
    jp = _jparams(jcfg, seed=2)
    tp = params_from_numpy(jp)
    fe = _frames(jcfg, B, 2)
    jcache = jed.init_decode_cache(jax.tree.map(jnp.asarray, jp), jcfg,
                                   jnp.asarray(fe), 16)
    tcache = ted.init_decode_cache(tp, tcfg, torch.from_numpy(fe), 16)
    assert tcache["body_cross"][0].shape == (1, B, jcfg.encoder_seq, 2, 64)
    _cache_close(tcache, jcache, "init")
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (10, B))
    step = jax.jit(jed.decode_step, static_argnums=1)
    for t in range(4):
        pos = np.full((B,), t, np.int32)
        jl, jcache = step(jax.tree.map(jnp.asarray, jp), jcfg,
                          jnp.asarray(toks[t]), jnp.asarray(pos), jcache)
        tl, tcache = ted.decode_step(tp, tcfg, _ids(toks[t]), _ids(pos),
                                     tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        _cache_close(tcache, jcache, f"step {t}")
    ctoks = toks[4:].T.copy()
    cpos = np.tile(np.arange(4, 10, dtype=np.int32), (B, 1))
    cpos[:, 4:] = 2 ** 30
    jl, jcache = jax.jit(jed.prefill, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(ctoks),
        jnp.asarray(cpos), jcache)
    tl, tcache = ted.prefill(tp, tcfg, _ids(ctoks), _ids(cpos), tcache)
    np.testing.assert_allclose(tl[:, :4].numpy(), np.asarray(jl)[:, :4],
                               **F32_TOL)
    _cache_close(tcache, jcache, "prefill")


def _reqs(vocab, lens, max_new, cls):
    rng = np.random.RandomState(7)
    return [cls(rid=i, prompt=[int(x) for x in rng.randint(0, vocab, n)],
                max_new=max_new) for i, n in enumerate(lens)]


def test_loop_engine_serves_jax_engines_tokens_and_chunked_is_bitwise():
    """f32 params from JAX: the port's loop engine serves the JAX loop
    engine's tokens (zero frames, as both engines build the cache);
    chunked prefill (chunk 4) serves the per-token loop's tokens and
    logits bit for bit; the paged engine refuses the family by JAX's
    message."""
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
    # the logits, bitwise: one chunk of 6 against 6 per-token steps
    fe = torch.from_numpy(_frames(jcfg, B, 9))
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (B, 6))
    c1 = ted.init_decode_cache(tp, tcfg, fe, 16)
    c2 = ted.init_decode_cache(tp, tcfg, fe, 16)
    per = torch.stack([ted.decode_step(tp, tcfg, _ids(toks[:, t]),
                                       _ids(np.full((B,), t)), c1)[0]
                       for t in range(6)], 1)
    pos = np.tile(np.arange(6, dtype=np.int32), (B, 1))
    chunk, _ = ted.prefill(tp, tcfg, _ids(toks), _ids(pos), c2)
    assert torch.equal(chunk, per)
    assert all(torch.equal(a, b) for a, b in zip(leaves(c1["body_self"]),
                                                 leaves(c2["body_self"])))
    assert tm.init_paged_pool is None and tm.decode_step_paged is None
    with pytest.raises(ValueError, match="'audio' has no paged serving"):
        PagedEngine(tm, tp, max_slots=2, block_size=4)


def test_serve_params_pad_the_head_once():
    """A vocabulary not a multiple of 8 (whisper's 51,865; here 509):
    ``serve_params`` pads ``lm_head`` with zero columns to 512, shares
    every other leaf, and the serving steps return the first 509 logits,
    those of the unpadded head within f32 rounding (bitwise on the card,
    where the GEMM's order is fixed by K and the padded N); a vocabulary
    that is a multiple of 8 keeps its params."""
    jcfg, tcfg = _cfgs(vocab_size=509)
    tm = tbuild(tcfg)
    tp = params_from_numpy(_jparams(jcfg, seed=6))
    sp = tm.serve_params(tp)
    assert sp["lm_head"]["w"].shape == (tcfg.d_model, 512)
    assert torch.equal(sp["lm_head"]["w"][:, :509], tp["lm_head"]["w"])
    assert not sp["lm_head"]["w"][:, 509:].any()
    assert sp["encoder"] is tp["encoder"] and sp["embed"] is tp["embed"]
    fe = torch.from_numpy(_frames(jcfg, B, 1))
    tok, pos = _ids([3, 7]), _ids([0, 0])
    want, _ = ted.decode_step(tp, tcfg, tok, pos,
                              ted.init_decode_cache(tp, tcfg, fe, 8))
    got, _ = ted.decode_step(sp, tcfg, tok, pos,
                             ted.init_decode_cache(sp, tcfg, fe, 8))
    assert got.shape == (B, 509)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jcfg, tcfg = _cfgs()
    tp = params_from_numpy(_jparams(jcfg))
    assert tbuild(tcfg).serve_params(tp) is tp


def test_launchers_run_whisper_on_the_cpu(capsys):
    """``launch.train --arch whisper-medium --pod --reduced --device
    cpu`` (zero frame embeddings, as JAX's pod batch) and
    ``launch.serve`` with the loop engine and chunked prefill; the paged
    engine refused by name."""
    state, metrics, _ = ttrain.main(["--arch", ARCH, "--pod", "--reduced",
                                     "--rounds", "1", "--seq", "32",
                                     "--device", "cpu"])
    assert int(state["t"]) == 1 and np.isfinite(metrics["loss"]).all()
    assert "encoder" in state["params"]
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--prompt-mix", "6x1,9x1", "--tokens", "3",
                       "--prefill-chunk", "4"])
    assert [r["new_tokens"] for r in res] == [3, 3]
    assert "engine=loop served 2 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="'audio' has no paged serving"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--engine", "paged"])
