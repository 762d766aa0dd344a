"""The port's RWKV-6 path (repro_torch.kernels.rwkv6_scan, its plain
versions in repro_torch.kernels.ref, models/rwkv6.py and the ssm branch
of the decoder stack) against the JAX package's, at small sizes on the
CPU.

The JAX references are the Pallas ``rwkv6_scan`` in interpret mode (as
tests/test_kernels.py runs it), ``kernels/ref.py: rwkv6_scan_ref`` and
``jax.vjp`` of it, and the JAX model and pod engine at reduced() size.
On the CPU the wrappers run the plain versions, so these tests hold the
math the CUDA kernels are held to on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py), and the autograd/vmap
plumbing the client plane runs them through.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.func import grad_and_value, vmap

from repro import env as jenv
from repro.configs.base import FLConfig as JFL
from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.core import strategies as jstrategies
from repro.core.round import init_state as jinit_state
from repro.data.synth import make_lm_tokens as jtokens
from repro.exec import ChunkRunner as JRunner
from repro.kernels.ref import rwkv6_scan_ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jscan
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro_torch import env as tenv
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import strategies as tstrategies
from repro_torch.data.synth import make_lm_tokens as ttokens
from repro_torch.exec.engine import ChunkRunner as TRunner
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import (flatten, leaves, params_from_numpy,
                                    params_to_numpy)

REPO = Path(__file__).resolve().parents[1]
# the Pallas kernel's own tolerance against the JAX ref
# (tests/test_kernels.py), and the LLM tests' f32 tolerance: the same
# f32 math summed in other orders
F32_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 64


def _inputs(seed, B, S, H, hd):
    """The Pallas sweep's inputs (tests/test_kernels.py), f32 numpy."""
    rng = np.random.RandomState(seed)
    r = (rng.randn(B, S, H, hd) * 0.5).astype(np.float32)
    k = (rng.randn(B, S, H, hd) * 0.5).astype(np.float32)
    v = rng.randn(B, S, H, hd).astype(np.float32)
    w = (rng.rand(B, S, H, hd) * 0.5 + 0.4).astype(np.float32)
    u = (rng.randn(H, hd) * 0.1).astype(np.float32)
    s0 = (rng.randn(B, H, hd, hd) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _rows(r, k, v, w, u, s0):
    """The kernels' (and plain versions') operands: u (H, hd) given to
    every batch row, (B, H, hd)."""
    return r, k, v, w, np.repeat(u[None], r.shape[0], 0), s0


# ----------------------------------------------------------- (a) forward --

@pytest.mark.parametrize("S_,chunk", [(64, 16), (128, 128), (96, 32)])
@pytest.mark.parametrize("hd", [16, 64])
def test_plain_forward_matches_pallas_and_jax_ref(S_, chunk, hd):
    args = _inputs(S_ + hd, 2, S_, 2, hd)
    jy, jsf = jscan(*(jnp.asarray(a) for a in args), chunk=chunk,
                    interpret=True)
    ry, rsf = jref(*(jnp.asarray(a) for a in args))
    y, sf = trs.rwkv6_scan(*_t(*args), chunk=chunk)
    py, psf, states = tref.rwkv6_scan_ref(*_t(*_rows(*args)))
    assert torch.equal(y, py) and torch.equal(sf, psf)
    assert states.shape == (2, 2, -(-S_ // tref.RWKV6_CKPT), hd, hd)
    assert torch.equal(states[:, :, 0], _t(args[5])[0])
    for want_y, want_sf in ((jy, jsf), (ry, rsf)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **F32_TOL)
        np.testing.assert_allclose(sf.numpy(), np.asarray(want_sf),
                                   **F32_TOL)


def test_forward_is_chunk_size_invariant():
    """The chunk only states the contract: every admitted chunk gives the
    same bits (the Pallas kernel's carried-state test, rtol 1e-5)."""
    args = _t(*_inputs(7, 1, 64, 1, 16))
    y16, s16 = trs.rwkv6_scan(*args, chunk=16)
    for chunk in (32, 64, 128):
        y, s = trs.rwkv6_scan(*args, chunk=chunk)
        assert torch.equal(y, y16) and torch.equal(s, s16)
    jy, _ = jscan(*(jnp.asarray(a.numpy()) for a in args), chunk=64,
                  interpret=True)
    np.testing.assert_allclose(y16.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------- (b) backward --

@pytest.mark.parametrize("S_,hd", [(64, 16), (37, 16), (96, 64)])
def test_plain_backward_matches_jax_vjp(S_, hd):
    """rwkv6_scan_bwd_ref (the adjoint recurrence the backward kernel
    computes, restarting from the saved states) against jax.vjp of JAX's
    ref for every input, with s0 and d(s_final) non-zero; S = 37 leaves
    a ragged last segment."""
    args = _inputs(11 + S_, 2, S_, 3, hd)
    rng = np.random.RandomState(5)
    dy = rng.randn(2, S_, 3, hd).astype(np.float32)
    ds = rng.randn(2, 3, hd, hd).astype(np.float32)
    (jy, jsf), vjp = jax.vjp(jref, *(jnp.asarray(a) for a in args))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    rows = _t(*_rows(*args))
    y, sf, states = tref.rwkv6_scan_ref(*rows)
    grads = list(tref.rwkv6_scan_bwd_ref(*_t(dy, ds), *rows[:5], states))
    assert grads[4].shape == (2, 3, hd)         # du per batch row
    grads[4] = grads[4].sum(0)                  # u shared, as JAX's is
    for name, g, j in zip(("dr", "dk", "dv", "dw", "du", "ds0"), grads,
                          jgrads):
        assert tuple(g.shape) == j.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **F32_TOL)


def test_backward_wrapper_checks_its_operands():
    r, k, v, w, u, s0 = _t(*_rows(*_inputs(3, 1, 32, 2, 16)))
    _, _, states = trs.rwkv6_fwd(r, k, v, w, u, s0)
    dy, ds = torch.zeros_like(r), torch.zeros_like(s0)
    with pytest.raises(ValueError):
        trs.rwkv6_bwd(dy, ds, r, k, v, w, u, states[:, :, :1])
    with pytest.raises(TypeError):
        trs.rwkv6_fwd(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError):
        trs.rwkv6_fwd(r, k, v, w, u[:, :1], s0)
    with pytest.raises(ValueError):         # u one row per batch row only
        trs.rwkv6_fwd(r, k, v, w, u[0], s0)
    with pytest.raises(ValueError, match="multiple of"):
        trs.rwkv6_scan(*_t(*_inputs(3, 1, 200, 1, 16)))


# ------------------------------------------------------ (c) autograd/vmap --

class _Count:
    """Counts calls of the plain versions the wrappers reach on the CPU."""

    NAMES = ("rwkv6_scan_ref", "rwkv6_scan_bwd_ref")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(tref, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(tref, name, counted)


def _autograd_ref(r, k, v, w, u, s0):
    """The plain forward, differentiated by autograd (not by the adjoint
    recurrence)."""
    y, sf, _ = tref.rwkv6_scan_ref(r, k, v, w, u.expand(r.shape[0],
                                                         *u.shape), s0)
    return y, sf


@pytest.mark.parametrize("s0_batched", [False, True])
def test_autograd_function_under_vmap_matches_autograd_of_plain_math(
        monkeypatch, s0_batched):
    """vmap(grad_and_value) over 3 cohorts through RWKV6Scan /
    RWKV6ScanBwd, u batched per cohort (a parameter) and s0 unbatched
    (made inside the loss, as init_rwkv_state does) or batched, against
    autograd of the plain math: one forward and one backward call for
    all cohorts together."""
    C, Bp, S_, H, hd = 3, 2, 32, 2, 16
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(C, Bp, S_, H, hd).astype(np.float32))
    wp = torch.from_numpy(rng.randn(C, hd, hd).astype(np.float32) * 0.3)
    u = torch.from_numpy(rng.randn(C, H, hd).astype(np.float32) * 0.1)
    s0 = torch.from_numpy(rng.randn(Bp, H, hd, hd).astype(np.float32) * 0.1)
    s0_c = s0.expand(C, *s0.shape).clone() if s0_batched else s0

    def loss(fn, wp, u, x, s0):
        r, k, v = x @ wp, torch.tanh(x), x @ wp.T
        w = torch.sigmoid(x)
        y, sf = fn(r, k, v, w, u, s0)
        return torch.sum(y * x) + torch.sum(sf * sf)

    def via_kernel(*a):
        return trs.rwkv6_scan(*a, chunk=16)

    in_dims = (0, 0, 0, 0 if s0_batched else None)
    count = _Count(monkeypatch)
    g, val = vmap(grad_and_value(lambda *a: loss(via_kernel, *a),
                                 argnums=(0, 1, 3)), in_dims=in_dims)(
        wp, u, x, s0_c)
    assert count.calls == dict.fromkeys(_Count.NAMES, 1)
    g2, val2 = vmap(grad_and_value(lambda *a: loss(_autograd_ref, *a),
                                   argnums=(0, 1, 3)), in_dims=in_dims)(
        wp, u, x, s0_c)
    torch.testing.assert_close(val, val2, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("wp", "u", "x"), g, g2):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, **F32_TOL, msg=name)


def test_rwkv6_scan_keeps_the_tpu_kernels_signature():
    pos = [n for n, p in inspect.signature(jscan).parameters.items()
           if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert [n for n, p in inspect.signature(trs.rwkv6_scan).parameters
            .items() if p.kind == p.POSITIONAL_OR_KEYWORD] == pos
    assert (inspect.signature(trs.rwkv6_scan).parameters["chunk"].default
            == inspect.signature(jscan).parameters["chunk"].default)


# ------------------------------------------------------------ (d) model --

def _cfgs(dtype):
    return (jreduced(JARCHS["rwkv6-3b"], dtype=dtype),
            treduced(TARCHS["rwkv6-3b"], dtype=dtype))


def _jparams(cfg, seed=0):
    """JAX's reduced params with u drawn non-zero (JAX initialises it to
    zeros, which would leave du's path untested)."""
    p = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(
        seed)))
    rng = np.random.RandomState(seed + 100)
    for grp in ("body", "tail"):
        if p[grp] is not None:
            u = p[grp]["rwkv"]["u"]
            p[grp]["rwkv"]["u"] = (0.1 * rng.randn(*u.shape)).astype(u.dtype)
    return p


def _tokens(cfg):
    return jtokens(B, S, cfg.vocab_size, n_topics=2, seed=3)["tokens"]


def test_reduced_config_and_tree_match_jax():
    """The port's reduced() rwkv6-3b and its param tree equal JAX's:
    d_model 256 (4 heads of the fixed 64), d_ff 512, vocab 512, 2 layers,
    1 tail layer; keys, shapes and dtypes."""
    for dtype in ("bfloat16", "float32"):
        jcfg, tcfg = _cfgs(dtype)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.d_model, tcfg.d_ff, tcfg.vocab_size, tcfg.num_layers,
            tcfg.fes_tail_layers, tcfg.num_heads) == (256, 512, 512, 2, 1, 0)
    for dtype in ("bfloat16", "float32"):
        jcfg, tcfg = _cfgs(dtype)
        tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
        jflat = dict(flatten(jax.tree.map(np.asarray, jtf.init_params(
            jcfg, jax.random.PRNGKey(0)))))
        tflat = dict(flatten(tp))
        assert tflat.keys() == jflat.keys()
        for k, x in jflat.items():
            assert tuple(tflat[k].shape) == x.shape, k
            assert str(tflat[k].dtype).split(".")[-1] == str(x.dtype), k
            if k.endswith(("/u", "/w0", "/mix", "/cmix", "ln_x/g",
                           "ln_x/b")):   # constant inits
                np.testing.assert_array_equal(
                    tflat[k].float().numpy(), np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    x = np.random.RandomState(4).randn(3, 5, 40).astype(np.float32) * 3 + 1
    rng = np.random.RandomState(5)
    p = {"g": rng.randn(40).astype(np.float32),
         "b": rng.randn(40).astype(np.float32)}
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    want = jlayers.layernorm(jp, jnp.asarray(x, dtype))
    got = tlayers.layernorm(params_from_numpy(jax.tree.map(np.asarray, jp)),
                            params_from_numpy(np.asarray(jnp.asarray(
                                x, dtype))))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(dict(rtol=1e-5, atol=1e-5)
                                  if dtype == "float32" else
                                  dict(rtol=2 ** -7, atol=2 ** -7)))


@pytest.mark.parametrize("S_", [64, 192, 37])
def test_time_and_channel_mix_match_jax(S_):
    """One rwkv6 block's time mix (through the recurrence kernels' plain
    versions) and channel mix against JAX's, f32, with non-zero shift
    and wkv states: outputs, new states and the gradient of x through the
    time mix. JAX pads S to its 64-step chunk (w = 1); the port takes any
    S unpadded, though S = 192 is no multiple of the TPU kernel's chunk
    128, which its public entry ``rwkv6_scan`` still refuses."""
    jcfg, tcfg = _cfgs("float32")
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["body"])["rwkv"]
    rng = np.random.RandomState(6 + S_)
    x = rng.randn(B, S_, jcfg.d_model).astype(np.float32)
    c = rng.randn(B, S_, jcfg.d_model).astype(np.float32)
    jst = jax.tree.map(np.asarray, jrwkv6.init_rwkv_state(jcfg, B,
                                                          jnp.float32))
    jst["x_tm"] = rng.randn(B, jcfg.d_model).astype(np.float32)
    jst["x_cm"] = rng.randn(B, jcfg.d_model).astype(np.float32)
    jst["wkv"] = (0.1 * rng.randn(*jst["wkv"].shape)).astype(np.float32)
    jpj, jstj = (jax.tree.map(jnp.asarray, t) for t in (jp, jst))
    tp, tst = params_from_numpy(jp), params_from_numpy(jst)

    def jloss(x):
        out, st = jrwkv6.time_mix(jpj, jcfg, x, jstj)
        return jnp.sum(out * c), (out, st)

    def tloss(x):
        out, st = trwkv6.time_mix(tp, tcfg, x, tst)
        return torch.sum(out * torch.from_numpy(c)), (out, st)

    (_, (want, wst)), jdx = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tdx, (_, (got, gst)) = torch.func.grad_and_value(tloss, has_aux=True)(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for k in ("wkv", "x_tm"):
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                   err_msg=k, **F32_TOL)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **F32_TOL)
    want, wst = jrwkv6.channel_mix(jpj, jnp.asarray(x), jstj)
    got, gst = trwkv6.channel_mix(tp, torch.from_numpy(x), tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(gst["x_cm"].numpy(), np.asarray(
        wst["x_cm"]))
    if S_ > 128 and S_ % 128:
        H, hd = jcfg.d_model // trwkv6.HEAD_DIM, trwkv6.HEAD_DIM
        z = torch.zeros(B, S_, H, hd)
        with pytest.raises(ValueError, match="multiple of"):
            trs.rwkv6_scan(z, z, z, z, torch.zeros(H, hd),
                           torch.zeros(B, H, hd, hd))


def test_f32_loss_and_every_gradient_match_jax():
    jcfg, tcfg = _cfgs("float32")
    jp, toks = _jparams(jcfg), _tokens(jcfg)
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
    assert len(tgrad) == len(jflat)
    for (k, _), g in zip(flatten(tp), tgrad):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)


def test_bf16_loss_matches_jax():
    """bf16 weights and activations: the packages round at the same
    sites but accumulate their bf16 matmuls differently, so the loss
    agrees within 2e-2 relative (tests/test_torch_transformer.py's
    tolerance)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, toks = _jparams(jcfg, seed=1), _tokens(jcfg)
    jloss = jtf.loss_fn(jax.tree.map(jnp.asarray, jp), jcfg,
                        {"tokens": jnp.asarray(toks)})
    tloss = ttf.loss_fn(params_from_numpy(jp), tcfg,
                        {"tokens": torch.from_numpy(toks)})
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


# ------------------------------------------------------------ (e) pod ----

def _assert_trees_close(t_tree, j_tree, tol):
    jflat = dict(flatten(jax.tree.map(np.asarray, j_tree)))
    tflat = dict(flatten(params_to_numpy(t_tree)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_allclose(np.asarray(tflat[k], np.float32),
                                   np.asarray(jflat[k], np.float32),
                                   err_msg=k, **tol)


def test_one_and_two_pod_rounds_match_jax():
    """JAX and port pod rounds of reduced rwkv6-3b in f32: ama_fes, 2
    cohorts x 2 local steps, p_limited 0.5, one batch re-fed, params from
    JAX; after round 1 and round 2."""
    jcfg, tcfg = _cfgs("float32")
    kw = dict(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
              p_limited=0.5, lr=0.1, algorithm="ama_fes", seed=0)
    jfl, tfl = JFL(**kw), TFL(**kw)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    toks = jtokens(8, S + 1, jcfg.vocab_size, n_topics=2,
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
    for t0 in range(2):
        sj, st = je.batch(t0, 1), te.batch(t0, 1)
        jstate, jmet = jr.run_chunk(jstate, {"tokens": jnp.asarray(toks)},
                                    sj)
        tstate, tmet = tr.run_chunk(tstate, {"tokens": toks}, st)
        assert int(tstate["t"]) == int(jstate["t"]) == t0 + 1
        np.testing.assert_allclose(tmet["loss"], np.asarray(jmet["loss"]),
                                   **F32_TOL)
        _assert_trees_close(tstate["params"], jstate["params"], F32_TOL)


def test_pod_chunk_equals_per_round_bitwise():
    """Two rwkv6 rounds in one chunk == the same rounds one at a time,
    bit for bit (CPU, plain versions)."""
    tcfg = _cfgs("float32")[1]
    fl = TFL(num_clients=2, clients_per_round=2, cohorts=2, local_steps=2,
             p_limited=0.5, lr=0.1, seed=0)
    toks = ttokens(8, S + 1, tcfg.vocab_size, n_topics=2,
                   seed=0)["tokens"][:, :S].reshape(2, 2, 2, S)
    env = tenv.resolve(fl)
    out = []
    for use_scan in (True, False):
        state = {"params": ttf.init_params(
            tcfg, torch.Generator().manual_seed(0)),
            "t": torch.zeros((), dtype=torch.int32), "aux": {}}
        runner = TRunner(tbuild(tcfg), fl, per_round_batch=False,
                         use_scan=use_scan, device="cpu")
        out.append(runner.run_chunk(state, {"tokens": toks}, env.batch(0, 2)))
    (a, ma), (b, mb) = out
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    np.testing.assert_array_equal(ma["loss"], mb["loss"])


# ------------------------------------------------------- (f) weight bridge --

def test_params_from_numpy_carries_the_rwkv_trees_bf16_bits():
    """The rwkv tree (nested rwkv/ln_x, stacked bf16 leaves) crosses to
    the port and back bit for bit."""
    jp = _jparams(_cfgs("bfloat16")[0])
    assert "ln_x" in jp["body"]["rwkv"]
    tp = params_from_numpy(jp)
    for (k, j), t in zip(flatten(jp), leaves(tp)):
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16), err_msg=k)
    for (k, j), b in zip(flatten(jp), leaves(params_to_numpy(tp))):
        assert b.dtype == j.dtype, k
        np.testing.assert_array_equal(b.view(np.int16), j.view(np.int16))


# ------------------------------------------------------------ (h) launcher --

def _run(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_pod_launcher_runs_rwkv6_on_cpu_and_refuses_without_a_gpu():
    argv = ["--arch", "rwkv6-3b", "--pod", "--reduced", "--rounds", "2"]
    p = _run([*argv, "--device", "cpu"])
    assert p.returncode == 0, p.stderr
    assert "rwkv6-3b (2 layers, d_model 256) on cpu" in p.stdout
    assert "round 1: loss=" in p.stdout and "phases: compile=" in p.stdout
    if not torch.cuda.is_available():
        p = _run(argv)
        assert p.returncode != 0 and "no CUDA device" in p.stderr
