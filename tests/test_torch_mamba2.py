"""The port's Mamba-2 block (repro_torch.models.mamba2, the recurrence in
repro_torch.kernels.mamba2_scan and its plain versions in
repro_torch.kernels.ref) against the JAX package's models/mamba2.py, at
small sizes on the CPU.

The same numpy-seeded parameters, inputs and states go through JAX's
``mamba2_fwd`` / ``mamba2_step`` and the port's. On the CPU the wrappers
run the plain versions, so these tests hold the math the CUDA kernels are
held to on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py), and
the autograd/vmap plumbing the client plane runs them through.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.func import grad_and_value, vmap

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.models import mamba2 as jm
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import mamba2_scan as tms
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba2 as tm
from repro_torch.utils.tree import params_from_numpy

# f32: the same math summed in other orders (XLA's einsum and the JAX
# scan against the port's loop), the LLM tests' tolerance
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: the packages round the conv's products and sums, the gated norm
# and the projections to bf16 at the same sites but accumulate in other
# orders, so an element may land one bf16 step (2^-8 relative) away and
# carry that through the block: held at 3 bf16 steps of the output's
# largest magnitude
BF16_STEPS = 3 * 2.0 ** -8
B = 2


def _cfgs(dtype):
    kw = dict(d_model=128, dtype=dtype)
    return (jreduced(JARCHS["zamba2-1.2b"], **kw),
            treduced(TARCHS["zamba2-1.2b"], **kw))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _params(cfg, seed=0):
    """A Mamba-2 block's params, numpy, with A_log, D, dt_bias and norm_g
    drawn away from their init so every term of the block is live."""
    d, N, W = cfg.d_model, cfg.ssm_state, cfg.conv_width
    d_inner, H = 2 * d, 2 * d // tm.HEAD_DIM
    rng = np.random.RandomState(seed)
    p = {"w_in": {"w": rng.randn(d, 2 * d_inner + 2 * N + H) * d ** -0.5},
         "conv": rng.randn(W, d_inner + 2 * N) * 0.3,
         "A_log": rng.randn(H) * 0.5,
         "D": 1.0 + 0.1 * rng.randn(H),
         "dt_bias": rng.randn(H) * 0.5,
         "norm_g": 1.0 + 0.1 * rng.randn(d_inner),
         "w_out": {"w": rng.randn(d_inner, d) * d_inner ** -0.5}}
    f32 = ("A_log", "D", "dt_bias")
    cast = (lambda x: x.astype(np.float32)) if cfg.dtype == "float32" \
        else _bf16
    return jax.tree.map(lambda x: x.astype(np.float32), {
        k: v for k, v in p.items() if k in f32}) | jax.tree.map(
        cast, {k: v for k, v in p.items() if k not in f32})


def _state(cfg, seed=1, zero=False):
    d_inner, N = 2 * cfg.d_model, cfg.ssm_state
    H = d_inner // tm.HEAD_DIM
    rng = np.random.RandomState(seed)
    ssm = rng.randn(B, H, tm.HEAD_DIM, N).astype(np.float32) * 0.3
    conv = rng.randn(B, cfg.conv_width - 1, d_inner + 2 * N) * 0.5
    conv = conv.astype(np.float32) if cfg.dtype == "float32" else _bf16(conv)
    if zero:
        ssm, conv = np.zeros_like(ssm), np.zeros_like(conv)
    return {"ssm": ssm, "conv": conv}


def _u(cfg, S, seed=2):
    u = np.random.RandomState(seed).randn(B, S, cfg.d_model)
    return u.astype(np.float32) if cfg.dtype == "float32" else _bf16(u)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# JAX's block under jit (one compile a shape; eager dispatch of its
# chunked scan takes seconds a call)
_jfwd = jax.jit(jm.mamba2_fwd, static_argnums=1)
_jstep = jax.jit(jm.mamba2_step, static_argnums=1)


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
    else:
        tol = BF16_STEPS * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


# ------------------------------------------------------------ the block --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 17, 64, 130])
def test_mamba2_fwd_matches_jax(dtype, S):
    """Output and the returned ssm and conv states from a non-zero state,
    at S below, at and across JAX's 64-step chunk (which JAX pads with
    a = 1, x = 0 and the port does not pad)."""
    jcfg, tcfg = _cfgs(dtype)
    p, st, u = _params(jcfg), _state(jcfg), _u(jcfg, S)
    jout, jst = _jfwd(_j(p), jcfg, jnp.asarray(u), _j(st))
    tout, tst = tm.mamba2_fwd(params_from_numpy(p), tcfg,
                              params_from_numpy(u), params_from_numpy(st))
    assert tout.dtype == getattr(torch, dtype) and tout.shape == (B, S, 128)
    _close(tout, jout, dtype, "out")
    _close(tst["ssm"], jst["ssm"], dtype, "ssm")
    # the last W-1 conv inputs: the projection's outputs
    _close(tst["conv"], jst["conv"], dtype, "conv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_step_matches_jax(dtype):
    """Three decode steps from a non-zero ssm and conv state: output and
    both states after each."""
    jcfg, tcfg = _cfgs(dtype)
    p, u = _params(jcfg), _u(jcfg, 3)
    jst, tst = _j(_state(jcfg)), params_from_numpy(_state(jcfg))
    tp = params_from_numpy(p)
    for t in range(3):
        jout, jst = _jstep(_j(p), jcfg, jnp.asarray(u[:, t]), jst)
        tout, tst = tm.mamba2_step(tp, tcfg, params_from_numpy(u[:, t]),
                                   tst)
        _close(tout, jout, dtype, f"out {t}")
        _close(tst["ssm"], jst["ssm"], dtype, f"ssm {t}")
        _close(tst["conv"], jst["conv"], dtype, f"conv {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_loop_equals_the_forward(dtype):
    """S tokens through ``mamba2_step`` one at a time from a zero state
    equal ``mamba2_fwd`` over the S tokens (the port's own two paths:
    the conv sums its W products with ``torch.sum`` in decode and one add
    at a time in the forward; the recurrence is the same plain version at
    S = 1 and at S)."""
    jcfg, tcfg = _cfgs(dtype)
    S = 70
    tp = params_from_numpy(_params(jcfg))
    u = params_from_numpy(_u(jcfg, S))
    st = params_from_numpy(_state(jcfg, zero=True))
    want, wst = tm.mamba2_fwd(tp, tcfg, u, st)
    outs = []
    for t in range(S):
        out, st = tm.mamba2_step(tp, tcfg, u[:, t], st)
        outs.append(out)
    _close(torch.stack(outs, 1), want.float().numpy(), dtype, "out")
    _close(st["ssm"], wst["ssm"].numpy(), dtype, "ssm")


def test_gradients_match_jax_vjp():
    """f32: the gradient of <out, g> + <ssm, g_s> with respect to every
    param, the input and both incoming states, through the plain backward
    (the adjoint recurrence) against ``jax.vjp`` of JAX's block, at S =
    130 (three of the backward's segments, the last ragged)."""
    jcfg, tcfg = _cfgs("float32")
    S = 130
    p, st, u = _params(jcfg), _state(jcfg), _u(jcfg, S)
    rng = np.random.RandomState(5)
    g = rng.randn(B, S, 128).astype(np.float32)
    gs = rng.randn(*st["ssm"].shape).astype(np.float32)

    def jloss(p, u, st):
        out, new = jm.mamba2_fwd(p, jcfg, u, st)
        return jnp.sum(out * g) + jnp.sum(new["ssm"] * gs)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(_j(p), jnp.asarray(u),
                                                     _j(st))
    tp, tu, tst = (params_from_numpy(x) for x in (p, u, st))
    flat = [tu, tst["ssm"], tst["conv"], *jax.tree.leaves(tp)]
    for x in flat:
        x.requires_grad_(True)
    out, new = tm.mamba2_fwd(tp, tcfg, tu, tst)
    loss = torch.sum(out * torch.from_numpy(g)) + torch.sum(
        new["ssm"] * torch.from_numpy(gs))
    tg = torch.autograd.grad(loss, flat)
    want = [jg[1], jg[2]["ssm"], jg[2]["conv"], *jax.tree.leaves(jg[0])]
    names = ["u", "ssm", "conv", *(jax.tree_util.keystr(k) for k, _ in
                                   jax.tree_util.tree_flatten_with_path(p)[0])]
    for name, a, b in zip(names, tg, want, strict=True):
        # a gradient sums S B terms of both signs: its rounding scales with
        # the leaf's largest element, so atol does too
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, rtol=1e-4,
                                   atol=1e-5 * (1 + np.abs(b).max()))


# ------------------------------------------------------ the recurrence --

def _scan_inputs(seed, Bn, S, H, N, P=tm.HEAD_DIM, dtype=np.float32):
    rng = np.random.RandomState(seed)
    a = np.exp(-np.exp(rng.randn(Bn, S, H)))           # decays in (0, 1)
    x = rng.randn(Bn, S, H, P) * 0.5
    Bm, Cm = rng.randn(Bn, S, N), rng.randn(Bn, S, N)
    h0 = rng.randn(Bn, H, P, N) * 0.3
    return [torch.from_numpy(v.astype(dtype)) for v in (a, x, Bm, Cm, h0)]


@pytest.mark.parametrize("S", [1, 70, 130])
def test_plain_backward_matches_autograd_of_the_plain_forward(S):
    """The adjoint recurrence (``mamba2_scan_bwd_ref``) against autograd
    of ``mamba2_scan_ref`` in f64 (the same math: agreement to rounding),
    at S within one segment and across two and three."""
    ins = [x.requires_grad_(True) for x in
           _scan_inputs(3, 2, S, 3, 16, P=8, dtype=np.float64)]
    y, hf, states = tref.mamba2_scan_ref(*ins)
    rng = np.random.RandomState(4)
    dy = torch.from_numpy(rng.randn(*y.shape))
    dh = torch.from_numpy(rng.randn(*hf.shape))
    want = torch.autograd.grad(torch.sum(y * dy) + torch.sum(hf * dh), ins)
    got = tref.mamba2_scan_bwd_ref(dy, dh, *(x.detach() for x in ins[:4]),
                                   states.detach())
    assert states.shape[2] == -(-S // tref.MAMBA2_CKPT)
    for name, a, b in zip(("a", "xdt", "Bm", "Cm", "h0"), got, want,
                          strict=True):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


def test_plain_forward_matches_a_float64_loop():
    """``mamba2_scan_ref`` (f32) against the same recurrence in f64 numpy,
    in the order of JAX's ``step``, at S = 130 (three checkpoint
    segments): y, the final state and every saved state."""
    a, x, Bm, Cm, h0 = _scan_inputs(6, 2, 130, 2, 16)
    y, hf, states = tref.mamba2_scan_ref(a, x, Bm, Cm, h0)
    a, x, Bm, Cm, h = (v.numpy().astype(np.float64)
                       for v in (a, x, Bm, Cm, h0))
    ys, saved = [], []
    for t in range(130):
        if t % tref.MAMBA2_CKPT == 0:
            saved.append(h)
        h = a[:, t, :, None, None] * h + x[:, t, :, :, None] * \
            Bm[:, t, None, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), **F32_TOL)
    np.testing.assert_allclose(hf.numpy(), h, **F32_TOL)
    np.testing.assert_allclose(states.numpy(), np.stack(saved, 2),
                               **F32_TOL)


class _Count:
    """Counts calls of the plain versions the wrappers reach on the CPU."""

    NAMES = ("mamba2_scan_ref", "mamba2_scan_bwd_ref")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(tref, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(tref, name, counted)


def test_autograd_function_under_vmap_equals_per_cohort_calls(monkeypatch):
    """vmap(grad_and_value) over 2 cohorts through Mamba2Scan /
    Mamba2ScanBwd, with a per-cohort parameter and h0 unbatched (made
    inside the loss, as init_mamba_state is): one call of each wrapper
    for both cohorts, and the values and gradients of each cohort's own
    call."""
    C, Bn, S, H, N = 2, 2, 70, 2, 16
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(C, Bn, S, H, tm.HEAD_DIM)
                         .astype(np.float32))
    wp = torch.from_numpy(rng.randn(C, H).astype(np.float32))
    bc = torch.from_numpy(rng.randn(C, Bn, S, 2 * N).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(Bn, H, tm.HEAD_DIM, N)
                          .astype(np.float32) * 0.3)

    def loss(wp, x, bc, h0):
        a = torch.sigmoid(x.mean(-1) + wp)
        y, hf = tms.mamba2_recurrence(a, x * wp[:, None], bc[..., :N],
                                      bc[..., N:], h0)
        return torch.sum(y * x) + torch.sum(hf * hf)

    count = _Count(monkeypatch)
    g, val = vmap(grad_and_value(loss, argnums=(0, 1, 2)),
                  in_dims=(0, 0, 0, None))(wp, x, bc, h0)
    assert count.calls == dict.fromkeys(_Count.NAMES, 1)
    for c in range(C):
        gc, vc = grad_and_value(loss, argnums=(0, 1, 2))(wp[c], x[c], bc[c],
                                                          h0)
        # the cohorts folded into the batch: the same plain math over B = 4
        # rows as over B = 2, but einsum may split its sums otherwise
        # (one f32 rounding: 1e-6 of the largest element)
        for name, got, want in zip(("loss", "wp", "x", "bc"),
                                   (val[c], *(x[c] for x in g)), (vc, *gc)):
            err = float((got - want).abs().max())
            assert err <= 1e-6 * (1 + float(want.abs().max())), (name, err)


def test_wrappers_check_their_operands():
    a, x, Bm, Cm, h0 = _scan_inputs(3, 1, 20, 2, 16)
    y, hf, states = tms.mamba2_fwd(a, x, Bm, Cm, h0)
    assert states.shape == (1, 2, 1, tm.HEAD_DIM, 16)
    with pytest.raises(TypeError):
        tms.mamba2_fwd(a.double(), x, Bm, Cm, h0)
    with pytest.raises(ValueError):
        tms.mamba2_fwd(a, x, Bm[..., :8], Cm, h0)
    with pytest.raises(ValueError):
        tms.mamba2_fwd(a, x, Bm, Cm, h0[:, :1])
    with pytest.raises(ValueError):
        tms.mamba2_bwd(torch.zeros_like(y), torch.zeros_like(hf), a, x, Bm,
                       Cm, states[:, :, :0])
    with pytest.raises(ValueError):
        tms.mamba2_fwd(a, x.transpose(2, 3).contiguous().transpose(2, 3),
                       Bm, Cm, h0)
