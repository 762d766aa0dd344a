"""The port's flash attention (repro_torch.kernels.flash_attention and the
plain versions in repro_torch.kernels.ref) against the JAX package's.

The Pallas kernel cannot run on this container's jax (no ``pl.load``),
so the reference is the JAX package's own ``kernels/ref.py:
flash_attention_ref`` and ``jax.vjp`` of it. On the CPU the wrappers run
the plain versions, so these tests hold the math the CUDA kernels are
held to on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py),
and the autograd/vmap plumbing the client plane runs them through.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.func import grad_and_value, vmap

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref as jref
from repro.models import attention as jattn
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.utils.tree import params_from_numpy

# f32: the same f32 math summed in another order (XLA vs PyTorch einsum)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 output: the f32 result rounded once to bf16 in each package; an
# f32 difference at a rounding midpoint flips one ulp (2**-8 relative)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _grad_tol(want):
    """f32 gradients that are sums with cancellation (dS = P(dP - D), D
    = rowsum(dO*O) here, rowsum(P*dP) in autodiff): their rounding scales
    with the largest term, not with each result, so atol is 1e-6 of the
    largest |gradient| (measured: 1.6e-6 at hd 128 on values up to 2.8,
    under 1e-6 at hd 64 and 96, whose cases keep F32_TOL)."""
    return dict(rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))


#: (hd, causal, window, S)
CASES = [(64, True, 0, 128), (64, True, 48, 128), (64, False, 0, 64),
         (96, True, 0, 64), (128, True, 0, 128), (64, False, 32, 64)]


def _qkv(seed, B, S, H, hd, Hkv=None):
    """q (B, S, H, hd) and k, v (B, S, Hkv, hd), Hkv = H by default."""
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, h, hd).astype(np.float32)
            for h in (H, Hkv or H, Hkv or H)]


def _jref_lse(q, k, causal, window):
    """The row log-sum-exp of JAX's masked scores, in f32 numpy."""
    S, hd = q.shape[1], q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * hd ** -0.5
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = kp <= qp if causal else np.ones((S, S), bool)
    if window:
        mask = mask & (kp > qp - window)
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))).astype(np.float32)


@pytest.mark.parametrize("hd,causal,window,S", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax_ref(hd, causal, window, S, dtype):
    q, k, v = _qkv(0, 2, S, 3, hd)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, causal=causal, window=window)
                      .astype(jnp.float32))
    tq, tk, tv = (params_from_numpy(np.asarray(x)) for x in (jq, jk, jv))
    out, lse = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                        window=window)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), want, **tol)
    # lse against a float64 computation from the same inputs
    np.testing.assert_allclose(
        lse.numpy(), _jref_lse(np.asarray(jq.astype(jnp.float32)),
                               np.asarray(jk.astype(jnp.float32)), causal,
                               window), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,causal,window,S", CASES)
def test_plain_backward_matches_jax_grad(hd, causal, window, S):
    """flash_attention_bwd_ref (the explicit D / dS formula the backward
    kernels compute) against jax.vjp of JAX's plain attention, f32."""
    q, k, v = _qkv(1, 2, S, 2, hd)
    dout = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jref(a, b, c, causal=causal,
                                            window=window), q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x) for x in (dout, q, k, v)]
    tout, lse = tref.flash_attention_ref(*t[1:], causal=causal,
                                         window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **F32_TOL)
    tgrads = tref.flash_attention_bwd_ref(t[0], *t[1:], tout, lse,
                                          causal=causal, window=window)
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **(F32_TOL if hd < 128
                                      else _grad_tol(np.asarray(b))))
    # the per-kernel plain versions compose to the same gradient
    dq, delta = tref.flash_bwd_dq_ref(t[0], *t[1:], tout, lse,
                                      causal=causal, window=window)
    dk, dv = tref.flash_bwd_dkdv_ref(t[0], *t[1:], lse, delta,
                                     causal=causal, window=window)
    for a, b in zip((dq, dk, dv), tgrads):
        assert torch.equal(a, b)


class _Count:
    """Counts calls of the plain versions the wrappers reach on the CPU."""

    NAMES = ("flash_attention_ref", "flash_bwd_dq_ref", "flash_bwd_dkdv_ref")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(tref, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(tref, name, counted)


@pytest.mark.parametrize("window,unbatched_kv", [(0, False), (24, True)])
def test_autograd_function_under_vmap_matches_autograd_of_plain_math(
        monkeypatch, window, unbatched_kv):
    """vmap(grad_and_value) over 3 cohorts through FlashAttention /
    FlashAttentionBwd (their vmap rules fold the cohort axis into B)
    against autograd of the plain math: one forward and one call of each
    backward pass for all cohorts together."""
    plain = tref.flash_attention_ref
    count = _Count(monkeypatch)
    C, B, S, H, hd = 3, 2, 64, 2, 32
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(C, hd, hd).astype(np.float32) * 0.3)
    x = torch.from_numpy(rng.randn(C, B, S, H, hd).astype(np.float32))
    kv = torch.from_numpy(rng.randn(B, S, H, hd).astype(np.float32))
    kv_c = kv if unbatched_kv else kv.expand(C, *kv.shape).clone()

    def loss(fn, w, x, kv):
        q, k = x @ w, kv @ w.T
        return torch.sum(fn(q, k, kv) * x)

    def via_kernel(q, k, v):
        return tfa.flash_attention(q, k, v, causal=True, window=window)

    def via_plain(q, k, v):
        return plain(q, k, v, causal=True, window=window)[0]

    in_dims = (0, 0, None if unbatched_kv else 0)
    g, val = vmap(grad_and_value(lambda *a: loss(via_kernel, *a),
                                 argnums=(0, 1)), in_dims=in_dims)(w, x, kv_c)
    assert count.calls == dict.fromkeys(_Count.NAMES, 1)
    g2, val2 = vmap(grad_and_value(lambda *a: loss(via_plain, *a),
                                   argnums=(0, 1)), in_dims=in_dims)(w, x,
                                                                     kv_c)
    torch.testing.assert_close(val, val2, **F32_TOL)
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, **_grad_tol(b.numpy()))


def test_flash_attention_keeps_the_tpu_kernels_contract():
    """The positional signature of the TPU kernel, its default scale and
    its shape contract: S a multiple of min(128, S)."""
    pos = [n for n, p in inspect.signature(jflash).parameters.items()
           if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert [n for n, p in inspect.signature(tfa.flash_attention)
            .parameters.items() if p.kind == p.POSITIONAL_OR_KEYWORD] == pos
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 100, 2, 64))
    out = tfa.flash_attention(q, k, v)          # S <= 128: one block
    want, _ = tref.flash_attention_ref(q, k, v, scale=64 ** -0.5)
    assert torch.equal(out, want)
    for S in (200, 130):
        q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, S, 2, 64))
        with pytest.raises(ValueError, match="multiple of"):
            tfa.flash_attention(q, k, v)
        with pytest.raises(ValueError, match="multiple of"):
            tfa.flash_fwd(q, k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :128], v)


@pytest.mark.parametrize("window", [0, 16])
def test_attention_fwd_matches_jax_chunked_attention(window):
    """The port's attention_fwd (q pre-scaled in the model dtype, the
    flash path with scale 1) against JAX's attention_fwd (the XLA
    chunked_attention), reduced minitron-8b in f32, params from JAX."""
    kw = dict(dtype="float32", sliding_window=window, attn_chunk=32)
    jcfg = jreduced(JARCHS["minitron-8b"], **kw)
    tcfg = treduced(TARCHS["minitron-8b"], **kw)
    jp = jattn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.random.RandomState(6).randn(2, 64, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    want = jattn.attention_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.attention_fwd(params_from_numpy(jax.tree.map(np.asarray,
                                                             jp)),
                              tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -------------------------------------------------------------- GQA kv --

#: (hd, causal, window, S, H, Hkv): n_rep 2 and 4
GQA_CASES = [(64, True, 0, 128, 4, 2), (64, True, 48, 128, 4, 1),
             (96, False, 0, 64, 8, 2), (128, True, 0, 128, 4, 2),
             (64, False, 32, 64, 8, 4)]


@pytest.mark.parametrize("hd,causal,window,S,H,Hkv", GQA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gqa_forward_matches_jax_ref(hd, causal, window, S, H, Hkv,
                                           dtype):
    """The plain forward with k, v at Hkv < H heads against JAX's
    flash_attention_ref on kv repeated by jnp.repeat (the JAX model's
    _repeat_kv)."""
    q, k, v = _qkv(7, 2, S, H, hd, Hkv)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    n_rep = H // Hkv
    want = np.asarray(jref(jq, jnp.repeat(jk, n_rep, axis=2),
                           jnp.repeat(jv, n_rep, axis=2), causal=causal,
                           window=window).astype(jnp.float32))
    tq, tk, tv = (params_from_numpy(np.asarray(x)) for x in (jq, jk, jv))
    out, lse = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                        window=window)
    assert out.shape == tq.shape and lse.shape == (2, H, S)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), want, **tol)
    np.testing.assert_allclose(
        lse.numpy(), _jref_lse(np.asarray(jq.astype(jnp.float32)),
                               np.repeat(np.asarray(jk.astype(jnp.float32)),
                                         n_rep, axis=2), causal, window),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd,causal,window,S,H,Hkv", GQA_CASES)
def test_plain_gqa_backward_matches_jax_grad(hd, causal, window, S, H, Hkv):
    """Both plain backward passes with k, v at Hkv < H heads against
    jax.vjp of JAX's plain attention on kv repeated by jnp.repeat: dk and
    dv come back at Hkv heads, summed over each kv head's query heads."""
    q, k, v = _qkv(8, 2, S, H, hd, Hkv)
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    n_rep = H // Hkv

    def fn(a, b, c):
        return jref(a, jnp.repeat(b, n_rep, axis=2),
                    jnp.repeat(c, n_rep, axis=2), causal=causal,
                    window=window)
    out, vjp = jax.vjp(fn, q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x) for x in (dout, q, k, v)]
    tout, lse = tref.flash_attention_ref(*t[1:], causal=causal,
                                         window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **F32_TOL)
    dq, delta = tref.flash_bwd_dq_ref(t[0], *t[1:], tout, lse,
                                      causal=causal, window=window)
    dk, dv = tref.flash_bwd_dkdv_ref(t[0], *t[1:], lse, delta,
                                     causal=causal, window=window)
    assert dk.shape == t[2].shape and dv.shape == t[3].shape
    for name, a, b in zip("qkv", (dq, dk, dv), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **(F32_TOL if hd < 128
                                      else _grad_tol(np.asarray(b))))
    # the composed reference gives the same gradients
    for a, b in zip(tref.flash_attention_bwd_ref(t[0], *t[1:], tout, lse,
                                                 causal=causal,
                                                 window=window),
                    (dq, dk, dv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window,unbatched_kv", [(0, False), (24, True)])
def test_gqa_autograd_function_under_vmap_matches_autograd_of_plain_math(
        monkeypatch, window, unbatched_kv):
    """vmap(grad_and_value) over 3 cohorts through FlashAttention with k
    and v at 2 of q's 4 heads (the vmap rules fold the cohort axis of
    the 2-head kv into B as they do q's) against autograd of the plain
    math: one forward and one call of each backward pass."""
    plain = tref.flash_attention_ref
    count = _Count(monkeypatch)
    C, B, S, H, Hkv, hd = 3, 2, 64, 4, 2, 32
    rng = np.random.RandomState(10)
    w = torch.from_numpy(rng.randn(C, hd, hd).astype(np.float32) * 0.3)
    x = torch.from_numpy(rng.randn(C, B, S, H, hd).astype(np.float32))
    kv = torch.from_numpy(rng.randn(B, S, Hkv, hd).astype(np.float32))
    kv_c = kv if unbatched_kv else kv.expand(C, *kv.shape).clone()

    def loss(fn, w, x, kv):
        q, k = x @ w, kv @ w.T
        return torch.sum(fn(q, k, kv) * x)

    def via_kernel(q, k, v):
        return tfa.flash_attention(q, k, v, causal=True, window=window)

    def via_plain(q, k, v):
        return plain(q, k, v, causal=True, window=window)[0]

    in_dims = (0, 0, None if unbatched_kv else 0)
    g, val = vmap(grad_and_value(lambda *a: loss(via_kernel, *a),
                                 argnums=(0, 1)), in_dims=in_dims)(w, x, kv_c)
    assert count.calls == dict.fromkeys(_Count.NAMES, 1)
    g2, val2 = vmap(grad_and_value(lambda *a: loss(via_plain, *a),
                                   argnums=(0, 1)), in_dims=in_dims)(w, x,
                                                                     kv_c)
    torch.testing.assert_close(val, val2, **F32_TOL)
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, **_grad_tol(b.numpy()))


@pytest.mark.parametrize("name", ["flash_attention", "flash_fwd",
                                  "flash_bwd_dq", "flash_bwd_dkdv"])
def test_wrappers_refuse_kv_heads_that_do_not_divide_q_heads(name):
    """H % Hkv != 0 is refused by every entry (the kernels would read past
    the last kv head)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, 1, 64, 6, 32, 4))
    fn = getattr(tfa, name)
    B, S, H, _ = q.shape
    rows = torch.zeros(B, H, S)
    args = {"flash_attention": (q, k, v), "flash_fwd": (q, k, v),
            "flash_bwd_dq": (q, q, k, v, q, rows),
            "flash_bwd_dkdv": (q, q, k, v, rows, rows)}[name]
    with pytest.raises(ValueError, match="must divide"):
        fn(*args)


def test_attention_fwd_hands_the_kernel_unrepeated_kv(monkeypatch):
    """attention_fwd on the reduced minitron-8b (4 query heads over 2 kv
    heads) gives the flash entry k and v at 2 heads (no _repeat_kv in the
    port) and matches JAX's attention_fwd (kv repeated, chunked_attention)
    in f32."""
    assert not hasattr(tattn, "_repeat_kv")
    kw = dict(dtype="float32", attn_chunk=32)
    jcfg = jreduced(JARCHS["minitron-8b"], **kw)
    tcfg = treduced(TARCHS["minitron-8b"], **kw)
    assert (tcfg.num_heads, tcfg.num_kv_heads) == (4, 2)
    seen = []
    real = tattn.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], v.shape[2]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn, "flash_attention", spy)
    jp = jattn.attn_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.RandomState(12).randn(2, 128, jcfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
    want = jattn.attention_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.attention_fwd(params_from_numpy(jax.tree.map(np.asarray,
                                                             jp)),
                              tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    assert seen == [(4, 2, 2)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
