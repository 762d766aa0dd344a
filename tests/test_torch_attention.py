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
from repro_torch.kernels.serve_attention import serve_cross_attention
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
    """The positional signature of the TPU kernel and its default scale;
    not its 128-row blocks: any S goes (100, 200, 130 here), and q may
    have another length than k and v only without a causal mask or a
    window (cross-attention), which every wrapper refuses otherwise."""
    pos = [n for n, p in inspect.signature(jflash).parameters.items()
           if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert [n for n, p in inspect.signature(tfa.flash_attention)
            .parameters.items() if p.kind == p.POSITIONAL_OR_KEYWORD] == pos
    for S in (100, 200, 130):
        q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, S, 2, 64))
        out = tfa.flash_attention(q, k, v)
        want, _ = tref.flash_attention_ref(q, k, v, scale=64 ** -0.5)
        assert torch.equal(out, want)
        assert torch.equal(tfa.flash_fwd(q, k, v)[0], want)
    out = tfa.flash_attention(q, k[:, :128], v[:, :128], causal=False)
    assert out.shape == q.shape
    for kw in (dict(), dict(causal=False, window=16)):
        with pytest.raises(ValueError, match="cross-attention"):
            tfa.flash_attention(q, k[:, :128], v[:, :128], **kw)
        with pytest.raises(ValueError, match="cross-attention"):
            tfa.flash_fwd(q, k[:, :128], v[:, :128], **kw)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :128], v, causal=False)


#: (Sq, Skv, causal, window, H, Hkv): ragged self-attention (no multiple
#: of 128 or of the kernels' tiles) and cross-attention (Sq != Skv, GQA)
RAGGED = [(200, 200, True, 0, 2, 2), (130, 130, False, 0, 2, 2),
          (150, 150, True, 48, 4, 2), (40, 100, False, 0, 2, 2),
          (1, 100, False, 0, 4, 2), (129, 64, False, 0, 2, 1)]


@pytest.mark.parametrize("Sq,Skv,causal,window,H,Hkv", RAGGED)
def test_plain_versions_at_any_length_match_jax_chunked_attention(
        Sq, Skv, causal, window, H, Hkv):
    """The plain forward and backward at ragged S and at Sq != Skv
    against the JAX model's own ``chunked_attention`` (kv repeated to H
    heads with ``jnp.repeat``, chunks of 64 with its padded tail) and
    ``jax.vjp`` of it, f32."""
    hd = 64
    rng = np.random.RandomState(Sq + Skv)
    q = rng.randn(2, Sq, H, hd).astype(np.float32)
    k, v = (rng.randn(2, Skv, Hkv, hd).astype(np.float32) for _ in "kv")
    dout = rng.randn(*q.shape).astype(np.float32)
    qp = np.broadcast_to(np.arange(Sq, dtype=np.int32), (2, Sq))
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (2, Skv))

    def jfn(a, b, c):
        b, c = (jnp.repeat(x, H // Hkv, axis=2) for x in (b, c))
        return jattn.chunked_attention(a, b, c, jnp.asarray(qp),
                                       jnp.asarray(kp), causal=causal,
                                       window=window, chunk=64)

    want, vjp = jax.vjp(jfn, q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x) for x in (dout, q, k, v)]
    out, lse = tref.flash_attention_ref(*t[1:], causal=causal, window=window)
    assert lse.shape == (2, H, Sq)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    dq, delta = tref.flash_bwd_dq_ref(t[0], *t[1:], out, lse, causal=causal,
                                      window=window)
    dk, dv = tref.flash_bwd_dkdv_ref(t[0], *t[1:], lse, delta,
                                     causal=causal, window=window)
    assert dk.shape == dv.shape == (2, Skv, Hkv, hd)
    for name, a, b in zip("qkv", (dq, dk, dv), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **_grad_tol(np.asarray(b)))
    # the differentiable entry and its vmap rule at these lengths
    got = vmap(lambda a, b, c: tfa.flash_attention(
        a, b, c, causal=causal, window=window))(*(x[None] for x in t[1:]))
    assert torch.equal(got[0], out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_plain_version_matches_jax_cross_attention_decode(dtype):
    """``attention.cross_attention_decode`` (wq, then the plain version
    of serve_attention's cross form, then wo) against JAX's at the
    reduced whisper config (4 query heads over 2 kv heads, 100 encoder
    keys), at c = 1 and at a chunk of 6; the chunk's rows equal the
    c = 1 rows bit for bit."""
    kw = dict(dtype=dtype)
    jcfg = jreduced(JARCHS["whisper-medium"], **kw)
    tcfg = treduced(TARCHS["whisper-medium"], **kw)
    jp = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jnp.dtype(dtype))
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, jcfg.d_model).astype(np.float32)
    ek, ev = (rng.randn(2, 100, 2, 64).astype(np.float32) for _ in "kv")
    jx, jk, jv = (jnp.asarray(a, dtype) for a in (x, ek, ev))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tx, tk, tv = (params_from_numpy(np.asarray(a)) for a in (jx, jk, jv))
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    rows = []
    for i in range(6):
        want = jattn.cross_attention_decode(jp, jcfg, jx[:, i:i + 1], jk, jv)
        got = tattn.cross_attention_decode(
            tp, tcfg, tx[:, i:i + 1].contiguous(), tk, tv)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
        rows.append(got)
    chunk = tattn.cross_attention_decode(tp, tcfg, tx, tk, tv)
    assert torch.equal(chunk, torch.cat(rows, 1))
    q = torch.from_numpy(rng.randn(2, 6, 4, 64).astype(np.float32))
    with pytest.raises(ValueError, match="divide"):
        serve_cross_attention(q, tk[:, :, :1].repeat(1, 1, 3, 1),
                              tv[:, :, :1].repeat(1, 1, 3, 1))


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
