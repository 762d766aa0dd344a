"""The port's mixture-of-experts layer (repro_torch.models.moe) against
the JAX package's (repro.models.moe) on the CPU, at reduced size.

Routing is held first and exactly: the experts each token picks, the
order among equal probabilities (``jax.lax.top_k`` puts the lower index
first) and each assignment's place in its expert's buffer, capacity
drops included, for the global dispatch and the blocked one (groups of
``moe_group_size`` tokens). Then the values: ``moe_apply``'s output, aux
loss and gradients, and ``moe_apply_dense``'s output, within F32_TOL.
Parameters come from JAX's ``moe_init`` through numpy; inputs from numpy
with a seed. Last, the serving form ``moe_serve`` is ``moe_apply_dense``
bit for bit on the CPU, with the launches it makes on the card counted
as plain calls here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.models import moe as jmoe
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.utils.tree import flatten, leaves, params_from_numpy

F32_TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "phi3.5-moe-42b-a6.6b"


def _cfgs(dtype="float32", **kw):
    jcfg = jreduced(JARCHS[ARCH], dtype=dtype, **kw)
    tcfg = treduced(TARCHS[ARCH], dtype=dtype, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    dtype = jnp.dtype(jcfg.dtype)
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                jcfg, dtype))
    return jp, params_from_numpy(jp)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _probs(T, E, seed=2, skew=0.0):
    """Softmax of random logits; ``skew`` > 0 piles the first experts up
    (past their capacity)."""
    lg = np.random.RandomState(seed).randn(T, E).astype(np.float32)
    lg[:, :2] += skew
    return np.array(jax.nn.softmax(jnp.asarray(lg), axis=-1))


def test_moe_tree_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    jflat, tflat = dict(flatten(jp)), dict(flatten(tp))
    assert jflat.keys() == tflat.keys() == {"router/w", "w_in", "w_gate",
                                            "w_out"}
    for k, x in jflat.items():
        assert tuple(tflat[k].shape) == x.shape, k
        assert str(tflat[k].dtype).split(".")[-1] == str(x.dtype), k
    for T in (8, 32, 100, 4096):
        assert tmoe._capacity(T, tcfg) == jmoe._capacity(T, jcfg)


def test_top_k_puts_the_lower_index_first_among_ties():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmoe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), [[0, 1], [1, 2], [0, 2],
                                               [1, 3]])


@pytest.mark.parametrize("skew", [0.0, 4.0])
@pytest.mark.parametrize("groups", [1, 4])
def test_routing_equals_jax(skew, groups):
    """The same probabilities routed by both packages: expert indices,
    the keep mask (capacity drops under ``skew``) and each kept
    assignment's buffer slot equal, through the dispatch tensor, which is
    one-hot; the combine weights within F32_TOL. ``groups`` 4: the
    blocked path's four groups of 8 tokens, vmapped in JAX, batched in
    the port."""
    jcfg, tcfg = _cfgs()
    T, E, K = 32, tcfg.num_experts, tcfg.top_k
    probs = _probs(T, E, skew=skew)
    x = _x((T, tcfg.d_model))
    if groups == 1:
        jd, jc = jmoe._dispatch_combine(jnp.asarray(x), jnp.asarray(probs),
                                        jcfg)
        td, tc = tmoe._dispatch_combine(torch.from_numpy(x),
                                        torch.from_numpy(probs), tcfg)
    else:
        G = groups
        xg, pg = x.reshape(G, T // G, -1), probs.reshape(G, T // G, E)
        jd, jc = jax.vmap(lambda xx, pp: jmoe._dispatch_combine(
            xx, pp, jcfg))(jnp.asarray(xg), jnp.asarray(pg))
        td, tc = tmoe._dispatch_combine(torch.from_numpy(xg),
                                        torch.from_numpy(pg), tcfg)
    jd, jc = np.asarray(jd), np.asarray(jc)
    assert td.shape == jd.shape and td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, **F32_TOL)
    # the routing itself: experts, keep mask, slots
    pt = probs.reshape(groups, T // groups, E)
    _, ji = jax.lax.top_k(jnp.asarray(pt), K)
    _, ti = tmoe._top_k(torch.from_numpy(pt), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    d = td.numpy().reshape(groups, T // groups, E, -1)
    ti = ti.numpy()
    keep = np.take_along_axis(d.sum(-1), ti, axis=-1) > 0
    jkeep = np.take_along_axis(jd.reshape(d.shape).sum(-1),
                               np.asarray(ji), axis=-1) > 0
    np.testing.assert_array_equal(keep, jkeep)
    if skew and groups == 1:
        assert not keep.all()          # the capacity dropped assignments
    else:
        assert keep[..., 0].all()


@pytest.mark.parametrize("group", [0, 8])
def test_moe_apply_output_aux_and_gradients_match_jax(group):
    """f32: the output, the aux loss and the gradients of a loss of both
    (w.r.t. x and every parameter) within F32_TOL. group 8 at T 32 takes
    the blocked path in both packages, 0 the global one."""
    jcfg, tcfg = _cfgs(moe_group_size=group)
    jp, tp = _params(jcfg)
    x = _x((2, 16, tcfg.d_model))
    r = _x((2, 16, tcfg.d_model), seed=3)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, jcfg, x)
        return jnp.sum(out * r) + aux, (out, aux)

    (jl, (jout, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for a in leaves(tp):
        a.requires_grad_(True)
    tout, taux = tmoe.moe_apply(tp, tcfg, tx)
    tl = torch.sum(tout * torch.from_numpy(r)) + taux
    grads = torch.autograd.grad(tl, [tx, *leaves(tp)])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F32_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **F32_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg[1]),
                               **F32_TOL)
    jflat = dict(flatten(jax.tree.map(np.asarray, jg[0])))
    for (k, _), g in zip(flatten(tp), grads[1:], strict=True):
        np.testing.assert_allclose(g.numpy(), jflat[k], err_msg=k,
                                   **F32_TOL)


def test_blocked_and_global_paths_differ_only_in_capacity():
    """With a capacity that drops nothing (a generous capacity_factor)
    the blocked path gives the global path's output within rounding, in
    both packages; the port's blocked path is taken (T > group, T a
    multiple of it) exactly where JAX's is."""
    jcfg, tcfg = _cfgs(capacity_factor=8.0)
    jp, tp = _params(jcfg)
    x = _x((2, 16, tcfg.d_model))
    out = {}
    for g in (0, 8):
        out[g] = tmoe.moe_apply(tp, tcfg.with_(moe_group_size=g),
                                torch.from_numpy(x))[0]
        j = jmoe.moe_apply(jax.tree.map(jnp.asarray, jp),
                           jcfg.with_(moe_group_size=g), jnp.asarray(x))[0]
        np.testing.assert_allclose(out[g].numpy(), np.asarray(j), **F32_TOL)
    torch.testing.assert_close(out[0], out[8], **F32_TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_moe_apply_dense_matches_jax(S):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((3, S, tcfg.d_model))
    jout, jaux = jmoe.moe_apply_dense(jax.tree.map(jnp.asarray, jp), jcfg,
                                      jnp.asarray(x))
    tout, taux = tmoe.moe_apply_dense(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    assert float(taux) == float(jaux) == 0.0


def test_dense_router_picks_jaxs_experts(monkeypatch):
    """The dense path's router: the probabilities handed to the top-k
    (the f32 product, then ``torch.softmax``) within F32_TOL of JAX's,
    and the experts each token picks equal to ``jax.lax.top_k``'s."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((3, 5, tcfg.d_model))
    seen = []
    real = tmoe._top_k

    def kept(probs, k):
        seen.append(probs)
        return real(probs, k)
    monkeypatch.setattr(tmoe, "_top_k", kept)
    tmoe.moe_apply_dense(tp, tcfg, torch.from_numpy(x))
    (probs,) = seen
    xt = jnp.asarray(x.reshape(-1, tcfg.d_model))
    jprobs = jax.nn.softmax(xt @ jnp.asarray(jp["router"]["w"]), axis=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **F32_TOL)
    _, jidx = jax.lax.top_k(jprobs, tcfg.top_k)
    np.testing.assert_array_equal(real(probs, tcfg.top_k)[1].numpy(),
                                  np.asarray(jidx))


class _CountRef:
    """Counts ``ref.invariant_dense_ref`` calls (the wrapper's CPU path)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = tref.invariant_dense_ref

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        monkeypatch.setattr(tref, "invariant_dense_ref", counted)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_serve_is_moe_apply_dense_bitwise_on_the_cpu(dtype,
                                                         monkeypatch):
    """The serving form on the CPU: ``moe_apply_dense``'s bits, every row
    the same whether it comes alone or with others, and the projections
    through the row-invariant GEMM's wrapper: 1 + 3 E plain calls (the
    router, then each expert's w_in, w_gate and w_out; on the card the
    pairs of two experts share a launch: 1 + E / 2 + E launches)."""
    jcfg, tcfg = _cfgs(dtype)
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x((4, 3, tcfg.d_model))).to(getattr(torch, dtype))
    want = tmoe.moe_apply_dense(tp, tcfg, x)[0]
    count = _CountRef(monkeypatch)
    got = tmoe.moe_serve(tp, tcfg, x)[0]
    assert got.dtype == x.dtype
    assert torch.equal(got, want)
    assert count.calls == 1 + 3 * tcfg.num_experts
    for b in range(x.shape[0]):
        assert torch.equal(tmoe.moe_serve(tp, tcfg, x[b:b + 1])[0],
                           got[b:b + 1])


def test_moe_apply_runs_under_vmap_over_cohorts():
    """The client plane runs the loss under ``torch.func.vmap`` over
    cohorts: the dispatch's one-hots and sort work there, and each
    cohort's result is its own call's."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    xs = torch.from_numpy(_x((2, 2, 16, tcfg.d_model)))
    out, aux = torch.func.vmap(lambda x: tmoe.moe_apply(tp, tcfg, x))(xs)
    for c in range(2):
        o, a = tmoe.moe_apply(tp, tcfg, xs[c])
        torch.testing.assert_close(out[c], o, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(aux[c], a, rtol=1e-6, atol=1e-7)
