"""The port's serving attention and decode steps (repro_torch.kernels.
serve_attention and its plain version, the serving functions of
models/attention.py, models/transformer.py and models/rwkv6.py) against
the JAX package's, at reduced size on the CPU.

Params and cache states start in numpy (JAX's init, seeded draws) and
cross to both packages unchanged. On the CPU the wrapper runs the plain
version, whose math the CUDA kernel is held to on the card
(chip_smoke.py, tests/test_torch_kernels_gpu.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtf
from repro.models.api import build_model as jbuild
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ref as tref
from repro_torch.kernels import serve_attention as tsa
from repro_torch.models import attention as tattn
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import flatten, params_from_numpy, params_to_numpy

# f32: the same math summed in other orders (XLA's einsums against the
# plain version's sequential sums); bf16: two ulps at 1 (the outputs and
# the projections feeding them round to bf16 in both packages, XLA's and
# PyTorch's CPU dots may round a bf16 result one way or the other)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's ops on one intra-op thread: its many small ops
    slow down by orders of magnitude when several test workers' thread
    pools spin on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _cfgs(arch, dtype, window=0):
    j = jreduced(JARCHS[arch], dtype=dtype)
    t = treduced(TARCHS[arch], dtype=dtype)
    if window:
        j, t = j.with_(sliding_window=window), t.with_(sliding_window=window)
    return j, t


@functools.cache
def _jparams(cfg, seed=0):
    """JAX's init of ``cfg`` as numpy (made once a config)."""
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(
        seed)))


def _np(x, dtype):
    """f32 numpy -> numpy in ``dtype`` (bf16 through JAX's rounding)."""
    return np.array(jnp.asarray(x, jnp.float32).astype(dtype))


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=msg,
                               **_tol(dtype))


def _tnp(x):
    return params_to_numpy({"x": x})["x"]


# ------------------------------------------------- attention entry points --

def _state(cfg, dtype, c, window, seed):
    """A decode cache that has seen positions below each row's first (the
    ring wrapped under the window), a chunk x (B, c, d) at consecutive
    positions from there (the last row's last two rows padding when c >
    2), and the same logical cache as a pool of blocks of 4 under a
    shuffled table (window 0: the rows' last block, empty, unmapped)."""
    rng = np.random.RandomState(seed)
    hd, KH = cfg.resolved_head_dim, cfg.num_kv_heads
    L = 8 if window else 24
    p0 = np.array([13, 21]) if window else np.array([3, 7])
    s = np.arange(L)
    pos = p0[:, None] - 1 - np.mod(p0[:, None] - 1 - s, L)
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    k = _np(rng.randn(B, L, KH, hd), dtype)
    v = _np(rng.randn(B, L, KH, hd), dtype)
    x = _np(rng.randn(B, c, cfg.d_model), dtype)
    positions = (p0[:, None] + np.arange(c)).astype(np.int32)
    if c > 2:
        positions[-1, -2:] = tref.PAD_POS
    bs = 4
    mb = L // bs
    table = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
    if not window:
        table[:, -1] = 0
    nb = 1 + B * mb
    pk = _np(rng.randn(nb, bs, KH, hd), dtype)
    pv = _np(rng.randn(nb, bs, KH, hd), dtype)
    ppos = np.full((nb, bs), 5, np.int32)         # block 0: garbage
    flat = table.reshape(-1)
    keep = flat > 0
    pk[flat[keep]] = k.reshape(B * mb, bs, KH, hd)[keep]
    pv[flat[keep]] = v.reshape(B * mb, bs, KH, hd)[keep]
    ppos[flat[keep]] = pos.reshape(B * mb, bs)[keep]
    return dict(cache={"k": k, "v": v, "pos": pos},
                pool={"k": pk, "v": pv, "pos": ppos}, x=x,
                positions=positions, table=table,
                ring=np.full((B,), L, np.int32))


def _layer_attn(jcfg):
    """Layer 0's attention params of JAX's reduced init, numpy."""
    return jax.tree.map(lambda a: a[0], _jparams(jcfg)["body"])["attn"]


@pytest.mark.parametrize("entry", ["decode", "prefill", "decode_paged",
                                   "prefill_paged"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_entry_points_match_jax(entry, window, dtype):
    """attention_decode / attention_prefill / their paged variants (the
    plain serve_attention on the CPU) against JAX's: the output and the
    written cache or pool (positions exactly), GQA n_rep 2, the ring
    wrapping under window 8, pad rows, a shuffled block table with a null
    entry under window 0."""
    jcfg, tcfg = _cfgs("minitron-8b", dtype, window)
    c = 1 if entry.startswith("decode") else 5
    st = _state(tcfg, dtype, c, window, seed=window + c)
    jp = _layer_attn(jcfg)
    tp = params_from_numpy(jp)
    paged = entry.endswith("paged")
    store = st["pool"] if paged else st["cache"]
    jstore = {k: jnp.asarray(v) for k, v in store.items()}
    tstore = params_from_numpy(store)
    jx, tx = jnp.asarray(st["x"]), params_from_numpy({"x": st["x"]})["x"]
    pos = st["positions"][:, 0] if c == 1 else st["positions"]
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    jt, tt = jnp.asarray(st["table"]), torch.from_numpy(st["table"])
    jl, tl = jnp.asarray(st["ring"]), torch.from_numpy(st["ring"])
    jfn, tfn = (getattr(jattn, f"attention_{entry}"),
                getattr(tattn, f"attention_{entry}"))
    if paged:
        jout, jnew = jfn(jp, jcfg, jx, jstore, jt, jl, jpos)
        tout, tnew = tfn(tp, tcfg, tx, tstore, tt, tl, tpos)
    else:
        jout, jnew = jfn(jp, jcfg, jx, jstore, jpos)
        tout, tnew = tfn(tp, tcfg, tx, tstore, tpos)
    assert tnew is tstore                     # written in place
    _close(_tnp(tout), jout, dtype, "out")
    for k in ("k", "v"):
        _close(_tnp(tnew[k]), jnew[k], dtype, k)
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))


@pytest.mark.parametrize("window", [0, 8])
def test_plain_version_matches_jax_selection_math(window):
    """The plain serve_attention against JAX's einsum-softmax math of
    attention_prefill's ring selection (kv repeated, the chunk written,
    ``written`` / ``pos_eff``, ``v_eff``) on the same f32 operands,
    within f32 rounding (rtol 1e-5, atol 1e-6): the same function."""
    dtype = "float32"
    jcfg, tcfg = _cfgs("minitron-8b", dtype, window)
    st = _state(tcfg, dtype, 5, window, seed=3)
    rng = np.random.RandomState(9)
    H, KH, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.resolved_head_dim
    q = (0.125 * rng.randn(B, 5, H, hd)).astype(np.float32)
    kn, vn = (rng.randn(B, 5, KH, hd).astype(np.float32) for _ in range(2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tref.serve_attention_ref(
        t(q), t(kn), t(vn), t(st["positions"]), t(st["cache"]["k"]),
        t(st["cache"]["v"]), t(st["cache"]["pos"]), window=window)
    # JAX's math on the same operands: write the chunk, select per row
    cache = {k: jnp.asarray(v) for k, v in st["cache"].items()}
    L = st["cache"]["k"].shape[1]
    pos = jnp.asarray(st["positions"])
    slots = jattn._chunk_slots(pos, L)
    bidx = jnp.arange(B)[:, None]
    real = pos < jattn.PAD_FLOOR
    new = {"k": cache["k"].at[bidx, slots].set(jnp.where(
               real[..., None, None], kn, cache["k"][bidx, slots])),
           "v": cache["v"].at[bidx, slots].set(jnp.where(
               real[..., None, None], vn, cache["v"][bidx, slots])),
           "pos": cache["pos"].at[bidx, slots].set(jnp.where(
               real, pos, cache["pos"][bidx, slots]))}
    rep = lambda a: jnp.repeat(a, H // KH, axis=2)
    s_new = jnp.einsum("bqhd,bkhd->bhqk", q, rep(new["k"]))
    s_old = jnp.einsum("bqhd,bkhd->bhqk", q, rep(cache["k"]))
    written = jnp.logical_and(new["pos"][:, None] != cache["pos"][:, None],
                              new["pos"][:, None] <= pos[..., None])
    pe = jnp.where(written, new["pos"][:, None], cache["pos"][:, None])
    m = jnp.logical_and(pe >= 0, pe <= pos[..., None])
    if window:
        m = jnp.logical_and(m, pe > pos[..., None] - window)
    s = jnp.where(m[:, None], jnp.where(written[:, None], s_new, s_old),
                  jattn.NEG_INF)
    a = jax.nn.softmax(s, axis=-1)
    v_eff = jnp.where(written[..., None, None], rep(new["v"])[:, None],
                      rep(cache["v"])[:, None])
    want = jnp.einsum("bhqk,bqkhd->bqhd", a, v_eff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------- model-level steps --

def _ids(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _assert_caches(tcache, jcache, dtype):
    jflat = dict(flatten(jax.tree.map(np.asarray, jcache)))
    tflat = dict(flatten(params_to_numpy(tcache)))
    assert tflat.keys() == jflat.keys()
    for k in jflat:
        if "pos" in k:
            np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
        else:
            _close(tflat[k], jflat[k], "float32" if np.asarray(
                jflat[k]).dtype == np.float32 else "bfloat16", k)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_prefill_and_paged_steps_match_jax(window, dtype):
    """decode_step, prefill (c 5, a ragged last chunk), decode_step_paged
    and prefill_paged over 11 tokens against JAX's jitted steps: logits
    every step and the final caches (pools) allclose, positions exact."""
    jcfg, tcfg = _cfgs("minitron-8b", dtype, window)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = _jparams(jcfg)
    tp = params_from_numpy(jp)
    P, max_len, bs, c = 11, 20, 4, 5
    prompts = np.random.RandomState(5).randint(1, jcfg.vocab_size, (B, P))
    L = min(max_len, window) if window else max_len
    mb = -(-L // bs)
    table = np.arange(1, 1 + B * mb, dtype=np.int32).reshape(B, mb)
    table = table[:, ::-1].copy()                  # blocks out of order
    ring = np.full((B,), L, np.int32)
    nb = 1 + B * mb

    jc, tc = jm.init_decode_cache(jp, B, max_len), tm.init_decode_cache(
        tp, B, max_len)
    jpool, tpool = jm.init_paged_pool(nb, bs), tm.init_paged_pool(nb, bs)
    jstep, jpaged = jax.jit(jm.decode_step), jax.jit(jm.decode_step_paged)
    for t in range(P):
        tok, pos = prompts[:, t], np.full((B,), t)
        jl, jc = jstep(jp, jnp.asarray(tok, jnp.int32),
                       jnp.asarray(pos, jnp.int32), jc)
        tl, tc = tm.decode_step(tp, _ids(tok), _ids(pos), tc)
        _close(_tnp(tl), jl, dtype, f"decode logits t={t}")
        jl, jpool = jpaged(jp, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32), jpool,
                           jnp.asarray(table), jnp.asarray(ring))
        tl, tpool = tm.decode_step_paged(tp, _ids(tok), _ids(pos), tpool,
                                         _ids(table), _ids(ring))
        _close(_tnp(tl), jl, dtype, f"paged logits t={t}")
    _assert_caches(tc, jc, dtype)
    _assert_caches(tpool, jpool, dtype)

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
        _close(_tnp(tl)[:, :n], np.asarray(jl)[:, :n], dtype, "prefill")
        jl, jpool = jppf(jp, jnp.asarray(toks), jnp.asarray(poss), jpool,
                         jnp.asarray(table), jnp.asarray(ring))
        tl, tpool = tm.prefill_paged(tp, _ids(toks), _ids(poss), tpool,
                                     _ids(table), _ids(ring))
        _close(_tnp(tl)[:, :n], np.asarray(jl)[:, :n], dtype, "paged pf")
    _assert_caches(tc, jc, dtype)
    _assert_caches(tpool, jpool, dtype)


# ------------------------------------------------------------------ rwkv6 --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_step_and_single_channel_mix_match_jax(dtype):
    """One decode token through time_mix_step (the recurrence at S = 1 on
    rwkv6_recurrence) and channel_mix(single=True) from a non-zero state
    against JAX's: outputs and every state leaf allclose (wkv f32)."""
    jcfg, tcfg = _cfgs("rwkv6-3b", dtype)
    jp = jax.tree.map(lambda a: a[0], _jparams(jcfg)["body"])["rwkv"]
    tp = params_from_numpy(jp)
    rng = np.random.RandomState(4)
    d = jcfg.d_model
    H = d // trwkv6.HEAD_DIM
    state = {"wkv": (0.1 * rng.randn(B, H, 64, 64)).astype(np.float32),
             "x_tm": _np(rng.randn(B, d), dtype),
             "x_cm": _np(rng.randn(B, d), dtype)}
    x = _np(rng.randn(B, d), dtype)
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = params_from_numpy(state)
    jx, tx = jnp.asarray(x), params_from_numpy({"x": x})["x"]
    jy, js2 = jrwkv6.time_mix_step(jp, jcfg, jx, js)
    ty, ts2 = trwkv6.time_mix_step(tp, tcfg, tx, ts)
    _close(_tnp(ty), jy, dtype, "time_mix_step")
    jo, js3 = jrwkv6.channel_mix(jp, jx, js2, single=True)
    to, ts3 = trwkv6.channel_mix(tp, tx, ts2, single=True)
    _close(_tnp(to), jo, dtype, "channel_mix")
    np.testing.assert_allclose(ts3["wkv"].numpy(), np.asarray(js3["wkv"]),
                               **F32_TOL)
    for k in ("x_tm", "x_cm"):
        np.testing.assert_array_equal(_tnp(ts3[k]), np.asarray(js3[k]))


def test_rwkv6_decode_step_matches_jax():
    """Six tokens through the reduced rwkv6-3b decode_step (f32) against
    JAX's: logits every step and the stacked recurrent state."""
    jcfg, tcfg = _cfgs("rwkv6-3b", "float32")
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = _jparams(jcfg)
    tp = params_from_numpy(jp)
    assert tm.prefill is None and tm.init_paged_pool is None
    jc, tc = jm.init_decode_cache(jp, B, 8), tm.init_decode_cache(tp, B, 8)
    toks = np.random.RandomState(2).randint(1, jcfg.vocab_size, (B, 6))
    jstep = jax.jit(jm.decode_step)
    for t in range(6):
        pos = np.full((B,), t)
        jl, jc = jstep(jp, jnp.asarray(toks[:, t], jnp.int32),
                       jnp.asarray(pos, jnp.int32), jc)
        tl, tc = tm.decode_step(tp, _ids(toks[:, t]), _ids(pos), tc)
        _close(tl.numpy(), jl, "float32", f"t={t}")
    _assert_caches(tc, jc, "float32")


# ---------------------------------------------------------------- wrapper --

def test_wrapper_refuses_what_the_kernel_does_not_take():
    """c > ring (dense and paged), k heads not dividing q's, int64
    positions, a table without rings, a ring beyond its table, a negative
    window."""
    f = torch.zeros
    q, k = f(1, 9, 4, 64), f(1, 9, 2, 64)
    pos = f(1, 9, dtype=torch.int32)
    ck, cpos = f(1, 8, 2, 64), f(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds the ring"):
        tsa.serve_attention(q, k, k, pos, ck, ck, cpos)
    pk, ppos = f(5, 4, 2, 64), f(5, 4, dtype=torch.int32)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds the ring"):
        tsa.serve_attention(q, k, k, pos, pk, pk, ppos, table,
                            torch.tensor([8], dtype=torch.int32))
    with pytest.raises(ValueError, match="exceeds the table"):
        tsa.serve_attention(q[:, :1], k[:, :1], k[:, :1], pos[:, :1], pk, pk,
                            ppos, table, torch.tensor([17],
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="must divide"):
        tsa.serve_attention(q[:, :1], f(1, 1, 3, 64), f(1, 1, 3, 64),
                            pos[:, :1], ck, ck, cpos)
    with pytest.raises(TypeError):
        tsa.serve_attention(q[:, :1], k[:, :1], k[:, :1],
                            pos[:, :1].long(), ck, ck, cpos)
    with pytest.raises(ValueError, match="both table and ring_len"):
        tsa.serve_attention(q[:, :1], k[:, :1], k[:, :1], pos[:, :1], pk, pk,
                            ppos, table)
    with pytest.raises(ValueError, match="window"):
        tsa.serve_attention(q[:, :1], k[:, :1], k[:, :1], pos[:, :1], ck, ck,
                            cpos, window=-1)
    out = tsa.serve_attention(q[:, :8], k[:, :8], k[:, :8], pos[:, :8], ck,
                              ck, cpos)
    assert out.shape == (1, 8, 4, 64) and tsa.serve_attention.launches == 0


def test_wrapper_keeps_its_plain_versions_signature():
    """The counterpart of fedlint FED204 for the new kernel: the wrapper
    takes exactly its plain version's parameters."""
    import inspect
    assert (list(inspect.signature(tsa.serve_attention).parameters)
            == list(inspect.signature(tref.serve_attention_ref).parameters))
