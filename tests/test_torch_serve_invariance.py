"""The serving path's row invariance at reduced size on the CPU.

- A plain-PyTorch mirror of ``serve_attention``'s second design
  (``csrc/serve_attention.cu``): the logical ring cut into fixed spans,
  each span's online softmax over tiles (the tile's sum a fixed xor
  butterfly, a row's sums set to 0 at its first visible slot, a term of
  weight exactly 0 skipped), the spans folded in span order with a span
  that saw no visible slot weighed 0. It holds chunk rows == the rows at
  c = 1 and paged == dense bitwise (a null block holding NaN among
  them), and, put in the kernel's place, the port's attention entry
  points against JAX's ``attention_decode`` / ``attention_prefill`` (and
  the paged pair) within ``tests/test_torch_serve_attention.py``'s
  tolerances.
- ``invariant_dense`` and ``invariant_rmsnorm`` on the CPU are bitwise
  ``layers.dense`` and ``layers.rmsnorm``, ``invariant_add_rmsnorm``
  bitwise ``(x + h, layers.rmsnorm(x + h))``; the dense family's serving
  steps route every projection (7 a layer and lm_head) and every RMSNorm
  (2 a layer and the final norm: the first norm-only, the others with
  the residual add before them) through them, a training forward and
  rwkv6's serving none, and give bitwise the logits and caches of the
  unfused composition (the add, then the norm); their wrappers refuse
  what the kernels do not take; the split of K is a function of (K, N)
  alone.
- ``invariant_dense_group`` on the CPU is ``layers.dense`` of each of its
  problems bitwise (and JAX's within tolerance), the serving MLP
  (``layers.mlp_serve``) is ``layers.mlp`` bitwise; the group refuses
  problems that disagree on K or dtype; the kernel's form is M's alone
  at the boundary (decode up to 64 rows) and never changes the split.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import reduced as jreduced
from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs.base import reduced as treduced
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import invariant_dense as tid
from repro_torch.kernels import invariant_rmsnorm as tin
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.api import build_model as tbuild
from repro_torch.utils.tree import (leaves, params_from_numpy,
                                    params_to_numpy, tree_map)

F32_TOL = dict(rtol=1e-4, atol=1e-5)      # test_torch_serve_attention.py
BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)
NEG = -1e30


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: this module's many small ops crawl when the
    test workers' thread pools share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the split-ring mirror --

def _butterfly(x):
    """The kernel's warp sum over a tile: lane l adds lane l ^ o for o =
    T/2 .. 1 (every lane ends with the same bits)."""
    idx = torch.arange(x.shape[-1])
    o = x.shape[-1] // 2
    while o:
        x = x + x[..., idx ^ o]
        o //= 2
    return x[..., 0]


def split_ring(q, k, v, positions, cache_k, cache_v, cache_pos, table=None,
               ring_len=None, *, window=0, span=16, tile=4):
    """``ref.serve_attention_ref``'s function in the order of the kernel's
    second design, spans of ``span`` slots in tiles of ``tile``. Every
    transcendental runs on a tensor of one fixed shape (a tile, or a 0-d
    scalar) so its bits cannot depend on how many rows are computed."""
    B, c, H, hd = q.shape
    KH = k.shape[2]
    n_rep = H // KH
    nb, bs = cache_pos.shape
    if table is None:
        blk = torch.arange(B)[:, None]
        ring = torch.full((B,), bs, dtype=torch.int32)
        mapped = torch.ones(B, 1, dtype=torch.bool)
    else:
        blk, ring, mapped = table.long().clamp(0, nb - 1), ring_len, table > 0
    n = blk.shape[1] * bs
    old_k = cache_k[blk].reshape(B, n, KH, hd).float()
    old_v = cache_v[blk].reshape(B, n, KH, hd).float()
    old_p = torch.where(mapped.repeat_interleave(bs, 1),
                        cache_pos[blk].reshape(B, n).long(), -1)
    src = tref.serve_chunk_sources(positions, ring, table, n, bs)
    pos = positions.long()
    out = torch.empty(B, c, H, hd, dtype=torch.float32)
    for b in range(B):
        for h in range(H):
            kh = h // n_rep
            for i in range(c):
                qi, pi = q[b, i, h].float(), int(pos[b, i])
                parts = []
                for s0 in range(0, n, span):
                    m = torch.tensor(NEG)
                    l = torch.tensor(0.0)
                    acc = torch.zeros(hd)
                    for t0 in range(s0, min(s0 + span, n), tile):
                        sl = torch.arange(t0, t0 + tile)
                        exists = sl < min(s0 + span, n)
                        sl = sl.clamp(max=n - 1)
                        j = src[b, sl]
                        fresh = exists & (j <= i)
                        jj = j.clamp(max=c - 1)
                        key = torch.where(fresh[:, None], k[b, jj, kh].float(),
                                          old_k[b, sl, kh])
                        val = torch.where(fresh[:, None], v[b, jj, kh].float(),
                                          old_v[b, sl, kh])
                        p = torch.where(fresh, pos[b, jj], old_p[b, sl])
                        dot = torch.cumsum(qi * key, -1)[:, -1]
                        ok = (p >= 0) & (p <= pi)
                        if window:
                            ok &= p > pi - window
                        sc = torch.where(exists, torch.where(ok, dot, NEG),
                                         -torch.inf)
                        m_new = torch.maximum(m, sc.max())
                        corr = torch.exp(m - m_new)
                        pr = torch.exp(sc - m_new)
                        l = l * corr + _butterfly(pr)
                        acc = torch.zeros(hd) if corr == 0 else acc * corr
                        for t in range(tile):
                            if bool(exists[t]) and pr[t] != 0:
                                acc = acc + pr[t] * val[t]
                        m = m_new
                    parts.append((m, l, acc))
                M = max(p[0] for p in parts)
                L, A = torch.tensor(0.0), torch.zeros(hd)
                for m_s, l_s, a_s in parts:       # spans in slot order
                    w = torch.exp(m_s - M)
                    if w != 0:
                        L, A = L + w * l_s, A + w * a_s
                out[b, i, h] = A / L
    return out.to(q.dtype)


def _serve_state(dtype, B, c, window, H, KH, hd, L, bs, seed, nan_null=False):
    """A cache before a chunk (each slot the latest position below the
    chunk's first, of its residue; under window 0 only the first few
    slots written, so later spans are empty), the chunk (the last batch
    row's last two rows pad when c > 2), and the same cache as a pool
    under a shuffled table (window 0: each row's last block unmapped; the
    null block holds NaN when ``nan_null``)."""
    g = torch.Generator().manual_seed(seed)
    p0 = torch.tensor([(L + 9 if window else 3) + 5 * b for b in range(B)])
    s = torch.arange(L)
    cpos = p0[:, None] - 1 - torch.remainder(p0[:, None] - 1 - s, L)
    cpos = torch.where(cpos >= 0, cpos, -1).to(torch.int32)
    rnd = lambda *sh: torch.randn(*sh, generator=g).to(dtype)
    ck, cv = rnd(B, L, KH, hd), rnd(B, L, KH, hd)
    q = (torch.randn(B, c, H, hd, generator=g) * hd ** -0.5).to(dtype)
    kn, vn = rnd(B, c, KH, hd), rnd(B, c, KH, hd)
    pos = (p0[:, None] + torch.arange(c)).to(torch.int32)
    if c > 2:
        pos[-1, -2:] = tref.PAD_POS
    mb = L // bs
    table = (torch.randperm(B * mb, generator=g) + 1).reshape(B, mb).to(
        torch.int32)
    if not window:
        table[:, -1] = 0
    nb = 1 + B * mb
    pk, pv = rnd(nb, bs, KH, hd), rnd(nb, bs, KH, hd)
    ppos = torch.full((nb, bs), 3, dtype=torch.int32)
    keep = table.flatten() > 0
    idx = table.flatten()[keep].long()
    pk[idx] = ck.reshape(B * mb, bs, KH, hd)[keep]
    pv[idx] = cv.reshape(B * mb, bs, KH, hd)[keep]
    ppos[idx] = cpos.reshape(B * mb, bs)[keep]
    if nan_null:
        pk[0], pv[0] = float("nan"), float("nan")
    ring = torch.full((B,), L, dtype=torch.int32)
    return (q, kn, vn, pos), (ck, cv, cpos), (pk, pv, ppos, table, ring)


def _row_at_c1(chunk, dense, i, window):
    """Row i alone (c = 1) against the dense cache holding the chunk's
    real rows before it, as the per-token loop holds them."""
    q, k, v, pos = chunk
    ck, cv, cpos = (x.clone() for x in dense)
    B, L = cpos.shape
    for j in range(i):
        for b in range(B):
            if pos[b, j] < tref.PAD_FLOOR:
                slot = int(pos[b, 0] + j) % L
                ck[b, slot], cv[b, slot] = k[b, j], v[b, j]
                cpos[b, slot] = pos[b, j]
    row = lambda x: x[:, i:i + 1].contiguous()
    return split_ring(row(q), row(k), row(v), row(pos), ck, cv, cpos,
                      window=window)[:, 0]


#: (dtype, B, c, window, H, KH, hd, ring, block size): rings of 2-3 spans
#: of 16 slots, a wrapped ring under a window (spans outside it fully
#: masked), a linear cache whose later spans are empty, decode and chunks
SPLIT_CASES = [("float32", 2, 5, 12, 4, 2, 8, 40, 4),
               ("float32", 2, 1, 12, 4, 2, 8, 40, 4),
               ("float32", 2, 6, 0, 4, 2, 8, 48, 8),
               ("bfloat16", 1, 4, 0, 2, 1, 8, 32, 4)]


@pytest.mark.parametrize("dt,B,c,window,H,KH,hd,L,bs", SPLIT_CASES)
def test_split_ring_rows_and_paged_bitwise(dt, B, c, window, H, KH, hd, L,
                                           bs):
    """The split-ring order: every row of a chunk bitwise that row at
    c = 1, the paged pool (its null block NaN) bitwise the dense cache,
    and the plain version's function within f32 rounding."""
    dtype = getattr(torch, dt)
    chunk, dense, paged = _serve_state(dtype, B, c, window, H, KH, hd, L, bs,
                                       seed=L + c, nan_null=True)
    got = split_ring(*chunk, *dense, window=window)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, split_ring(*chunk, *paged, window=window))
    for i in range(c):
        assert torch.equal(got[:, i], _row_at_c1(chunk, dense, i, window)), i
    f32 = [x.float() if x.is_floating_point() else x
           for x in (*chunk, *dense)]
    want = tref.serve_attention_ref(*f32, window=window)
    torch.testing.assert_close(got.float(), want, rtol=2e-5, atol=2e-6) \
        if dtype == torch.float32 else torch.testing.assert_close(
            got.float(), want, **BF16_TOL)


def test_split_ring_fully_masked_row_is_the_plain_mean():
    """A pad row under a window sees no slot: like the plain version it
    gets the mean of every slot's v, folded over the spans."""
    chunk, dense, _ = _serve_state(torch.float32, 2, 5, 12, 4, 2, 8, 40, 4,
                                   seed=1)
    got = split_ring(*chunk, *dense, window=12)
    want = tref.serve_attention_ref(*chunk, *dense, window=12)
    assert chunk[3][-1, -1] >= tref.PAD_FLOOR
    torch.testing.assert_close(got[-1, -1], want[-1, -1], rtol=2e-5,
                               atol=2e-6)


def _cfgs(dtype, window):
    j = jreduced(JARCHS["minitron-8b"], dtype=dtype)
    t = treduced(TARCHS["minitron-8b"], dtype=dtype)
    if window:
        j, t = j.with_(sliding_window=window), t.with_(sliding_window=window)
    return j, t


def _np(x, dtype):
    return np.array(jnp.asarray(x, jnp.float32).astype(dtype))


@pytest.mark.parametrize("entry", ["decode", "prefill", "decode_paged",
                                   "prefill_paged"])
@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ring_in_the_entry_points_matches_jax(entry, window, dtype,
                                                    monkeypatch):
    """The mirror put where the kernel runs (``models/attention.py``'s
    ``serve_attention``): the port's attention entry points against
    JAX's, over a ring of three 16-slot spans (window 12: the ring wraps;
    window 0: a linear cache, its last block unmapped when paged), pad
    rows in the chunk, GQA n_rep 2."""
    monkeypatch.setattr(tattn, "serve_attention", split_ring)
    jcfg, tcfg = _cfgs(dtype, window)
    H, KH, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.resolved_head_dim
    B, L, bs = 2, 40 if window else 48, 8
    c = 1 if entry.startswith("decode") else 5
    rng = np.random.RandomState(c + window)
    p0 = np.array([L + 3, L + 17]) if window else np.array([3, 9])
    s = np.arange(L)
    pos = p0[:, None] - 1 - np.mod(p0[:, None] - 1 - s, L)
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    k, v = (_np(rng.randn(B, L, KH, hd), dtype) for _ in range(2))
    x = _np(rng.randn(B, c, tcfg.d_model), dtype)
    positions = (p0[:, None] + np.arange(c)).astype(np.int32)
    if c > 2:
        positions[-1, -2:] = tref.PAD_POS
    mb = L // bs
    table = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
    if not window:
        table[:, -1] = 0
    nb = 1 + B * mb
    pk, pv = (_np(rng.randn(nb, bs, KH, hd), dtype) for _ in range(2))
    ppos = np.full((nb, bs), 5, np.int32)
    flat = table.reshape(-1)
    keep = flat > 0
    pk[flat[keep]] = k.reshape(B * mb, bs, KH, hd)[keep]
    pv[flat[keep]] = v.reshape(B * mb, bs, KH, hd)[keep]
    ppos[flat[keep]] = pos.reshape(B * mb, bs)[keep]
    ring = np.full((B,), L, np.int32)
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jtf.init_params(
        jcfg, jax.random.PRNGKey(0))["body"])["attn"]
    tp = params_from_numpy(jp)
    paged = entry.endswith("paged")
    store = ({"k": pk, "v": pv, "pos": ppos} if paged
             else {"k": k, "v": v, "pos": pos})
    jstore = {kk: jnp.asarray(a) for kk, a in store.items()}
    tstore = params_from_numpy(store)
    at = positions[:, 0] if c == 1 else positions
    jfn, tfn = (getattr(jattn, f"attention_{entry}"),
                getattr(tattn, f"attention_{entry}"))
    tx = params_from_numpy({"x": x})["x"]
    if paged:
        jout, _ = jfn(jp, jcfg, jnp.asarray(x), jstore, jnp.asarray(table),
                      jnp.asarray(ring), jnp.asarray(at))
        tout, _ = tfn(tp, tcfg, tx, tstore, torch.from_numpy(table),
                      torch.from_numpy(ring), torch.from_numpy(at))
    else:
        jout, _ = jfn(jp, jcfg, jnp.asarray(x), jstore, jnp.asarray(at))
        tout, _ = tfn(tp, tcfg, tx, tstore, torch.from_numpy(at))
    got = params_to_numpy({"o": tout})["o"].astype(np.float32)
    want = np.asarray(jout, np.float32)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32"
                                             else BF16_TOL))


# ------------------------------------------- the row-invariant kernels --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_invariant_kernels_on_the_cpu_are_layers_bitwise(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=g).to(dtype)
    p = {"w": torch.randn(64, 24, generator=g).to(dtype),
         "b": torch.randn(24, generator=g).to(dtype)}
    assert torch.equal(tid.invariant_dense(x, p["w"], p["b"]),
                       tlayers.dense(p, x))
    assert torch.equal(tlayers.dense_serve({"w": p["w"]}, x),
                       tlayers.dense({"w": p["w"]}, x))
    n = {"g": (1 + 0.1 * torch.randn(64, generator=g)).to(dtype)}
    assert torch.equal(tin.invariant_rmsnorm(x, n["g"]),
                       tlayers.rmsnorm(n, x))
    assert torch.equal(tlayers.rmsnorm_serve(n, x), tlayers.rmsnorm(n, x))


def test_invariant_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 64)
    with pytest.raises(TypeError):
        tid.invariant_dense(x.half(), torch.zeros(64, 8).half())
    with pytest.raises(TypeError):
        tid.invariant_dense(x, torch.zeros(64, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        tid.invariant_dense(x, torch.zeros(32, 8))
    with pytest.raises(ValueError, match="shape"):
        tid.invariant_dense(x, torch.zeros(64, 8), torch.zeros(9))
    with pytest.raises(ValueError, match="contiguous"):
        tid.invariant_dense(torch.zeros(64, 4).t(), torch.zeros(64, 8))
    with pytest.raises(TypeError):
        tin.invariant_rmsnorm(x.to(torch.int32), torch.ones(64))
    with pytest.raises(ValueError, match="shape"):
        tin.invariant_rmsnorm(x, torch.ones(32))
    with pytest.raises(ValueError, match="contiguous"):
        tin.invariant_rmsnorm(torch.zeros(64, 4).t(), torch.ones(64))


@pytest.mark.parametrize("d", [8, 100, 256, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_on_the_cpu_is_the_add_then_layers_rmsnorm(dtype, d):
    """The fused wrapper's plain version: s bitwise ``x + h`` and y
    bitwise ``layers.rmsnorm(x + h)`` (d 100 is not a multiple of the
    16-byte vector: the kernel's per-element form on the card), and y
    bitwise the norm-only form on s."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn(3, 5, d, generator=g).to(dtype)
    h = torch.randn(3, 5, d, generator=g).to(dtype)
    n = {"g": (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)}
    tin.reset_counts()
    s, y = tin.invariant_add_rmsnorm(x, h, n["g"])
    assert s.dtype == y.dtype == dtype and s.shape == y.shape == x.shape
    assert torch.equal(s, x + h)
    assert torch.equal(y, tlayers.rmsnorm(n, x + h))
    assert torch.equal(y, tin.invariant_rmsnorm(s, n["g"]))
    s2, y2 = tlayers.add_rmsnorm_serve(n, x, h)
    assert torch.equal(s2, s) and torch.equal(y2, y)
    x3, y3 = tlayers.add_rmsnorm_serve(n, x, None)
    assert x3 is x and torch.equal(y3, tlayers.rmsnorm(n, x))
    # on the CPU the plain versions run, and no launch is counted
    assert tin.invariant_add_rmsnorm.launches == 0
    assert tin.invariant_rmsnorm.launches == 0


def test_add_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take():
    """Mismatched shapes and dtypes, an unsupported dtype, non-contiguous
    operands: refused before any kernel or plain version runs."""
    x = torch.zeros(4, 64)
    one = torch.ones(64)
    with pytest.raises(ValueError, match="shape"):
        tin.invariant_add_rmsnorm(x, torch.zeros(4, 32), one)
    with pytest.raises(ValueError, match="shape"):
        tin.invariant_add_rmsnorm(x, torch.zeros(2, 64), one)
    with pytest.raises(ValueError, match="shape"):
        tin.invariant_add_rmsnorm(x, x, torch.ones(32))
    with pytest.raises(TypeError):
        tin.invariant_add_rmsnorm(x, x.to(torch.bfloat16), one)
    with pytest.raises(TypeError):
        tin.invariant_add_rmsnorm(x, x, one.to(torch.bfloat16))
    with pytest.raises(TypeError):
        tin.invariant_add_rmsnorm(x.half(), x.half(), one.half())
    with pytest.raises(ValueError, match="contiguous"):
        tin.invariant_add_rmsnorm(torch.zeros(64, 4).t(), x, one)
    with pytest.raises(ValueError, match="contiguous"):
        tin.invariant_add_rmsnorm(x, torch.zeros(64, 4).t(), one)
    with pytest.raises(ValueError, match="contiguous"):
        tin.invariant_add_rmsnorm(x, x, torch.ones(64, 2)[:, 0])
    with pytest.raises(ValueError, match="is on meta"):
        tin.invariant_add_rmsnorm(x, torch.zeros(4, 64, device="meta"), one)


def test_split_of_k_is_a_function_of_k_and_n_alone():
    """split_k at minitron-8b's projections (the n tiles of 128 filling 64
    blocks, ranges of 512 or more, at most 8 ranges) and its
    signature."""
    import inspect
    assert list(inspect.signature(tid.split_k).parameters) == ["K", "N"]
    got = {name: tid.split_k(K, N) for name, (K, N) in {
        "wq": (4096, 4096), "wk": (4096, 1024), "w_in": (4096, 16384),
        "w_out": (16384, 4096), "lm_head": (4096, 256000),
        "reduced": (256, 512)}.items()}
    assert got == {"wq": 2, "wk": 8, "w_in": 1, "w_out": 2, "lm_head": 1,
                   "reduced": 1}
    # at most SPLIT_MAX ranges (a tile's ranges fold in one cluster)
    assert tid.split_k(65536, 128) == tid.SPLIT_MAX == 8


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_invariant_dense_group_on_the_cpu_is_layers_dense_of_each(dtype,
                                                                  bias):
    """The grouped wrapper on the CPU: each output is ``layers.dense`` of
    its problem bitwise (wq|wk|wv-like widths), and JAX's ``dense`` on the
    same numpy draws within the serving tests' tolerances."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ps = [{"w": rng.standard_normal((64, n)).astype(np.float32) / 8}
          for n in (48, 16, 16)]
    if bias:
        for q in ps:
            q["b"] = rng.standard_normal(q["w"].shape[1]).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tps = [{k: torch.from_numpy(v).to(dtype) for k, v in q.items()}
           for q in ps]
    got = tid.invariant_dense_group(tx, [(q["w"], q.get("b")) for q in tps])
    assert [tuple(y.shape) for y in got] == [(2, 5, 48), (2, 5, 16),
                                             (2, 5, 16)]
    grp = tlayers.dense_serve_group(tps, tx)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for y, yg, q, tq in zip(got, grp, ps, tps):
        assert y.dtype == dtype
        assert torch.equal(y, tlayers.dense(tq, tx))
        assert torch.equal(yg, y)
        want = jlayers.dense({k: jnp.asarray(v, jdt) for k, v in q.items()},
                             jnp.asarray(x, jdt))
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **(F32_TOL if dtype == torch.float32
                                      else BF16_TOL))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_mlp_is_the_training_mlp_bitwise_on_the_cpu(dtype, gated):
    """``mlp_serve`` (w_in|w_gate grouped) gives ``mlp``'s bits on the
    CPU, SwiGLU and GELU, and JAX's ``mlp`` within tolerance."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    p = {"w_in": {"w": rng.standard_normal((32, 64)).astype(np.float32) / 6},
         "w_out": {"w": rng.standard_normal((64, 32)).astype(np.float32) / 8}}
    if gated:
        p["w_gate"] = {"w": rng.standard_normal((32, 64)).astype(np.float32)
                       / 6}
    tp = params_from_numpy(p)
    tp = {k: {"w": v["w"].to(dtype)} for k, v in tp.items()}
    tx = torch.from_numpy(x).to(dtype)
    got = tlayers.mlp_serve(tp, tx)
    assert torch.equal(got, tlayers.mlp(tp, tx))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers.mlp({k: {"w": jnp.asarray(v["w"], jdt)}
                        for k, v in p.items()}, jnp.asarray(x, jdt))
    tol = F32_TOL if dtype == torch.float32 else dict(rtol=2 ** -5,
                                                     atol=2 ** -5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_invariant_dense_group_refuses_what_one_launch_cannot_take():
    """Problems that disagree on K (with x) or on the dtype, an empty or
    too large group: refused before any kernel or plain version runs."""
    x = torch.zeros(4, 64)
    w = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="shape"):
        tid.invariant_dense_group(x, [(w, None), (torch.zeros(32, 8), None)])
    with pytest.raises(TypeError):
        tid.invariant_dense_group(x, [(w, None), (w.to(torch.bfloat16),
                                                  None)])
    with pytest.raises(TypeError):
        tid.invariant_dense_group(x, [(w, None), (w, torch.zeros(
            8, dtype=torch.bfloat16))])
    with pytest.raises(ValueError, match="projections a launch"):
        tid.invariant_dense_group(x, [])
    with pytest.raises(ValueError, match="projections a launch"):
        tid.invariant_dense_group(x, [(w, None)] * (tid.MAX_GROUP + 1))


def test_the_form_is_a_function_of_m_that_never_moves_the_split():
    """The bf16 kernel's form: decode (one 64-row tile a block) up to
    DECODE_ROWS rows, a prefill form above; the prefill form with 256-row
    blocks where no problem splits K and they fill 7/8 of the card, else
    128-row ones; the split in the launch plan is ``split_k``'s at every
    M."""
    import inspect
    assert list(inspect.signature(tid.form).parameters) == ["M", "K", "Ns",
                                                           "sms"]
    for M in (1, 4, 64):
        assert tid.form(M, 4096, (4096,), 132) == 0
    assert tid.form(65, 4096, (16384,), 132) == 2       # 128 blocks
    assert tid.form(256, 4096, (16384, 16384), 132) == 2
    assert tid.form(256, 4096, (16384,), 256) == 1      # 128 of 256 SMs
    assert tid.form(256, 4096, (256000,), 132) == 2
    for Ns in ((1024,), (4096,), (4096, 1024, 1024)):  # K split
        assert tid.form(256, 4096, Ns, 132) == 1
        assert tid.form(257, 4096, Ns, 132) == 1
    for M in (1, 4, 64, 65, 128, 129, 256, 260):
        fm, splits = tid._plan(M, 4096, (4096, 1024), True, 132)
        assert fm == tid.form(M, 4096, (4096, 1024), 132)
        assert splits == (tid.split_k(4096, 4096), tid.split_k(4096, 1024))
    assert tid._plan(5, 64, (8, 16), False, 132) == (0, (1, 1))


class _Count:
    """Counts the plain versions' calls (the wrappers reach them by module
    attribute on the CPU)."""

    def __init__(self, monkeypatch):
        self.n = {"invariant_dense_ref": 0, "invariant_rmsnorm_ref": 0,
                  "invariant_add_rmsnorm_ref": 0}
        for name in self.n:
            real = getattr(tref, name)

            def counted(*a, _n=name, _real=real, **kw):
                self.n[_n] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(tref, name, counted)

    def take(self):
        out = dict(self.n)
        for k in self.n:
            self.n[k] = 0
        return out


def test_serving_steps_route_every_projection_and_norm(monkeypatch):
    """decode_step, prefill and the paged pair of reduced minitron-8b: 7 x
    layers + 1 invariant_dense calls, 2 x layers invariant_add_rmsnorm
    calls (each norm but the first takes the residual add before it) and
    1 invariant_rmsnorm call (the first block's norm of the embedding) a
    step; a training forward and loss none; rwkv6-3b's per-token decode
    none."""
    count = _Count(monkeypatch)
    cfg = treduced(TARCHS["minitron-8b"], dtype="float32").with_(
        sliding_window=8)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    L = cfg.num_layers
    want = {"invariant_dense_ref": 7 * L + 1, "invariant_rmsnorm_ref": 1,
            "invariant_add_rmsnorm_ref": 2 * L}
    B, bs, mb = 2, 4, 2
    tok = torch.tensor([3, 5], dtype=torch.int32)
    at = torch.tensor([0, 0], dtype=torch.int32)
    with torch.no_grad():
        cache = model.init_decode_cache(params, B, 8)
        model.decode_step(params, tok, at, cache)
        assert count.take() == want
        toks = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
        poss = torch.tensor([[1, 2, 3], [1, 2, 3]], dtype=torch.int32)
        model.prefill(params, toks, poss, cache)
        assert count.take() == want
        pool = model.init_paged_pool(1 + B * mb, bs)
        table = torch.arange(1, 1 + B * mb, dtype=torch.int32).reshape(B, mb)
        ring = torch.full((B,), bs * mb, dtype=torch.int32)
        model.prefill_paged(params, toks, poss - 1, pool, table, ring)
        assert count.take() == want
        model.decode_step_paged(params, tok, at + 3, pool, table, ring)
        assert count.take() == want
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 16),
                                         generator=torch.Generator()
                                         .manual_seed(1))}
        ttf.loss_fn(params, cfg, batch)
        ttf.forward(params, cfg, batch)
        assert count.take() == {k: 0 for k in want}
        rcfg = treduced(TARCHS["rwkv6-3b"], dtype="float32")
        rmodel = tbuild(rcfg)
        rparams = rmodel.init(torch.Generator().manual_seed(0),
                              torch.device("cpu"))
        rcache = rmodel.init_decode_cache(rparams, B, 8)
        rmodel.decode_step(rparams, tok, at, rcache)
        assert count.take() == {k: 0 for k in want}


def _unfused(params, tokens, attend):
    """A dense serving step composed as before the residual add moved into
    the norm's launch: ``x = x + h`` after attention and after the MLP,
    each norm on its own (``rmsnorm_serve``). ``attend(p, group, i, n)``
    is layer i's attention on its normed input n."""
    x = tlayers.embedding(params["embed"], tokens)
    for grp in ("body", "tail"):
        if params[grp] is None:
            continue
        for i in range(leaves(params[grp])[0].shape[0]):
            p = tree_map(lambda a, i=i: a[i], params[grp])
            x = x + attend(p, grp, i, tlayers.rmsnorm_serve(p["ln1"], x))
            x = x + tlayers.mlp_serve(p["mlp"],
                                      tlayers.rmsnorm_serve(p["ln2"], x))
    return tlayers.dense_serve(params["lm_head"], tlayers.rmsnorm_serve(
        params["final_norm"], x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_paths_equal_the_unfused_composition_bitwise(dtype):
    """Reduced minitron-8b (3 layers: 2 body, 1 tail, so the residual
    crosses the group boundary; window 8): a chunked prefill, then two
    decode steps, over the dense cache and the paged pool, give bitwise
    the logits and the caches of the unfused composition."""
    cfg = treduced(TARCHS["minitron-8b"], dtype=dtype).with_(
        num_layers=3, sliding_window=8)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(2),
                        torch.device("cpu"))
    B, bs, mb = 2, 4, 2
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
    poss = torch.tensor([[0, 1, 2], [0, 1, 2]], dtype=torch.int32)
    steps = [(torch.tensor([9, 10], dtype=torch.int32),
              torch.tensor([3, 3], dtype=torch.int32)),
             (torch.tensor([11, 12], dtype=torch.int32),
              torch.tensor([4, 4], dtype=torch.int32))]
    table = torch.arange(1, 1 + B * mb, dtype=torch.int32).reshape(B, mb)
    ring = torch.full((B,), bs * mb, dtype=torch.int32)

    def layer(tree, grp, i):
        return {k: a[i] for k, a in tree[grp].items()}

    def flat(tree):
        return [a for grp in ("body", "tail") for a in tree[grp].values()]

    with torch.no_grad():
        ca = model.init_decode_cache(params, B, 8)
        cb = model.init_decode_cache(params, B, 8)
        got, _ = model.prefill(params, toks, poss, ca)
        want = _unfused(params, toks, lambda p, grp, i, n: tattn.
                        attention_prefill(p["attn"], cfg, n,
                                          layer(cb, grp, i), poss)[0])
        assert torch.equal(got, want)
        for tok, at in steps:
            got, _ = model.decode_step(params, tok, at, ca)
            want = _unfused(params, tok[:, None], lambda p, grp, i, n: tattn.
                            attention_decode(p["attn"], cfg, n,
                                             layer(cb, grp, i), at)[0])[:, 0]
            assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(flat(ca), flat(cb),
                                                     strict=True))
        pa = model.init_paged_pool(1 + B * mb, bs)
        pb = model.init_paged_pool(1 + B * mb, bs)
        got, _ = model.prefill_paged(params, toks, poss, pa, table, ring)
        want = _unfused(params, toks, lambda p, grp, i, n: tattn.
                        attention_prefill_paged(p["attn"], cfg, n,
                                                layer(pb, grp, i), table,
                                                ring, poss)[0])
        assert torch.equal(got, want)
        for tok, at in steps:
            got, _ = model.decode_step_paged(params, tok, at, pa, table,
                                             ring)
            want = _unfused(params, tok[:, None], lambda p, grp, i, n: tattn.
                            attention_decode_paged(p["attn"], cfg, n,
                                                   layer(pb, grp, i), table,
                                                   ring, at)[0])[:, 0]
            assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(flat(pa), flat(pb),
                                                     strict=True))
