"""The designs of two server kernels, held on the CPU.

``ama_mix``: the multi-leaf entry ``ama_mix_leaves`` and its plain
version ``ama_mix_leaves_math`` against per-leaf ``ama_mix_math`` and
against the JAX package's ``ama_mix_tree`` (Pallas, interpret mode); the
host-side leaf table (``leaf_launches``) that the CUDA kernel
(``csrc/ama_mix.cu``) reads: every element of every leaf covered once by
the kernel's block-to-leaf map, groups by dtype pair, splits beyond
``MAX_LEAVES`` in leaf order, and the 16-byte flag only where N and the
pointers allow.

``server_async``: a plain mirror of the loop order of its 16-byte kernel
(``csrc/server_plane.cu: server_async_vec_kernel``: the block prologue's
slot sums, then each thread's client values held while the ring slots
are walked in batches) against ``server_async_math``, bit for bit, over
three wraps of the ring, with a popped slot that holds -0.0 and a NaN
client value. The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import ama_mix as tam
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import server_plane as tsp

#: the paper CNN's 8 leaves in tree order, and a leaf of one element
LEAVES = (250, 5000, 120, 38400, 84, 10080, 10, 840, 1)
F32, BF16 = torch.float32, torch.bfloat16
CSRC = Path(tam.__file__).parent / "csrc"


def _bits(x):
    """x's bits as integers: equality of these is bit-for-bit equality
    (-0.0 differs from +0.0, a NaN equals the same NaN)."""
    return x.view(torch.int32 if x.dtype == F32 else torch.int16)


def _leaves(rng, sizes, pdt, sdt, K, offset=()):
    """prevs and stackeds made from numpy; the leaves in ``offset`` start
    one element past an allocation's (aligned) base."""
    prevs, stackeds = [], []
    for j, n in enumerate(sizes):
        o = int(j in offset)
        prevs.append(torch.from_numpy(rng.randn(n + o).astype(np.float32))
                     .to(pdt, copy=True)[o:])
        stackeds.append(torch.from_numpy(
            rng.randn(K * n + o).astype(np.float32)).to(sdt, copy=True)[o:]
            .view(K, n))
    return prevs, stackeds


# ------------------------------------------------------------ ama_mix ----

@pytest.mark.parametrize("pdt,sdt", [(F32, F32), (BF16, BF16), (BF16, F32)],
                         ids=["f32", "bf16", "bf16_prev_f32_rows"])
@pytest.mark.parametrize("K", [1, 2])
def test_ama_mix_leaves_math_equals_per_leaf(pdt, sdt, K):
    rng = np.random.RandomState(K)
    prevs, stackeds = _leaves(rng, LEAVES, pdt, sdt, K)
    alpha = torch.tensor([rng.rand()], dtype=F32)
    w = torch.from_numpy(rng.rand(K).astype(np.float32))
    want = [tref.ama_mix_math(p, s, alpha, w)
            for p, s in zip(prevs, stackeds)]
    tsp.reset_counts()
    for got in (tref.ama_mix_leaves_math(prevs, stackeds, alpha, w),
                tam.ama_mix_leaves(prevs, stackeds, alpha, w)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == pdt and torch.equal(_bits(a), _bits(b))
    assert tam.ama_mix_leaves.launches == 0       # CPU: the plain version
    assert tsp.KERNELS["ama_mix"] is tam.ama_mix_leaves


@pytest.mark.parametrize("K", [1, 2])
def test_ama_mix_tree_matches_jax_over_many_leaves(K):
    """The port's ama_mix_tree (one ama_mix_leaves call) against the JAX
    ama_mix_tree (one Pallas call a leaf, interpret mode) over a tree of
    f32 and bf16 leaves, at the legacy chain's tolerance
    (tests/test_torch_legacy.py: KTOL)."""
    rng = np.random.RandomState(10 + K)
    shapes = {"c1": (5, 5), "c2": (25, 8), "b1": (12,), "fc": (84, 10),
              "b2": (10,), "one": (1,)}
    bf = {"c2", "b2"}
    prev = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    stacked = {k: rng.randn(K, *s).astype(np.float32)
               for k, s in shapes.items()}
    alpha, wts = np.float32(0.35), rng.rand(K).astype(np.float32)

    def jx(x, k):
        return jnp.asarray(x, jnp.bfloat16 if k in bf else jnp.float32)

    def tt(x, k):
        return torch.from_numpy(x).to(BF16 if k in bf else F32)

    jt = jops.ama_mix_tree({k: jx(v, k) for k, v in prev.items()},
                           {k: jx(v, k) for k, v in stacked.items()},
                           jnp.float32(alpha), jnp.asarray(wts),
                           interpret=True)
    got = tops.ama_mix_tree({k: tt(v, k) for k, v in prev.items()},
                            {k: tt(v, k) for k, v in stacked.items()},
                            torch.tensor(alpha), torch.from_numpy(wts))
    for k in shapes:
        tol = (dict(rtol=2 ** -7, atol=2 ** -7) if k in bf
               else dict(rtol=2e-6, atol=2e-6))
        assert tuple(got[k].shape) == shapes[k]
        np.testing.assert_allclose(
            got[k].float().numpy(),
            np.asarray(jnp.asarray(jt[k], jnp.float32)), err_msg=k, **tol)


def _block_map(launch, prevs, b):
    """The kernel's block-to-leaf map (csrc/ama_mix.cu): block b mixes
    leaf j, the last with first_block[j] <= b, at units (b - first) *
    THREADS + thread, then every nb * THREADS units beyond (nb: the
    leaf's blocks); returns (leaf index, the elements it covers)."""
    fb = launch.first_block
    lo, hi = 0, len(launch.leaves) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fb[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    j = launch.leaves[lo]
    n = prevs[j].numel()
    E = (tam.unit_elems(launch.prev_dtype, launch.stacked_dtype)
         if launch.vec[lo] else 1)
    stride = (fb[lo + 1] - fb[lo]) * tam.THREADS
    u0 = (b - fb[lo]) * tam.THREADS + np.arange(tam.THREADS)
    u = (u0[None] + stride * np.arange(-(-(n // E) // stride) + 1)[:, None])
    u = u[u < n // E]
    return j, (u[:, None] * E + np.arange(E)[None]).ravel()


@pytest.mark.parametrize("pdt,sdt", [(F32, F32), (BF16, BF16), (BF16, F32)],
                         ids=["f32", "bf16", "bf16_prev_f32_rows"])
def test_leaf_table_covers_every_element_once(pdt, sdt, monkeypatch):
    # 5 blocks at most a leaf, so that the larger leaves take the
    # grid-stride loop
    monkeypatch.setattr(tam, "LEAF_BLOCKS", 5)
    rng = np.random.RandomState(3)
    sizes = LEAVES + (4096, 4097, 257, 0)
    prevs, stackeds = _leaves(rng, sizes, pdt, sdt, 2, offset=(9,))
    outs = [torch.empty_like(p) for p in prevs]
    (launch,) = tam.leaf_launches(prevs, stackeds, outs)
    assert launch.leaves == tuple(range(len(sizes) - 1))  # the empty one out
    hits = [np.zeros(n, np.int64) for n in sizes]
    for b in range(launch.first_block[-1]):
        j, els = _block_map(launch, prevs, b)
        np.add.at(hits[j], els, 1)
    for j, h in enumerate(hits):
        assert (h == 1).all(), (sizes[j], int(h.min()), int(h.max()))


def test_leaf_table_marks_vectors_where_n_and_pointers_allow():
    rng = np.random.RandomState(4)
    sizes = (250, 5000, 120, 84, 10, 8, 16, 16)
    # f32: a unit of 4 elements; bf16 (either operand): 8
    for pdt, sdt, want in (
            (F32, F32, (False, True, True, True, False, True, True, False)),
            (BF16, BF16, (False, True, True, False, False, True, True,
                          False)),
            (F32, BF16, (False, True, True, False, False, True, True,
                         False)),
            (BF16, F32, (False, True, True, False, False, True, True,
                         False))):
        # the last leaf starts one element past an aligned base
        prevs, stackeds = _leaves(rng, sizes, pdt, sdt, 1, offset=(7,))
        outs = [torch.empty_like(p) for p in prevs]
        (launch,) = tam.leaf_launches(prevs, stackeds, outs)
        assert launch.vec == want, (pdt, sdt)
        # an unaligned out alone takes the leaf off the vector path
        outs[1] = torch.empty(5001, dtype=pdt)[1:]
        (launch,) = tam.leaf_launches(prevs, stackeds, outs)
        assert not launch.vec[1]
        units = [n // tam.unit_elems(pdt, sdt) if v else n
                 for n, v in zip(sizes, launch.vec)]
        assert np.diff(launch.first_block).tolist() == [
            min(-(-u // tam.THREADS), tam.LEAF_BLOCKS) for u in units]


def test_leaf_table_groups_by_dtype_pair_and_splits_in_leaf_order():
    rng = np.random.RandomState(5)
    n = 150
    pdts = [F32 if j % 3 else BF16 for j in range(n)]
    sdts = [F32 if j % 2 else d for j, d in enumerate(pdts)]
    prevs, stackeds = [], []
    for j in range(n):
        p, s = _leaves(rng, (3 + j,), pdts[j], sdts[j], 2)
        prevs += p
        stackeds += s
    outs = [torch.empty_like(p) for p in prevs]
    launches = tam.leaf_launches(prevs, stackeds, outs)
    order = []                              # pairs by first appearance
    for pd, sd in zip(pdts, sdts):
        if (pd, sd) not in order:
            order.append((pd, sd))
    want = []
    for pair in order:
        idxs = [j for j in range(n) if (pdts[j], sdts[j]) == pair]
        want += [(pair, tuple(idxs[c:c + tam.MAX_LEAVES]))
                 for c in range(0, len(idxs), tam.MAX_LEAVES)]
    got = [((la.prev_dtype, la.stacked_dtype), la.leaves) for la in launches]
    assert got == want
    assert max(len(la.leaves) for la in launches) == tam.MAX_LEAVES
    # every leaf in exactly one launch; outputs as the plain version's
    assert sorted(j for la in launches for j in la.leaves) == list(range(n))
    alpha, w = torch.tensor([0.4]), torch.tensor([0.3, 0.2])
    for a, b in zip(tam.ama_mix_leaves(prevs, stackeds, alpha, w),
                    tref.ama_mix_leaves_math(prevs, stackeds, alpha, w)):
        assert torch.equal(_bits(a), _bits(b))


def test_leaf_table_matches_the_cuda_struct():
    """``_LeafTable`` is the CUDA ``LeafTable`` field for field, the table
    size and the block width are the kernel's, and the table stays under
    the 4 KB of a launch's parameters."""
    src = (CSRC / "ama_mix.cu").read_text()
    body = re.search(r"struct LeafTable \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(\w+)(?:\[[^\]]*\])?;", body)
    assert fields == [f for f, _ in tam._LeafTable._fields_]
    assert f"kMaxLeaves = {tam.MAX_LEAVES};" in src
    common = (CSRC / "common.cuh").read_text()
    assert f"kThreads = {tam.THREADS};" in common
    assert "kMaxBlocks = 132 * 16;" in common
    assert tam.LEAF_BLOCKS == 132 * 16
    assert ctypes.sizeof(tam._LeafTable) + 32 <= 4096


def test_ama_mix_wrappers_refuse_malformed_leaves():
    z = torch.zeros
    a, w = z(1), z(2)
    with pytest.raises(ValueError):             # a stacked operand short
        tam.ama_mix_leaves([z(4), z(5)], [z(2, 4)], a, w)
    with pytest.raises(ValueError):             # K differs across leaves
        tam.ama_mix_leaves([z(4), z(5)], [z(2, 4), z(3, 5)], a, w)
    with pytest.raises(TypeError):
        tam.ama_mix_leaves([z(4)], [z(2, 4, dtype=torch.float64)], a, w)
    with pytest.raises(ValueError):
        tam.ama_mix_leaves([], [], a, w)


# ------------------------------------------------------- server_async ----

def _async_vector_mirror(prev, stacked, qsum, qgamma, sizes, delayed,
                         delays, tq, hyp, *, slot_batch=4,
                         skip_zero_terms=False):
    """server_async in the loop order of its 16-byte kernel, on plain
    tensors: the prologue forms each slot's gamma sum over k (k
    ascending) on its own, then folds the pop terms from q = 0; each
    element's K client values are held while the slots are walked
    ``slot_batch`` at a time, every one-hot term multiplied and added.
    ``skip_zero_terms`` leaves out the zero one-hot terms instead (what
    the kernel must not do)."""
    K, Q = stacked.shape[0], qgamma.shape[0]
    t, pop = tq[0], int(tq[1])
    g = hyp[3] * torch.sigmoid(-delays.float()) * delayed.float()
    arrival = torch.remainder(t + delays, Q)
    onehot = [[(float(arrival[k]) == q) * g[k] for q in range(Q)]
              for k in range(K)]
    sel = [torch.tensor(float(q == pop)) for q in range(Q)]
    term, new_qgamma = [], []
    for q in range(Q):                              # one thread a slot
        s = onehot[0][q]
        for k in range(1, K):
            s = s + onehot[k][q]
        qg = qgamma[q] + s
        new_qgamma.append(qg * (1.0 - sel[q]))
        term.append(qg * sel[q])
    stale_gamma = term[0]                           # thread 0
    for q in range(1, Q):
        stale_gamma = stale_gamma + term[q]
    A = torch.minimum(hyp[0] + hyp[1] * t.float(), hyp[2])
    beta = 1.0 - A
    denom = tref.ALPHA_UNNORM + stale_gamma
    alpha = torch.full_like(denom, tref.ALPHA_UNNORM) / denom * A
    gscale = A / denom
    w, tot = tref._norm_weights(sizes, 1.0 - delayed.float())
    a_eff = torch.where(tot > 0, alpha, alpha + beta)

    x = [stacked[k].float() for k in range(K)]      # held in registers
    acc = prev.float() * a_eff
    for k in range(K):
        acc = acc + x[k] * (beta * w[k])
    stale, rows = None, [None] * Q
    for q0 in range(0, Q, slot_batch):
        for q in range(q0, min(q0 + slot_batch, Q)):
            r = qsum[q]
            for k in range(K):
                if not (skip_zero_terms and float(onehot[k][q]) == 0.0):
                    r = r + x[k] * onehot[k][q]
            stale = r * sel[q] if q == 0 else stale + r * sel[q]
            rows[q] = r * (1.0 - sel[q])
    acc = acc + stale * gscale
    return acc.to(prev.dtype), torch.stack(rows), torch.stack(new_qgamma)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("K,Q", [(5, 11), (8, 5), (2, 3), (1, 1)])
def test_server_async_vector_loop_order_equals_plain(dt, K, Q):
    rng = np.random.RandomState(K * 100 + Q)
    N = 64
    prev = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dt)
    qsum, qgamma = torch.zeros(Q, N), torch.zeros(Q)
    sizes = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32))
    hyp = torch.tensor([0.1, 2.5e-3, 0.95, 0.6])
    signed_zero_seen = False
    for t in range(3 * Q):                          # the ring wraps 3 times
        x = prev.float()[None] + 0.1 * torch.from_numpy(
            rng.randn(K, N).astype(np.float32))
        if t == Q + 1:
            x[K - 1, 5] = float("nan")              # a NaN client value
        stacked = x.to(dt)
        delayed = torch.from_numpy((rng.rand(K) < 0.5).astype(np.float32))
        if t % 4 == 2:
            delayed.fill_(1.0)                      # nobody on time
        delays = torch.from_numpy(
            rng.randint(1, max(Q - 1, 1) + 1, K).astype(np.int32))
        pop = t % Q
        qsum = qsum.clone()
        qsum[pop, :16] = -0.0                       # the popped slot: -0.0
        tq = torch.tensor([t, pop], dtype=torch.int32)
        args = (prev, stacked, qsum, qgamma, sizes, delayed, delays, tq, hyp)
        want = tref.server_async_math(*args)
        got = _async_vector_mirror(*args, slot_batch=4)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b)), t
        skipped = _async_vector_mirror(*args, skip_zero_terms=True)
        signed_zero_seen |= not torch.equal(_bits(skipped[1]), _bits(want[1]))
        prev, qsum, qgamma = want
    # skipping the zero terms would have kept a -0.0 the plain version
    # turns into +0.0 (Q > 1: a slot is never enqueued on the round it pops)
    assert signed_zero_seen or Q == 1
    assert torch.isnan(prev[5].float()) and torch.isfinite(prev[6].float())


def test_server_async_design_entry_is_bound():
    """The C entry that counts the async kernels' launches is declared
    to ctypes beside server_mix's."""
    from repro_torch.kernels import build
    assert "server_async_design_counts" in build.VOID_SIGNATURES
    src = (CSRC / "server_plane.cu").read_text()
    assert 'extern "C" void server_async_design_counts' in src
